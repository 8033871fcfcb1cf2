"""Asynchronous checkpointing and resume: the port of
``paddle_tpu/distributed/checkpoint.py``.

Reference analogue: auto_parallel dist ckpt, fleet.save_persistables and
auto_checkpoint (fluid/incubate/checkpoint/auto_checkpoint.py: epoch-range
resume). The JAX package saves through orbax where it is installed and
through ``paddle.save``'s pickle otherwise; the port has the pickle backend
only, with the JAX package's layout: one file per snapshot named by its
step, plus a ``LATEST`` pointer. A snapshot written by the JAX package on
that backend restores here, and the reverse.

What differs from the JAX package is the device side:

  - the boundary snapshot (``_device_snapshot``) is an on-device copy,
    enqueued on the current stream behind the step that just ran and before
    the next one: a captured training step (``jit.compile_train_step``)
    overwrites parameters and optimizer state in place on every replay, so
    the copy is the analogue of the JAX copy made before donation. Tensors
    of one device and dtype are copied into one flat buffer (one
    ``torch.cat``);
  - the persist moves that copy to the host on a stream of its own, after an
    event recorded behind the copy, into pinned buffers the checkpointer
    reuses from save to save; so the transfer never queues behind the
    replays that follow;
  - a restore copies into the existing tensors, never rebinding them: a
    captured graph keeps reading the storage it was captured over, and so
    do the optimizer's references.
"""
from __future__ import annotations

import math
import os
import pickle
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import profiler
from ..convert import _to_torch, source_for
from ..core import flags
from ..framework import io_utils

__all__ = [
    "save_state_dict",
    "load_state_dict",
    "persists_in_flight",
    "AsyncCheckpointer",
    "CadenceTuner",
    "CheckpointCadence",
    "TrainingState",
    "restore_training_state",
    "train_epoch_range",
    "train_step_range",
    "training_state",
]

_LATEST = "LATEST"

# process-wide count of persist phases currently running (sync or on a
# background thread): a step slowed by an overlapping persist is CheckFreq
# working, not a regression
_persists_active = 0
_persists_lock = threading.Lock()


def persists_in_flight() -> int:
    """Number of checkpoint persist phases currently running."""
    return _persists_active


def _ckpt_io(thunk):
    """Checkpoint IO through the resilience executor: injected faults fire
    here ('checkpoint' site) and transient IO errors retry with backoff."""
    from ..resilience import runtime as _rrt

    return _rrt.execute("checkpoint", thunk)


def _emit(kind: str, **attrs):
    profiler.trace.emit(kind, site="checkpoint", **attrs)


@torch.no_grad()
def _copy_into(name: str, dst: torch.Tensor, value):
    """Restore one entry IN PLACE: cast to ``dst``'s dtype and device."""
    dst.copy_(source_for(name, value, dst, True, "checkpoint restore"))


def _assign(state_dict, loaded):
    """Copy ``loaded``'s entries into ``state_dict``'s tensors in place; a
    host entry (the ``__data__`` iterator blob) is replaced."""
    for k, v in list(state_dict.items()):
        if k not in loaded:
            continue
        if isinstance(v, torch.Tensor):
            _copy_into(k, v, loaded[k])
        else:
            state_dict[k] = loaded[k]


# ---------------------------------------------------------------------------
# Snapshot phase (CheckFreq two-phase discipline, phase 1): an ON-DEVICE copy
# of every tensor at the step boundary, enqueued before the next step can
# overwrite the live buffers in place.
# ---------------------------------------------------------------------------
class _Snapshot:
    """The boundary copy: one flat tensor per (device, dtype), the entries'
    places in it, the host entries, and per CUDA device the events around
    the copy."""

    def __init__(self):
        self.flats: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}
        self.places: Dict[str, Tuple[Tuple[torch.device, torch.dtype], int, torch.Size]] = {}
        self.other: Dict[str, Any] = {}
        # per CUDA flat buffer: events recorded before and after its copy
        self.events: Dict[Tuple[torch.device, torch.dtype],
                          Tuple[torch.cuda.Event, torch.cuda.Event]] = {}
        self.nbytes = 0

    def device_ms(self) -> float:
        """Device time of the copies (CUDA events); 0 on the CPU."""
        return sum(a.elapsed_time(b) for a, b in self.events.values())


def _device_snapshot(state_dict: Dict[str, Any]) -> _Snapshot:
    """Boundary snapshot: bitwise the state at the moment of the call,
    immune to later in-place updates of the live tensors. Returns once the
    copies are done on the device, as the JAX package's snapshot blocks until
    ready: its time is what the step path pays."""
    if hasattr(state_dict, "refresh"):
        state_dict.refresh()  # TrainingState: re-read the optimizer moments
    snap = _Snapshot()
    groups: Dict[Tuple[torch.device, torch.dtype], List[str]] = {}
    for k, v in state_dict.items():
        if isinstance(v, torch.Tensor):
            groups.setdefault((v.device, v.dtype), []).append(k)
        elif isinstance(v, np.ndarray):
            snap.other[k] = v.copy()
        else:
            snap.other[k] = v
    for key, names in groups.items():
        events = None
        if key[0].type == "cuda":
            stream = torch.cuda.current_stream(key[0])
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        srcs = [state_dict[k] for k in names]
        offset = 0
        for k, t in zip(names, srcs):
            snap.places[k] = (key, offset, t.shape)
            offset += t.numel()
        # one cat of every tensor's flat view, its loop in C++: the Python
        # loop of views took several ms of the step path on ~1500 tensors
        with torch.no_grad():
            flat = snap.flats[key] = torch._utils._flatten_dense_tensors(srcs)
        snap.nbytes += flat.numel() * flat.element_size()
        if events is not None:
            events[1].record(stream)
            snap.events[key] = events
    for _, end in snap.events.values():
        end.synchronize()
    return snap


class _SaveJob:
    """One in-flight persist: the boundary snapshot plus completion state."""

    __slots__ = ("step", "snapshot", "tuner", "profiling", "done", "error",
                 "thread")

    def __init__(self, step: int, snapshot: _Snapshot, tuner=None,
                 profiling: bool = False):
        self.step = step
        self.snapshot = snapshot
        self.tuner = tuner
        self.profiling = profiling  # first save: costs are one-time, dropped
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None


def save_state_dict(state_dict: Dict[str, Any], path: str, async_save: bool = False):
    """Save ``state_dict`` to ``path`` with ``paddle.save``'s format.

    Crash-consistent: a temporary file and an atomic rename. Transient IO
    failures retry with backoff. The JAX package's orbax backend (and with
    it ``async_save``) is not in the port."""
    if hasattr(state_dict, "refresh"):
        state_dict.refresh()  # TrainingState: re-read the optimizer moments
    _ckpt_io(lambda: io_utils.save(state_dict, path))
    return None


def load_state_dict(state_dict: Dict[str, Any], path: str, mesh=None):
    """Restore IN PLACE into ``state_dict``'s tensors (each cast to its
    destination's dtype and device); a host entry is replaced."""
    _assign(state_dict, io_utils.load(path, return_numpy=True))
    return state_dict


class AsyncCheckpointer:
    """Async checkpoint manager with retention (keeps training stepping
    while the previous snapshot flushes).

    CheckFreq pipeline (FLAGS_ckpt_async, default on): ``save()`` pays only
    the on-device boundary snapshot on the step path; the device→host
    transfer, serialization and two-phase commit run on a background thread
    overlapping the following steps. The pipeline is single-slot: a new
    save first joins the previous in-flight persist (the stall, if any,
    counts as checkpoint overhead), so commits land in step order and the
    LATEST pointer never names a partially-persisted snapshot. Set
    ``tuner`` to a CadenceTuner to feed it measured snapshot/persist costs
    (``save_freq="auto"`` does this)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.tuner: Optional["CadenceTuner"] = None
        self._inflight: Optional[_SaveJob] = None
        self._last_error: Optional[BaseException] = None
        # serializes every commit (background persist, sync save, emergency
        # save): concurrent writers must never interleave payload renames
        # with LATEST pointer updates
        self._commit_lock = threading.Lock()
        # the transfer's stream and pinned host buffers, per (device, dtype):
        # one persist runs at a time, so the buffers are reused from save to
        # save
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._pinned: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}

    # -- crash-consistent commit protocol -----------------------------------
    # 1. payload → hidden temp file; 2. atomic rename to the numeric name;
    # 3. LATEST pointer updated last (atomic replace). A kill anywhere in
    # the sequence leaves either the previous complete snapshot (pointer
    # untouched) or the new complete one — never a corrupt "latest".
    def _write_latest(self, step: int):
        # commit order == step order: the single-slot pipeline joins the
        # previous persist first and every commit holds _commit_lock, so an
        # unconditional write never moves the pointer backwards within a run
        tmp = os.path.join(self.directory, f".{_LATEST}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(self.directory, _LATEST))

    def _read_latest(self) -> Optional[int]:
        try:
            with open(os.path.join(self.directory, _LATEST)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _retain(self):
        if self.max_to_keep and self.max_to_keep > 0:
            steps = sorted(
                int(d) for d in os.listdir(self.directory) if d.isdigit()
            )
            for old in steps[: -self.max_to_keep]:
                try:
                    os.remove(os.path.join(self.directory, str(old)))
                except OSError:
                    pass

    # -- persist phase (CheckFreq phase 2: transfer + serialize + commit) ---
    def _to_host(self, snap: _Snapshot) -> Dict[str, Any]:
        """The snapshot on the host, one numpy array per entry. A CUDA flat
        buffer goes to its pinned buffer on the checkpointer's own stream,
        which waits only for the snapshot's copy."""
        hosts = {}
        for key, flat in snap.flats.items():
            if key not in snap.events:
                hosts[key] = flat  # a CPU snapshot is on the host already
                continue
            stream = self._streams.get(key[0])
            if stream is None:
                stream = self._streams[key[0]] = torch.cuda.Stream(device=key[0])
            host = self._pinned.get(key)
            if host is None or host.numel() != flat.numel():
                host = self._pinned[key] = torch.empty(
                    flat.numel(), dtype=flat.dtype, pin_memory=True)
            stream.wait_event(snap.events[key][1])
            with torch.cuda.stream(stream):
                host.copy_(flat, non_blocking=True)
            flat.record_stream(stream)  # its memory is not reused before the copy ends
            hosts[key] = host
        for stream in self._streams.values():
            stream.synchronize()
        out = {}
        for k, (key, offset, shape) in snap.places.items():
            n = math.prod(shape)
            out[k] = io_utils.to_numpy(hosts[key][offset:offset + n].view(shape))
        out.update(snap.other)
        return out

    def _persist(self, job: _SaveJob):
        global _persists_active
        with _persists_lock:
            _persists_active += 1
        try:
            self._persist_inner(job)
        finally:
            with _persists_lock:
                _persists_active -= 1

    def _persist_inner(self, job: _SaveJob):
        try:
            t0 = time.perf_counter()
            host = self._to_host(job.snapshot)
            job.snapshot = None  # the device copy is free once on the host
            t1 = time.perf_counter()
            profiler.count_locked("ckpt_transfer_ms", (t1 - t0) * 1000.0)
            _emit("ckpt", phase="transfer", step=job.step,
                  ms=round((t1 - t0) * 1000.0, 3))
            from ..resilience import faults as _faults

            def _commit():
                final = os.path.join(self.directory, str(job.step))
                tmp = os.path.join(self.directory, f".snap.{job.step}.{os.getpid()}")
                with self._commit_lock:
                    io_utils.save(host, tmp)
                    # chaos harness kill point: snapshot bytes written but
                    # not yet committed — a kill here must leave the
                    # previous LATEST intact
                    _faults.maybe_kill("checkpoint")
                    os.replace(tmp, final)
                    self._retain()
                    self._write_latest(job.step)

            _ckpt_io(_commit)
            t2 = time.perf_counter()
            profiler.count_locked("ckpt_commit_ms", (t2 - t1) * 1000.0)
            _emit("ckpt", phase="commit", step=job.step,
                  ms=round((t2 - t1) * 1000.0, 3))
            if job.tuner is not None:
                job.tuner.observe_persist((t2 - t0) * 1000.0,
                                          profiling=job.profiling)
        except BaseException as e:  # re-raised at the next join/wait
            job.error = e
        finally:
            job.done.set()

    def _join_inflight(self, reraise: bool = True,
                       count_stall: bool = True) -> float:
        """Wait out the in-flight persist; returns the stall in ms. A
        persist error surfaces here (or is parked on ``last_error`` when
        the caller cannot raise, e.g. restore). ``count_stall=False`` for
        drains that are not on the step path (wait/restore)."""
        job = self._inflight
        if job is None:
            return 0.0
        t0 = time.perf_counter()
        job.done.wait()
        if job.thread is not None:
            job.thread.join()
        self._inflight = None
        stall_ms = (time.perf_counter() - t0) * 1000.0
        if count_stall:
            profiler.count_locked("ckpt_pipeline_stall_ms", stall_ms)
            if stall_ms >= 1.0:  # a real wait, not clock noise
                _emit("ckpt", phase="stall", step=job.step,
                      ms=round(stall_ms, 3))
        if job.error is not None:
            self._last_error = job.error
            if reraise:
                raise job.error
        return stall_ms

    @property
    def last_error(self) -> Optional[BaseException]:
        return self._last_error

    def save(self, step: int, state_dict: Dict[str, Any],
             blocking: Optional[bool] = None):
        """Two-phase save: on-device boundary snapshot (step path), then
        persist — in the background when FLAGS_ckpt_async is on and
        ``blocking`` isn't forced, synchronously otherwise."""
        if blocking is None:
            blocking = not bool(flags.flag("ckpt_async"))
        stall_ms = self._join_inflight()  # single-slot pipeline
        t0 = time.perf_counter()
        snapshot = _device_snapshot(state_dict)
        snap_ms = (time.perf_counter() - t0) * 1000.0
        profiler.count_locked("ckpt_snapshots", 1)
        profiler.count_locked("ckpt_snapshot_ms", snap_ms)
        _emit("ckpt", phase="snapshot", step=step, ms=round(snap_ms, 3),
              device_ms=round(snapshot.device_ms(), 3), bytes=snapshot.nbytes,
              blocking=bool(blocking))
        tuner = self.tuner
        profiling = tuner is not None and not tuner._profiled
        if tuner is not None:
            # the step path paid the snapshot plus any pipeline stall
            tuner.observe_snapshot(snap_ms, stall_ms)
        job = _SaveJob(step, snapshot, tuner, profiling=profiling)
        if blocking:
            profiler.count_locked("ckpt_sync_saves", 1)
            self._persist(job)
            if job.error is not None:
                self._last_error = job.error
                raise job.error
        else:
            profiler.count_locked("ckpt_async_saves", 1)
            job.thread = threading.Thread(
                target=self._persist, args=(job,), daemon=True,
                name=f"ckpt-persist-{step}",
            )
            self._inflight = job
            job.thread.start()

    def emergency_save(self, step: int, state_dict: Dict[str, Any]):
        """Preemption-path save: join an in-flight persist that already
        covers this boundary instead of redoing it; supersede anything else
        with a synchronous save. Commits stay serialized either way."""
        job = self._inflight
        if job is not None and job.step == step:
            try:
                self._join_inflight()
                profiler.count_locked("ckpt_emergency_joined_inflight", 1)
                return
            except Exception:
                pass  # persist failed — fall through to the sync save
        # a stale failure from an EARLIER step's persist must not abort the
        # emergency snapshot — the process is about to exit and this save
        # is the last chance at durability; drain without re-raising
        self._join_inflight(reraise=False, count_stall=False)
        self.save(step, state_dict, blocking=True)

    def restore_latest(self, state_dict: Dict[str, Any]) -> Optional[int]:
        """Load the newest loadable snapshot into ``state_dict`` in place
        and return its step (None when there is none): the LATEST pointer
        first, then newer to older, skipping any file that fails to load."""
        # an in-flight persist may still be writing the newest snapshot;
        # join it first (its failure must not fail the restore)
        self._join_inflight(reraise=False, count_stall=False)
        if hasattr(state_dict, "refresh"):
            # TrainingState: create missing optimizer accumulators so the
            # saved moment entries have tensors to land in
            state_dict.refresh(create=True)
        steps = sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())
        if not steps:
            return None
        pointed = self._read_latest()
        candidates = sorted(steps, reverse=True)
        if pointed in steps:
            candidates = [pointed] + [s for s in candidates if s != pointed]
        for step in candidates:
            try:
                loaded = io_utils.load(os.path.join(self.directory, str(step)),
                                       return_numpy=True)
            except Exception:
                continue  # partial/corrupt snapshot — try the previous one
            _assign(state_dict, loaded)
            return step
        return None

    def wait(self):
        """Block until every issued save is durably committed; re-raises a
        background persist failure."""
        self._join_inflight(count_stall=False)


# ---------------------------------------------------------------------------
# CheckFreq auto-tuned cadence: pick save_freq so measured checkpoint
# overhead stays under the FLAGS_ckpt_overhead_pct budget.
#
# Only the snapshot (plus any pipeline stall) runs on the step path, so per
# checkpoint the training loop pays `snapshot_ms`; amortized over
# `save_freq` steps of `step_ms` each, overhead = snapshot_ms /
# (save_freq * step_ms). Solving for the budget:
#
#     save_freq >= snapshot_ms / (budget_frac * step_ms)
#
# A second constraint keeps the pipeline stall-free: the background persist
# of one snapshot must finish before the next save joins it, i.e.
# save_freq >= persist_ms / step_ms. The tuner takes the max of both,
# clamped to [1, FLAGS_ckpt_cadence_max], and re-tunes when the step-time
# EMA drifts more than FLAGS_ckpt_retune_pct from its value at the last
# tune. Both constraints carry noise headroom: _BUDGET_HEADROOM tunes to 80%
# of the budget; _PIPELINE_HEADROOM schedules saves 1.25x the persist/step
# ratio apart.
# ---------------------------------------------------------------------------
_BUDGET_HEADROOM = 0.8
_PIPELINE_HEADROOM = 1.25


class CadenceTuner:
    """Measures steady-state step time + checkpoint costs and auto-tunes
    the save frequency against an overhead budget (CheckFreq, FAST '21)."""

    def __init__(self, overhead_pct: Optional[float] = None,
                 warmup_steps: int = 3, ema_alpha: float = 0.25):
        self.overhead_pct = (
            float(overhead_pct) if overhead_pct is not None
            else float(flags.flag("ckpt_overhead_pct"))
        )
        self.warmup_steps = int(warmup_steps)
        # ema_alpha governs the per-step time EMA; the sparser snapshot /
        # persist cost EMAs use a fixed 0.5 per-save weight
        self.timer = profiler.StepTimer(alpha=ema_alpha)
        self.snapshot_ms: Optional[float] = None  # EMA of step-path cost
        self.persist_ms: Optional[float] = None   # EMA of background persist
        self.save_freq: Optional[int] = None
        self.retunes = 0
        self._since_save = 0
        self._overhead_ms = 0.0
        self._profiled = False  # first save = CheckFreq's profiling phase
        self._lock = threading.Lock()  # persist times arrive off-thread

    # -- observations -------------------------------------------------------
    def observe_step(self, dt_s: float):
        with self._lock:
            self.timer.observe(dt_s)
            if (self.save_freq is not None and self.timer.drift_pct()
                    > float(flags.flag("ckpt_retune_pct"))):
                self._retune(drift=True)

    def observe_snapshot(self, snap_ms: float, stall_ms: float = 0.0):
        """Step-path cost of one save. ``snap_ms`` feeds the cadence
        arithmetic; the pipeline stall only counts as realized overhead.
        The first save is the profiling measurement (one-time costs:
        allocations, pinning the host buffers) and is dropped; the second
        seeds the steady-state costs. EMA weight 0.5 per save."""
        with self._lock:
            if not self._profiled:
                self._profiled = True  # profiling save: costs discarded
                return
            self._overhead_ms += snap_ms + stall_ms
            self.snapshot_ms = (
                snap_ms if self.snapshot_ms is None
                else self.snapshot_ms + 0.5 * (snap_ms - self.snapshot_ms)
            )
            self._retune()

    def observe_persist(self, ms: float, profiling: bool = False):
        """Background transfer+serialize+commit duration (off-thread).
        ``profiling=True`` marks the first save's persist — discarded like
        its snapshot."""
        if profiling:
            return
        with self._lock:
            self.persist_ms = (
                ms if self.persist_ms is None
                else self.persist_ms + 0.5 * (ms - self.persist_ms)
            )
            self._retune()

    # -- policy -------------------------------------------------------------
    def _retune(self, drift: bool = False):
        step_ms = self.timer.ema_ms
        # both costs must be measured before a frequency exists: tuning
        # from the snapshot alone would schedule the next save before the
        # (unknown, possibly much longer) persist can drain
        if not step_ms or self.snapshot_ms is None or self.persist_ms is None:
            return
        budget_frac = max(self.overhead_pct, 1e-6) / 100.0 * _BUDGET_HEADROOM
        freq = math.ceil(self.snapshot_ms / (budget_frac * step_ms))
        if self.persist_ms:
            freq = max(freq, math.ceil(
                self.persist_ms * _PIPELINE_HEADROOM / step_ms))
        freq = max(1, min(freq, int(flags.flag("ckpt_cadence_max"))))
        # `retunes` counts step-time-drift re-tunes, not routine cost-EMA
        # refinement; _retune also runs on the persist thread, so the
        # counter writes take the locked path
        if drift and freq != self.save_freq:
            self.retunes += 1
            profiler.count_locked("ckpt_cadence_retunes", 1)
        self.save_freq = freq
        self.timer.mark()
        profiler.gauge_locked("ckpt_auto_save_freq", freq)

    def should_save(self) -> bool:
        """Call once per step boundary (after observe_step)."""
        with self._lock:
            self._since_save += 1
            if self.save_freq is None:
                # bootstrap: one early save measures snapshot/persist cost
                if self.timer.count >= self.warmup_steps:
                    self._since_save = 0
                    return True
                return False
            if self._since_save >= self.save_freq:
                self._since_save = 0
                return True
            return False

    def measured_overhead_pct(self) -> float:
        """Realized step-path checkpoint overhead vs total compute."""
        with self._lock:
            if not self.timer.total_ms:
                return 0.0
            return self._overhead_ms / self.timer.total_ms * 100.0

    def state(self) -> Dict[str, Any]:
        return {
            "budget_pct": self.overhead_pct,
            "step_time_ms": round(self.timer.ema_ms or 0.0, 3),
            "snapshot_ms": round(self.snapshot_ms or 0.0, 3),
            "persist_ms": round(self.persist_ms or 0.0, 3),
            "save_freq": self.save_freq,
            "retunes": self.retunes,
            "measured_overhead_pct": round(self.measured_overhead_pct(), 3),
        }


class CheckpointCadence:
    """Boundary-save policy shared by train_step_range / train_epoch_range:
    a fixed integer ``save_freq`` (0 = never), or ``"auto"`` for CheckFreq
    cadence tuning under the FLAGS_ckpt_overhead_pct budget."""

    def __init__(self, checkpointer, state_dict,
                 save_freq: Union[int, str, None]):
        self.checkpointer = checkpointer
        self.state_dict = state_dict
        self.enabled = checkpointer is not None and state_dict is not None
        self.tuner: Optional[CadenceTuner] = None
        if isinstance(save_freq, str):
            if save_freq != "auto":
                raise ValueError(
                    f"save_freq must be an int or 'auto', got {save_freq!r}"
                )
            self.save_freq: Union[int, str] = "auto"
            if self.enabled:
                self.tuner = CadenceTuner()
                checkpointer.tuner = self.tuner
        else:
            self.save_freq = int(save_freq or 0)

    def boundary(self, index: int, dt_s: float) -> bool:
        """Step/epoch-boundary tick: feeds the tuner and fires the save
        when the cadence says so. Returns True when a save was issued."""
        if not self.enabled:
            return False
        if self.tuner is not None:
            self.tuner.observe_step(dt_s)
            if not self.tuner.should_save():
                return False
            inflight = getattr(self.checkpointer, "_inflight", None)
            if (self.tuner.save_freq is None and inflight is not None
                    and not inflight.done.is_set()):
                # bootstrap: the profiling save's persist is still flushing;
                # the seeding save waits for an idle pipeline (its costs
                # must be steady-state ones)
                return False
        elif not (self.save_freq and (index + 1) % self.save_freq == 0):
            return False
        self.checkpointer.save(index, self.state_dict)
        return True


def _train_range(count: int, checkpointer, state_dict, save_freq,
                 guard, optimizer, data=None):
    """Shared restore → yield → boundary-check → cadenced-save protocol
    behind train_epoch_range / train_step_range."""
    if (data is not None and hasattr(state_dict, "refresh")
            and getattr(state_dict, "_data", None) is None):
        # late-attach the data iterator so its state rides every snapshot
        state_dict._data = data
        state_dict.refresh()
    cadence = CheckpointCadence(checkpointer, state_dict, save_freq)
    start = 0
    if checkpointer is not None and state_dict is not None:
        restored = checkpointer.restore_latest(state_dict)
        if restored is not None:
            restore_training_state(state_dict, optimizer=optimizer, data=data)
            start = restored + 1
    if guard is not None:
        guard.bind(checkpointer, state_dict)
        guard.install()
    try:
        for i in range(start, count):
            t0 = time.perf_counter()
            yield i
            dt = time.perf_counter() - t0
            if guard is not None:
                guard.step_boundary(i)  # raises Preempted after a signal
            cadence.boundary(i, dt)
        if checkpointer is not None:
            checkpointer.wait()  # normal path: surface persist failures
    finally:
        if guard is not None:
            guard.uninstall()
        # the loop is over: no more step heartbeats will arrive, which the
        # stall watchdog cannot tell from a stall; stand the TRAIN source
        # down (a co-resident serving engine's heartbeat stays armed)
        profiler.trace.watchdog_disarm("train")
        if checkpointer is not None:
            # break/exception path: the last async save still runs on a
            # daemon thread — drain it so the commit lands before the
            # consumer moves on (a persist error must not mask the
            # propagating exception / GeneratorExit)
            try:
                checkpointer.wait()
            except Exception:
                pass


def train_epoch_range(max_epoch_num: int, checkpointer: Optional[AsyncCheckpointer] = None,
                      state_dict: Optional[Dict] = None,
                      save_freq: Union[int, str] = 1,
                      guard=None, optimizer=None, data=None):
    """reference: auto_checkpoint.py:598 train_epoch_range — a generator
    wrapping the epoch loop that restores the last epoch on (re)start and
    snapshots at each epoch end.

    With a ``resilience.PreemptionGuard`` as ``guard``, a SIGTERM/SIGINT
    during an epoch finishes that epoch, emergency-saves it and raises
    ``Preempted``. With a ``training_state`` view (or ``optimizer``), the
    optimizer's accumulators are restored too. ``data=`` (an object with
    state_dict/load_state_dict) checkpoints the data iterator alongside.
    For step-granular resume use train_step_range."""
    return _train_range(max_epoch_num, checkpointer, state_dict, save_freq,
                        guard, optimizer, data=data)


def train_step_range(max_steps: int, checkpointer: Optional[AsyncCheckpointer] = None,
                     state_dict: Optional[Dict] = None,
                     save_freq: Union[int, str] = 0,
                     guard=None, optimizer=None, data=None):
    """Step-granular, preemption-safe resume loop.

    Restores the latest snapshot on (re)start and yields the remaining step
    indices. With a ``PreemptionGuard``, a SIGTERM/SIGINT arriving during a
    step lets that step FINISH, then emergency-saves it and raises
    ``Preempted``: a relaunch resumes at the next step. ``save_freq`` saves
    every that many steps (the crash backstop); ``"auto"`` tunes it
    (CheckFreq) under FLAGS_ckpt_overhead_pct. ``optimizer`` restores its
    accumulators from the snapshot (see ``training_state``) and ``data=``
    checkpoints the data-iterator state with them."""
    return _train_range(max_steps, checkpointer, state_dict, save_freq,
                        guard, optimizer, data=data)


_OPT_PREFIX = "__opt__."
_DATA_KEY = "__data__.blob"
# fixed-size blob, the JAX package's: its orbax restore templates are built
# from the current entry shapes, so the serialized iterator state keeps one
# shape across save and restore — length-prefixed pickle in a zero-padded
# buffer
_DATA_BLOB_BYTES = 8192


def _pack_data_state(doc: Dict[str, Any]) -> np.ndarray:
    payload = pickle.dumps(doc, protocol=2)
    if len(payload) + 8 > _DATA_BLOB_BYTES:
        raise ValueError(
            f"data-iterator state is {len(payload)} bytes — does not fit "
            f"the {_DATA_BLOB_BYTES}-byte checkpoint blob (keep sampler "
            "state to epoch/cursor/RNG scalars, not data)")
    buf = np.zeros(_DATA_BLOB_BYTES, dtype=np.uint8)
    buf[:8] = np.frombuffer(struct.pack("<q", len(payload)), dtype=np.uint8)
    buf[8:8 + len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return buf


def _unpack_data_state(arr) -> Optional[Dict[str, Any]]:
    raw = np.asarray(arr, dtype=np.uint8).tobytes()
    (n,) = struct.unpack("<q", raw[:8])
    if n <= 0:
        return None  # empty blob: the snapshot came from a data-less run
    return pickle.loads(raw[8:8 + n])


class TrainingState(dict):
    """Live flat checkpoint view over model params + optimizer accumulators.

    Model entries are the LIVE parameter tensors and optimizer entries the
    LIVE accumulator tensors, ``__opt__.{i}.{key}`` for the i-th parameter
    of the optimizer's list (by index, not name: a relaunch's fresh model
    gets other ``param_<n>`` names). A restore writes into them in place.
    ``refresh()`` re-reads the view (the save and restore paths call it;
    ``create=True`` makes missing accumulators so a restore has tensors to
    land in). ``data`` adds the data-iterator state as a fixed-size
    ``__data__.blob`` entry: any object with ``state_dict()`` /
    ``load_state_dict()``. The GradScaler, the LR scheduler and the RNG
    state are not part of it, as in the JAX package: ``paddle.save`` them
    (``GradScaler.state_dict``, ``Optimizer.state_dict``'s
    ``LR_Scheduler``, ``get_rng_state``)."""

    def __init__(self, model, optimizer=None, data=None):
        super().__init__()
        self._model = model
        self._optimizer = optimizer
        self._data = data
        self.refresh()

    def refresh(self, create: bool = False):
        self.clear()
        self.update(self._model.state_dict())
        opt = self._optimizer
        if opt is not None:
            opt._state_sync()  # a parked moment comes back before the snapshot
            for i, p in enumerate(opt._param_list()):
                st = opt._state_of(p) if create else opt._accumulators.get(id(p))
                for k, v in (st or {}).items():
                    self[f"{_OPT_PREFIX}{i}.{k}"] = v
        if self._data is not None and hasattr(self._data, "state_dict"):
            self[_DATA_KEY] = _pack_data_state(self._data.state_dict())
        else:
            # stable snapshot structure: data-less states carry an EMPTY
            # (all-zeros) blob, as the JAX package's do
            self[_DATA_KEY] = np.zeros(_DATA_BLOB_BYTES, dtype=np.uint8)
        return self


def training_state(model, optimizer=None, data=None) -> TrainingState:
    """Checkpointable state covering model params, optimizer accumulators
    AND (with ``data=``) the data-iterator state, for AsyncCheckpointer /
    save_state_dict / the train_step_range resume loop."""
    return TrainingState(model, optimizer, data=data)


def restore_training_state(state: Dict[str, Any], optimizer=None, data=None):
    """Push the optimizer slice of a restored ``training_state`` into the
    optimizer's accumulators and the ``__data__.blob`` iterator state into
    the sampler/loader. An accumulator that exists is written in place (a
    captured step keeps reading it); a live ``TrainingState`` view already
    holds the optimizer's own tensors, which the restore filled."""
    if optimizer is None:
        optimizer = getattr(state, "_optimizer", None)
    if optimizer is not None:
        for i, p in enumerate(optimizer._param_list()):
            prefix = f"{_OPT_PREFIX}{i}."
            entries = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            if not entries:
                continue
            cur = optimizer._state_of(p)
            for k, v in entries.items():
                if cur.get(k) is v:
                    continue
                if k in cur:
                    _copy_into(prefix + k, cur[k], v)
                else:
                    t = v if isinstance(v, torch.Tensor) else _to_torch(np.asarray(v))
                    cur[k] = t.to(p.device).clone()
    if data is None:
        data = getattr(state, "_data", None)
    if data is not None and _DATA_KEY in state and hasattr(data, "load_state_dict"):
        blob = state[_DATA_KEY]
        if isinstance(blob, torch.Tensor):
            blob = blob.numpy()
        doc = _unpack_data_state(blob)
        if doc is not None:
            data.load_state_dict(doc)
