"""``DataLoader`` of the port (``paddle_tpu/io/dataloader.py``; reference:
python/paddle/fluid/reader.py:146 and dataloader_iter.py:146/:338).

``num_workers > 0`` forks worker PROCESSES with task and result queues, the
reference's _DataLoaderIterMultiProcess: CPU-heavy transforms run outside
the trainer's GIL, arrays of 64 KiB and more ride
``multiprocessing.shared_memory`` blocks instead of pickled pipe bytes
(``use_shared_memory``), batches come back in sampler order (or in
completion order with ``in_order=False``), a worker's exception or crash
reaches the parent with its traceback, and ``persistent_workers`` keeps the
pool across epochs. ``use_thread_workers=True`` uses threads instead.

Workers ship numpy. A forked worker must not touch torch's CUDA state,
which the parent may have initialised, nor make a Tensor (``to_tensor``
puts it on the card), so the worker-side collate is numpy-only
(``_np_collate``) and only the parent wraps batches as Tensors, on the
current device, unless ``return_numpy=True`` leaves the upload to the
training step. ``bucket_spec`` pads ragged fields to a ``BucketSpec``'s
boundaries during collate.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import queue
import threading
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from ..core import dispatch
from ..core import random as _random
from ..core.tensor import Tensor, to_tensor
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

_worker_info = threading.local()

# arrays at least this large ride shared memory instead of the pickle pipe
_SHM_MIN_BYTES = 1 << 16


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


def get_worker_info():
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch):
    """reference: dataloader/collate.py default_collate_fn."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        from ..tensor_api import stack

        return stack(batch, axis=0)
    if isinstance(sample, torch.Tensor):
        return dispatch.wrap(torch.stack(batch, dim=0))
    if isinstance(sample, np.ndarray):
        return to_tensor(np.stack(batch, axis=0))
    if isinstance(sample, (int, np.integer)):
        return to_tensor(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return to_tensor(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    raise TypeError(f"cannot collate {type(sample)}")


def default_convert_fn(batch):
    return batch


# ---------------------------------------------------------------------------
# multiprocess transport: Tensor-free trees over queues, big arrays via shm
# ---------------------------------------------------------------------------
def _tree_to_ipc(obj, shm_blocks, use_shm):
    """Tensors/arrays → IPC-safe descriptors; big arrays → shared memory."""
    if isinstance(obj, Tensor):
        obj = obj.numpy()
    elif isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        if use_shm and obj.nbytes >= _SHM_MIN_BYTES:
            from multiprocessing import resource_tracker, shared_memory

            shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
            # ownership transfers to the parent (which unlinks after copy);
            # deregister from THIS process's tracker or it double-unlinks
            # at worker exit and warns about the missing segment
            try:
                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:
                pass
            dst = np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)
            dst[...] = obj
            shm_blocks.append(shm)
            return ("shm", shm.name, obj.shape, str(obj.dtype))
        return ("arr", obj)
    if isinstance(obj, dict):
        return ("dict", {k: _tree_to_ipc(v, shm_blocks, use_shm) for k, v in obj.items()})
    if isinstance(obj, (tuple, list)):
        return ("seq", type(obj) is tuple,
                [_tree_to_ipc(v, shm_blocks, use_shm) for v in obj])
    return ("raw", obj)


def _discard_payload(desc):
    """Unlink shared-memory blocks of a payload that will never be
    consumed (abandoned iterator / shutdown drain) — without this the
    /dev/shm segments outlive the process."""
    kind = desc[0]
    if kind == "shm":
        from multiprocessing import shared_memory

        try:
            shm = shared_memory.SharedMemory(name=desc[1])
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass
    elif kind == "dict":
        for v in desc[1].values():
            _discard_payload(v)
    elif kind == "seq":
        for v in desc[2]:
            _discard_payload(v)


def _tree_from_ipc(desc, as_tensor=True):
    kind = desc[0]
    if kind == "shm":
        from multiprocessing import shared_memory

        _, name, shape, dtype = desc
        shm = shared_memory.SharedMemory(name=name)
        try:
            arr = np.array(np.ndarray(shape, dtype, buffer=shm.buf))  # copy out
        finally:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        return to_tensor(arr) if as_tensor else arr
    if kind == "arr":
        return to_tensor(desc[1]) if as_tensor else desc[1]
    if kind == "dict":
        return {k: _tree_from_ipc(v, as_tensor) for k, v in desc[1].items()}
    if kind == "seq":
        vals = [_tree_from_ipc(v, as_tensor) for v in desc[2]]
        return tuple(vals) if desc[1] else vals
    return desc[1]


def _np_collate(batch):
    """default_collate_fn's numpy twin: forked workers must never touch
    torch's CUDA state nor make a Tensor, so worker-side collation stacks
    numpy and the parent wraps Tensors."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([t.detach().cpu().numpy() for t in batch], axis=0)
    if isinstance(sample, np.ndarray):
        return np.stack(batch, axis=0)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: _np_collate([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [_np_collate(list(items)) for items in zip(*batch)]
    raise TypeError(f"cannot collate {type(sample)}")


def _mp_worker_main(wid, num_workers, dataset, collate_np, worker_init_fn,
                    task_q, result_q, use_shm, base_seed):
    """Worker process body (reference: fluid/dataloader/worker.py
    _worker_loop): pull index batches, fetch (+collate when the default
    collate is in use), ship results. collate_np=None ships raw sample
    trees and the parent runs the user's custom collate_fn."""
    seed = base_seed + wid  # fork copies the parent RNG state — reseed per
    np.random.seed(seed % (2**32))  # worker or augmentations duplicate
    _worker_info.info = WorkerInfo(wid, num_workers, dataset, seed)
    if worker_init_fn is not None:
        worker_init_fn(wid)
    while True:
        task = task_q.get()
        if task is None:
            return
        seq, indices = task
        shm_blocks = []
        try:
            samples = [dataset[i] for i in indices]
            if collate_np is not None:
                payload = _tree_to_ipc(collate_np(samples), shm_blocks, use_shm)
                result_q.put((seq, "ok", payload))
            else:
                payload = _tree_to_ipc(list(samples), shm_blocks, use_shm)
                result_q.put((seq, "samples", payload))
        except Exception as e:
            result_q.put((seq, "err",
                          f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
        finally:
            for shm in shm_blocks:
                shm.close()  # parent copies then unlinks


def _mp_worker_iterable(wid, num_workers, dataset, collate_np, worker_init_fn,
                        batch_size, drop_last, result_q, use_shm, base_seed):
    """IterableDataset worker: iterates ITS shard (the dataset uses
    get_worker_info to split) and ships whole batches, completion-ordered."""
    seed = base_seed + wid
    np.random.seed(seed % (2**32))
    _worker_info.info = WorkerInfo(wid, num_workers, dataset, seed)
    if worker_init_fn is not None:
        worker_init_fn(wid)

    def ship(batch):
        shm_blocks = []
        try:
            if collate_np is not None:
                result_q.put(
                    (-1, "ok", _tree_to_ipc(collate_np(batch), shm_blocks, use_shm))
                )
            else:
                result_q.put(
                    (-1, "samples", _tree_to_ipc(list(batch), shm_blocks, use_shm))
                )
        finally:
            for shm in shm_blocks:
                shm.close()

    try:
        batch = []
        for sample in dataset:
            batch.append(sample)
            if len(batch) == batch_size:
                ship(batch)
                batch = []
        if batch and not drop_last:
            ship(batch)
        result_q.put((-1, "done", wid))
    except Exception as e:
        result_q.put((-1, "err",
                      f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


class DataLoader:
    """reference: fluid/reader.py DataLoader."""

    def __init__(
        self,
        dataset: Dataset,
        feed_list=None,
        places=None,
        return_list=True,
        batch_sampler=None,
        batch_size=1,
        shuffle=False,
        drop_last=False,
        collate_fn: Optional[Callable] = None,
        num_workers=0,
        use_buffer_reader=True,
        prefetch_factor=2,
        use_shared_memory=True,
        timeout=0,
        worker_init_fn=None,
        persistent_workers=False,
        use_thread_workers=False,
        in_order=True,
        worker_collate_fn=None,
        return_numpy=False,
        bucket_spec=None,
    ):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        # shape-bucketing policy (io.bucketing.BucketSpec): ragged sample
        # fields are padded to bucket boundaries during collate so the
        # number of distinct batch shapes a compiled consumer sees stays
        # bounded (each distinct shape is one captured program)
        self.bucket_spec = bucket_spec
        if bucket_spec is not None:
            if (getattr(bucket_spec, "pad_batch_to", None) is not None
                    and int(num_workers) > 0 and not use_thread_workers):
                # process workers pad on a forked COPY of the spec: the
                # parent's real_batch_size() would silently report None
                # and padded repeat-rows would count as real samples
                raise ValueError(
                    "BucketSpec.pad_batch_to requires num_workers=0 or "
                    "use_thread_workers=True (the real-batch-size map "
                    "cannot cross a process fork)"
                )
            base = self.collate_fn

            def bucketed_collate(samples, _base=base, _spec=bucket_spec):
                return _spec.collate(samples, _base)

            self.collate_fn = bucketed_collate
            self._bucket_base_collate = base
        else:
            self._bucket_base_collate = None
        self.num_workers = int(num_workers)
        self.prefetch_factor = prefetch_factor
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = bool(use_shared_memory)
        self.timeout = float(timeout) if timeout else 0.0
        self.persistent_workers = bool(persistent_workers)
        # thread pool opt-in (GIL-releasing datasets); processes otherwise
        self.use_thread_workers = bool(use_thread_workers)
        # in_order=False yields batches in completion order (lower latency
        # under skewed per-batch cost; batch order becomes nondeterministic)
        self.in_order = bool(in_order)
        # worker_collate_fn: numpy-only collate executed INSIDE worker
        # processes (must not touch torch's CUDA state nor make Tensors);
        # the default collate's numpy twin runs there when unset.
        # return_numpy=True skips the parent-side Tensor wrap (callers that
        # feed a compiled step can upload arrays themselves).
        self.worker_collate_fn = worker_collate_fn
        self.return_numpy = bool(return_numpy)
        self._pool = None  # persistent multiprocess pool state
        # live-iteration consumption tracking (see state_dict): sampler
        # state at iteration start + batches the caller has consumed since
        self._live_start = None
        self._live_consumed = 0
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size, drop_last=drop_last
            )

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    # -- resumable-iterator state (paddle.distributed.checkpoint) ----------
    def state_dict(self):
        """Sampler epoch/cursor + the host sampling stream — what
        ``training_state(..., data=loader)`` packs next to params so a
        resumed run continues the data stream mid-epoch instead of
        re-reading it from the top (each sample consumed exactly once).

        The cursor reflects batches the CALLER has consumed, not how far
        the prefetchers have advanced the sampler — with num_workers>0 the
        sampler runs up to num_workers*prefetch_factor batches ahead, and
        checkpointing that inflated cursor would skip never-trained
        samples on resume."""
        doc = {"rng": _random.host_stream_state()}
        sampler = getattr(self, "batch_sampler", None)
        if sampler is not None and hasattr(sampler, "state_dict"):
            if self._live_start is not None:
                s = dict(self._live_start)
                s["cursor"] = int(s.get("cursor", 0)) + self._live_consumed
            else:
                s = sampler.state_dict()
            doc["sampler"] = s
        return doc

    def load_state_dict(self, state):
        if "rng" in state:
            _random.set_host_stream_state(state["rng"])
        sampler = getattr(self, "batch_sampler", None)
        if (sampler is not None and "sampler" in state
                and hasattr(sampler, "load_state_dict")):
            sampler.load_state_dict(state["sampler"])
        self._live_start = None
        self._live_consumed = 0

    def _tracked(self, gen):
        """Count batches handed to the caller so state_dict can report a
        consumption cursor even while prefetchers run the sampler ahead.
        The snapshot is taken before the first pull (nothing has advanced
        yet); normal exhaustion hands authority back to the sampler (whose
        epoch-end state — cursor reset — is then correct)."""
        sampler = self.batch_sampler
        if self._live_start is not None and hasattr(sampler,
                                                    "load_state_dict"):
            # the previous iteration was ABANDONED mid-epoch: rewind the
            # sampler's prefetch overshoot to the consumption point, else
            # the never-delivered prefetched batches are skipped forever.
            # Rewind only a pure overshoot — if anything else moved
            # (set_epoch, an explicit cursor seek), the caller's state wins
            want = dict(self._live_start)
            want["cursor"] = int(want.get("cursor", 0)) + self._live_consumed
            cur = sampler.state_dict()
            cur_c = int(cur.get("cursor", 0))
            # an epoch-scoped sampler (has an "epoch" field) resets its
            # cursor to 0 when the PREFETCHER drains the whole epoch —
            # with the epoch unchanged that 0 is overshoot too, not a
            # caller reset (GlobalStepSampler's global cursor never
            # wraps, so 0 there means an explicit seek and wins). A
            # caller who consumed EVERY batch before breaking gets the
            # reset state as-is — rewinding to the full count would make
            # the next epoch iterate empty
            try:
                total = len(sampler)
            except TypeError:
                total = None
            wrapped = ("epoch" in cur and cur_c == 0
                       and 0 < int(want["cursor"])
                       and (total is None or int(want["cursor"]) < total))
            if ({k: v for k, v in cur.items() if k != "cursor"}
                    == {k: v for k, v in want.items() if k != "cursor"}
                    and (cur_c > int(want["cursor"]) or wrapped)):
                sampler.load_state_dict(want)
        self._live_start = sampler.state_dict()
        self._live_consumed = 0
        for batch in gen:
            # count BEFORE the yield: the generator only resumes at the
            # next pull, and a batch handed to the caller is consumed
            self._live_consumed += 1
            yield batch
        self._live_start = None
        self._live_consumed = 0

    def __iter__(self):
        if self._iterable_mode:
            if self.num_workers > 0 and not self.use_thread_workers:
                return self._iter_iterable_multiprocess()
            return self._iter_iterable()
        if self.num_workers == 0:
            it = self._iter_single()
        elif self.use_thread_workers:
            it = self._iter_threaded()
        else:
            it = self._iter_multiprocess()
        if hasattr(self.batch_sampler, "state_dict"):
            it = self._tracked(it)
        return it

    def _fetch(self, indices):
        samples = [self.dataset[i] for i in indices]
        return self.collate_fn(samples)

    def _iter_single(self):
        for indices in self.batch_sampler:
            yield self._fetch(indices)

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    # -- multiprocess path (reference: _DataLoaderIterMultiProcess) ---------
    def _worker_collate(self):
        """Worker-side collate: explicit worker_collate_fn, else the numpy
        twin of the default, else None for custom collate_fn (which runs in
        the parent on worker-fetched samples)."""
        if self.worker_collate_fn is not None:
            return self.worker_collate_fn
        if self.bucket_spec is not None:
            if self._bucket_base_collate is default_collate_fn:
                # numpy-pure bucket collate runs in the worker; the
                # parent re-observes shapes when wrapping Tensors
                spec = self.bucket_spec

                def worker_bucketed(samples, _spec=spec):
                    return _spec.collate(samples, _np_collate)

                return worker_bucketed
            return None
        return _np_collate if self.collate_fn is default_collate_fn else None

    def _start_pool(self):
        if self._pool is not None:
            return self._pool
        ctx = mp.get_context("fork")
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        seed = int(np.random.randint(0, 2**31 - 1))
        procs = [
            ctx.Process(
                target=_mp_worker_main,
                args=(wid, self.num_workers, self.dataset,
                      self._worker_collate(), self.worker_init_fn,
                      task_q, result_q, self.use_shared_memory, seed),
                daemon=True,
            )
            for wid in range(self.num_workers)
        ]
        for p in procs:
            p.start()
        self._pool = (procs, task_q, result_q, itertools.count())
        return self._pool

    def _stop_pool(self):
        if self._pool is None:
            return
        procs, task_q, result_q, _ = self._pool
        for _ in procs:
            task_q.put(None)
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
        # unlink shm of any results nobody consumed
        while True:
            try:
                _, status, payload = result_q.get_nowait()
            except (queue.Empty, OSError):
                break
            if status in ("ok", "samples"):
                _discard_payload(payload)
        self._pool = None

    def _drain_outstanding(self, order, result_q, procs):
        """Consume (and discard) results for every still-outstanding seq so
        an abandoned iterator neither leaks /dev/shm segments nor poisons
        the shared queues for the next epoch (persistent_workers)."""
        deadline = 10.0
        import time as _time

        t0 = _time.monotonic()
        while order and _time.monotonic() - t0 < deadline:
            try:
                seq, status, payload = result_q.get(timeout=1.0)
            except queue.Empty:
                if all(not p.is_alive() for p in procs):
                    break
                continue
            if status in ("ok", "samples"):
                _discard_payload(payload)
            try:
                order.remove(seq)
            except ValueError:
                pass

    def _get_result(self, result_q, procs, done_ok=False):
        """Next worker result. done_ok: workers may legitimately have
        exited (iterable shards finishing early) — only a NONZERO exit
        code counts as a crash."""
        timeout = self.timeout or 5.0
        while True:
            try:
                return result_q.get(timeout=timeout)
            except queue.Empty:
                crashed = [
                    p for p in procs
                    if not p.is_alive() and p.exitcode not in (0, None)
                ]
                if crashed:
                    raise RuntimeError(
                        f"DataLoader worker (pid {crashed[0].pid}) exited "
                        f"unexpectedly with code {crashed[0].exitcode}"
                    ) from None
                if not done_ok and all(not p.is_alive() for p in procs):
                    raise RuntimeError(
                        "all DataLoader workers exited while batches were "
                        "still expected"
                    ) from None
                if self.timeout:
                    raise RuntimeError(
                        f"DataLoader timed out after {self.timeout}s waiting "
                        "for a worker batch"
                    ) from None

    def _finish_batch(self, status, payload):
        if status == "err":
            raise RuntimeError(f"DataLoader worker raised:\n{payload}")
        if status == "samples":
            batch = self.collate_fn(_tree_from_ipc(payload, as_tensor=False))
        else:
            batch = _tree_from_ipc(payload, as_tensor=not self.return_numpy)
            if self.bucket_spec is not None:
                # worker-side padding ran on a forked COPY of the spec —
                # re-observe emitted shapes here so seen_shapes/the
                # recompile-budget warning track the parent's reality
                self.bucket_spec._record_shapes(batch)
        return batch

    def _iter_multiprocess(self):
        from collections import deque

        procs, task_q, result_q, seq_counter = self._start_pool()
        n_prefetch = max(1, self.num_workers * self.prefetch_factor)
        sampler_iter = iter(self.batch_sampler)
        pending = {}  # seq -> (status, payload) awaiting in-order yield
        order = deque()  # submitted seqs in sampler order
        try:
            exhausted = False
            while True:
                while not exhausted and len(order) < n_prefetch:
                    try:
                        indices = next(sampler_iter)
                    except StopIteration:
                        exhausted = True
                        break
                    seq = next(seq_counter)
                    order.append(seq)
                    task_q.put((seq, list(indices)))
                if exhausted and not order:
                    return
                if self.in_order:
                    target = order[0]
                    while target not in pending:
                        seq, status, payload = self._get_result(result_q, procs)
                        pending[seq] = (status, payload)
                    status, payload = pending.pop(target)
                    order.popleft()
                else:
                    seq, status, payload = self._get_result(result_q, procs)
                    order.remove(seq)
                yield self._finish_batch(status, payload)
        finally:
            # account for every submitted batch: an abandoned iterator must
            # not leak shm segments or poison queues for the next epoch
            for status, payload in pending.values():
                if status in ("ok", "samples"):
                    _discard_payload(payload)
            for seq in list(pending):
                pending.pop(seq)
                try:
                    order.remove(seq)
                except ValueError:
                    pass
            self._drain_outstanding(order, result_q, procs)
            if not self.persistent_workers:
                self._stop_pool()

    def _iter_iterable_multiprocess(self):
        ctx = mp.get_context("fork")
        result_q = ctx.Queue()
        seed = int(np.random.randint(0, 2**31 - 1))
        procs = [
            ctx.Process(
                target=_mp_worker_iterable,
                args=(wid, self.num_workers, self.dataset,
                      self._worker_collate(), self.worker_init_fn,
                      self.batch_size, self.drop_last, result_q,
                      self.use_shared_memory, seed),
                daemon=True,
            )
            for wid in range(self.num_workers)
        ]
        for p in procs:
            p.start()
        done = 0
        try:
            while done < len(procs):
                _, status, payload = self._get_result(
                    result_q, procs, done_ok=True
                )
                if status == "done":
                    done += 1
                    continue
                yield self._finish_batch(status, payload)
        finally:
            # drain anything unconsumed (early break) before joining
            while True:
                try:
                    _, status, payload = result_q.get_nowait()
                except (queue.Empty, OSError):
                    break
                if status in ("ok", "samples"):
                    _discard_payload(payload)
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()

    def __del__(self):
        try:
            self._stop_pool()
        except Exception:
            pass

    def _iter_threaded(self):
        """Prefetching pipeline: worker threads fetch+collate index batches,
        results are yielded in order (numpy/dataset work releases the GIL
        enough in practice; the reference uses processes because its samples
        are C++ LoDTensors)."""
        sampler_iter = iter(self.batch_sampler)
        n_prefetch = max(1, self.num_workers * self.prefetch_factor)
        results = {}
        lock = threading.Lock()
        cond = threading.Condition(lock)
        task_q: "queue.Queue" = queue.Queue()
        stop = threading.Event()

        for wid in range(self.num_workers):
            if self.worker_init_fn:
                self.worker_init_fn(wid)

        def worker():
            while not stop.is_set():
                try:
                    seq, indices = task_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    out = self._fetch(indices)
                except Exception as e:  # propagate to consumer
                    out = e
                with cond:
                    results[seq] = out
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        try:
            seq_submit = 0
            seq_yield = 0
            exhausted = False
            while True:
                while not exhausted and seq_submit - seq_yield < n_prefetch:
                    try:
                        indices = next(sampler_iter)
                    except StopIteration:
                        exhausted = True
                        break
                    task_q.put((seq_submit, indices))
                    seq_submit += 1
                if exhausted and seq_yield == seq_submit:
                    return
                with cond:
                    while seq_yield not in results:
                        cond.wait(timeout=1.0)
                    out = results.pop(seq_yield)
                seq_yield += 1
                if isinstance(out, Exception):
                    raise out
                yield out
        finally:
            stop.set()
