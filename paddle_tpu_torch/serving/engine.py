"""The serving engine: continuous batching over a paged KV cache, with each
prefill and decode signature captured as one CUDA graph. The port of
``paddle_tpu/serving/engine.py``.

One ``Engine`` owns one model and runs a simple synchronous loop:

    admit (queue → blocks → prefill)  →  decode every active group once
    →  recycle completed sequences' blocks  →  repeat

Every program launch goes through three execution rungs
(``core/lazy.py``), the serving instance of the resilience ladder, each
under ``resilience.runtime.execute`` (fault injection, retry with backoff,
ladder accounting):

  captured   one CUDA graph per bucket signature, replayed over the pool
             tensors it writes in place (on a CPU tensor: the function,
             eagerly, in place); skipped while the ladder has the bucket
             demoted;
  retained   the same function on copies of the pool tensors, copied back
             on success — the retry-safe middle rung;
  eager      the same function, called directly — the floor, run once
             under the ``op`` site.

All three run the SAME function over the same values, so numerics never
change across rungs — a mid-decode fault demotes the bucket's program and
the batch retries without dropping a request. Injected faults
(FLAGS_fault_inject) raise before the program runs, so the lower rungs
reuse the intact pool; a REAL fault on the captured rung may have left the
pool half-written: the engine zeroes the pool in place and re-enqueues
every in-flight sequence (greedy decode is deterministic, so re-runs
reproduce the same tokens).

The JAX floor runs the step op by op, each op its own resilience site
(``op``); the port has no per-op dispatcher, so its floor is one ``op``
site around the whole eager step.

Overload robustness wraps that loop in three layers:

  deadlines   every request may carry ``deadline_ms``; expiry is enforced
              in queue (before wasting a prefill), at the admit pop, and
              mid-decode (partial 'timeout' response per
              FLAGS_serving_deadline_partial) — expired sequences recycle
              their blocks and leave the decode group without perturbing
              other rows;
  admission   the SLO-aware controller (serving/admission.py) predicts a
              request's completion from measured prefill/decode cost EMAs
              and sheds predicted deadline misses, over-cap submits
              (FLAGS_serving_queue_max), and — batch class first — storm
              arrivals past the queue-wait p99 trip wire, always with a
              structured retriable 'overloaded' response;
  health      the engine exposes warming/ready/degraded/draining/dead
              (``Engine.health``) so a Supervisor (serving/supervisor.py)
              and the inference PredictorPool can route traffic around an
              unhealthy replica, restart a wedged engine, or fail cleanly.

Every request phase, health transition and restart is a ``serve`` event in
the flight recorder (``profiler.trace``). The ops plane: an engine
registers with the diagnostics server (``profiler.diag``: /healthz and
/readyz aggregate its health), feeds the perf sentinel its decode steps
(``serve_decode[<uid>:<BxN>]``, the step's CUDA event pair on the card) and
queue waits (``serve_queue_wait[<uid>]``), and feeds the attribution
registry its bucket programs (``serve:<kind>:<uid>:<bucket>:<blocks>``);
``close()`` retires all of them.

With ``num_blocks`` 0 and FLAGS_serving_num_blocks 0 the memory planner
sizes the pool (``analysis.memory.plan_block_pool``): the decode program
recorded once on a minimal pool gives the overhead, and the pool takes
``(budget - overhead) // block_bytes`` blocks of ``memory_budget_mb``, else
FLAGS_memory_budget_mb, else the card's free memory and the model's resident
weights less a quarter of the card (``analysis.memory.DETECTED_HEADROOM``,
kept for the buckets' graph pools, prefill and what the process allocates
later); a budget below the overhead raises ("memory budget
leaves no room"). Such a pool also refuses a request whose context exceeds
the geometry the planner recorded. On the CPU, with no budget, the pool
takes the 256-block default.
"""
from __future__ import annotations

import itertools
import signal as _signal
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from .. import profiler
from ..core import flags
from ..core.dtype import to_torch_dtype
from ..profiler import trace as _trace
from ..resilience import faults as _faults
from ..resilience import runtime as _rt
from .admission import AdmissionController
from .cache import BlockPool, PagedCacheView, _BatchState, default_num_blocks
from .scheduler import (
    Request,
    RequestQueue,
    Response,
    Sequence,
    ServingBuckets,
    group_for_decode,
)

__all__ = ["Engine", "HEALTH_STATES", "ServingConfig", "StepTiming"]

_ENGINE_IDS = itertools.count(1)

# the engine health lifecycle (Engine.health). 'degraded' still serves —
# it marks a replica a router should deprioritize (pool rebuild) until
# _DEGRADED_COOLDOWN_TICKS clean ticks pass; 'dead' and 'draining' refuse
# new admissions.
HEALTH_STATES = ("warming", "ready", "degraded", "draining", "dead")
_DEGRADED_COOLDOWN_TICKS = 8
# steps kept in Engine.step_timings(): a bounded window, so a long-running
# engine holds fixed memory
_TIMING_WINDOW = 1 << 14


def _decode_pick(logits):
    """Greedy next token from a decode chunk's last position."""
    row = logits[:, -1, :]
    return row, torch.argmax(row, dim=-1)


def _prefill_pick(logits, plen):
    """Greedy next token from the TRUE last prompt position (the prompt is
    padded to its bucket; positions >= plen are pad lanes). ``plen`` stays
    on the device."""
    idx = (plen - 1)[:, None, None].expand(-1, 1, logits.shape[-1])
    row = torch.gather(logits, 1, idx)[:, 0]
    return row, torch.argmax(row, dim=-1)


def _sentinel():
    from ..profiler import sentinel

    return sentinel.default_sentinel()


def _feed(rows) -> torch.Tensor:
    """Host int64 tensor of one step's feed (tables, lengths, token ids)."""
    return torch.from_numpy(np.asarray(rows, np.int64))


class _PoolsConsumed(RuntimeError):
    """A REAL (non-injected) fault escaped the captured rung: the graph may
    have written part of the pool before failing. Recovery zeroes the pool
    and requeues."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


@dataclass(frozen=True)
class StepTiming:
    """One prefill or decode step on the host clock: the port's counterpart
    of the JAX engine's per-step ``serve`` trace event (``Engine.step_timings``).

    ``feed_ms`` builds the step's feed on the host; ``launch_ms`` stages it
    (one host-to-device copy) and launches the program; ``wait_ms`` waits
    for the device and reads the next tokens back. ``device_ms`` is the
    device time from the feed's copy to the program's end (CUDA events;
    None on the CPU). ``end`` is ``time.perf_counter()`` when the tokens
    reached the host. ``request_ids`` are the rows that got a token, in row
    order; ``batch`` is the padded rows the program ran and ``blocks`` its
    context blocks. ``rung`` is the rung that completed the step:
    ``captured``, ``retained`` or ``eager``."""

    kind: str
    request_ids: Tuple[int, ...]
    batch: int
    blocks: int
    end: float
    feed_ms: float
    launch_ms: float
    wait_ms: float
    device_ms: Optional[float]
    rung: str


@dataclass
class ServingConfig:
    """Engine knobs. ``None``/0 fields fall back to their FLAGS_serving_*
    defaults (see ``core.flags.describe_flags('serving')``)."""

    block_size: int = 0
    num_blocks: int = 0              # 0 = FLAGS_serving_num_blocks, else the planner
    memory_budget_mb: Optional[float] = None  # the planner's budget (None: the flag)
    prompt_buckets: Optional[List[int]] = None
    decode_batch_buckets: Optional[List[int]] = None
    max_new_tokens: int = 0          # default per-request cap
    keep_logits: bool = False        # responses carry per-token logits rows
    dtype: str = "float32"
    # model geometry — inferred from model.cfg when present
    layers: Optional[int] = None
    heads: Optional[int] = None
    head_dim: Optional[int] = None
    max_positions: Optional[int] = None


class Engine:
    """Continuous-batching serving runtime over one generative model.

    ``model`` must accept ``model(ids, caches=views, pos_offset=tensor)``
    with a list of per-layer cache views and return ``[b, s, vocab]``
    logits — ``models.gpt.GPTForPretraining`` is the flagship shape. The
    engine runs on the model's device: the card unless the model was built
    on the CPU.
    """

    def __init__(self, model, config: Optional[ServingConfig] = None):
        cfg = config or ServingConfig()
        self._uid = next(_ENGINE_IDS)
        self._model = model
        if hasattr(model, "eval"):
            model.eval()
        mcfg = getattr(model, "cfg", None)
        self._layers = cfg.layers or getattr(mcfg, "num_layers", None)
        heads = cfg.heads or getattr(mcfg, "num_heads", None)
        head_dim = cfg.head_dim
        if head_dim is None and mcfg is not None:
            head_dim = mcfg.hidden_size // mcfg.num_heads
        if not (self._layers and heads and head_dim):
            raise ValueError(
                "cannot infer model geometry; pass ServingConfig(layers=, "
                "heads=, head_dim=)"
            )
        self._max_positions = (
            cfg.max_positions or getattr(mcfg, "max_seq_len", None) or 1 << 30
        )
        self._block_size = int(cfg.block_size) or int(
            flags.flag("serving_block_size"))
        self._default_max_new = int(cfg.max_new_tokens) or int(
            flags.flag("serving_max_new_tokens"))
        self._keep_logits = bool(cfg.keep_logits)
        self._buckets = ServingBuckets(
            block_size=self._block_size,
            prompt_buckets=cfg.prompt_buckets,
            decode_batch_buckets=cfg.decode_batch_buckets,
        )

        self._decode_fn = self._make_decode_fn()
        self._prefill_fn = self._make_prefill_fn()

        # -- block-pool sizing: explicit > FLAGS_serving_num_blocks > the
        # memory planner (budget argument, FLAGS_memory_budget_mb, else the
        # card's memory) > the 256-block default -----------------------------
        device = next(model.parameters()).device
        scratch = self._buckets.max_decode_batch
        self._pool_plan = None
        # a planner-sized pool also bounds a request's context by the geometry
        # the planner recorded: the budget covers nothing larger
        self._plan_ctx_blocks: Optional[int] = None
        num_blocks = int(cfg.num_blocks) or int(flags.flag("serving_num_blocks"))
        if num_blocks <= 0:
            self._pool_plan = self._plan_pool(
                heads=int(heads), head_dim=int(head_dim), dtype=cfg.dtype, scratch=scratch,
                budget_mb=cfg.memory_budget_mb, device=device)
            if self._pool_plan.num_blocks is None:
                num_blocks = default_num_blocks()
                self._plan_ctx_blocks = None  # no budget: nothing to bound
            else:
                num_blocks = int(self._pool_plan.num_blocks)
                if num_blocks < 1:
                    raise ValueError(
                        "memory budget leaves no room for a KV block pool: decode-program "
                        f"overhead is ~{self._pool_plan.overhead_bytes / 2**20:.1f} MB of a "
                        f"{self._pool_plan.budget_bytes / 2**20:.1f} MB budget "
                        "(FLAGS_memory_budget_mb)")
        self._pool = BlockPool(
            layers=self._layers, heads=int(heads), head_dim=int(head_dim),
            block_size=self._block_size, num_blocks=num_blocks,
            scratch_slots=scratch, dtype=cfg.dtype, device=device,
        )
        self._timings: deque = deque(maxlen=_TIMING_WINDOW)
        # two events reused by every step: read right after the step's
        # tokens, when both have completed
        self._events = (
            (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            if device.type == "cuda" else None)

        self._queue = RequestQueue()
        self._active: List[Sequence] = []
        self._responses: Dict[int, Response] = {}
        # ids accepted into the queue but not yet answered — the drop
        # tripwire run_until_idle audits (every accepted request must end
        # with exactly one Response; anything else is a counted drop)
        self._accepted: set = set()
        self._draining = False
        # the drain BARRIER: the ids the preemption-drain contract covers
        # (snapshot at begin_drain). A concurrent Supervisor restart may
        # requeue in-flight work only from inside the barrier; anything
        # else lands as a terminal response, never re-admitted past it
        self._drain_barrier: Optional[set] = None
        self._prev_handlers: Dict[int, Any] = {}
        # streaming log-bucketed histogram (profiler.metrics): O(1) observe,
        # fixed memory, lifetime coverage. Registered in the default
        # registry, labeled by engine uid; close() unregisters.
        self._token_lat = profiler.metrics.default_registry().histogram(
            "serve_token_lat_ms",
            doc="per-token serving latency (first token incl. prefill, "
                "then one sample per decoded token), ms",
            labels={"engine": str(self._uid)},
        )
        # lifetime per-engine outcome counts (responses themselves are
        # evicted by serve()/pop_response, so stats can't scan them)
        self._n_completed = 0
        self._n_rejected = 0
        self._n_errors = 0
        self._n_shed = 0
        self._n_expired = 0
        # SLO-aware admission: measured prefill/decode cost EMAs + the
        # queue-wait trip wire (serving/admission.py)
        self._admission = AdmissionController(
            self._uid, bucket_of=self._buckets.prompt_bucket)
        # health lifecycle: warming until the first successful tick;
        # degraded after a restart/pool rebuild until a cooldown of clean
        # ticks; draining/dead refuse new admissions
        self._health = "warming"
        self._tick_no = 0
        self._degraded_until: Optional[int] = None
        self._restarts = 0
        self._last_restart_error: Optional[str] = None
        # the rung that completed the last step (StepTiming.rung)
        self._rung = "captured"
        # attribution keys seen: a key's first step builds its program and
        # is not a measured run
        self._noted = set()
        # the diagnostics server aggregates every live engine's health into
        # /healthz and /readyz (weakly referenced; close() unregisters)
        from ..profiler import diag as _diag

        _diag.register_engine(self)

    # ------------------------------------------------------------------
    # step functions (shared by all three execution rungs)
    # ------------------------------------------------------------------
    def _make_decode_fn(self) -> Callable:
        model, layers, bs = self._model, self._layers, self._block_size

        def decode_fn(k_pools, v_pools, tables, lens, tokens):
            st = _BatchState(k_pools, v_pools, tables, lens, prefill=False)
            views = [PagedCacheView(st, i, bs) for i in range(layers)]
            with torch.no_grad():
                logits = model(tokens[:, None], caches=views, pos_offset=lens)
            row, nxt = _decode_pick(logits)
            return tuple(st.k_pools), tuple(st.v_pools), row, nxt

        return decode_fn

    def _plan_pool(self, *, heads, head_dim, dtype, scratch, budget_mb, device):
        """The planner's pool (``analysis.memory.plan_block_pool``): the decode
        program at the largest batch and context the buckets allow,
        recorded once on a MINIMAL pool (the scratch slots and one block,
        which every block table names), so its overhead (weights,
        activations, the gathered block views, the tables) is measured
        without the pool, and the budget is split between it and the pool."""
        from .. import analysis
        from ..analysis import memory as _mem

        self._plan_args = dict(heads=heads, head_dim=head_dim, dtype=dtype, scratch=scratch,
                               device=device)
        args, pool_bytes, block_bytes = self._plan_inputs(**self._plan_args)
        self._plan_ctx_blocks = int(args[2].shape[1])

        def record():
            with analysis.recording("serving-decode") as rec:
                self._decode_fn(*args)
            return rec.program

        return _mem.plan_block_pool(record, block_bytes=block_bytes,
                                    pool_bytes_in_trace=pool_bytes, budget_mb=budget_mb)

    def _plan_inputs(self, *, heads, head_dim, dtype, scratch, device):
        """The decode program's inputs at the planner's geometry: the largest
        decode batch, block tables of the largest bucket's context that all
        name the one block of a minimal pool, lengths at the longest
        context. Returns ``((k, v, tables, lens, tokens), minimal pool
        bytes, bytes of one block)``."""
        B = self._buckets.max_decode_batch
        nblk = self._buckets.ctx_blocks(
            self._buckets.prompt_spec.boundaries[-1], self._default_max_new)
        tdt = to_torch_dtype(dtype)
        shape = (scratch + 1, self._block_size, heads, head_dim)
        k = tuple(torch.zeros(shape, dtype=tdt, device=device) for _ in range(self._layers))
        v = tuple(torch.zeros(shape, dtype=tdt, device=device) for _ in range(self._layers))
        tables = torch.full((B, nblk), scratch, dtype=torch.int64, device=device)
        # the longest context the tables hold: a gather sized by the lengths
        # is at its largest
        longest = min(nblk * self._block_size, int(self._max_positions)) - 1
        lens = torch.full((B,), longest, dtype=torch.int64, device=device)
        tokens = torch.zeros(B, dtype=torch.int64, device=device)
        pool_bytes = 2 * self._layers * k[0].numel() * k[0].element_size()
        block_bytes = 2 * self._layers * self._block_size * heads * head_dim * k[0].element_size()
        return (k, v, tables, lens, tokens), pool_bytes, block_bytes

    def _make_prefill_fn(self) -> Callable:
        model, layers, bs = self._model, self._layers, self._block_size

        def prefill_fn(k_pools, v_pools, tables, ids, plen):
            lens = torch.zeros(ids.shape[0], dtype=torch.int64, device=ids.device)
            st = _BatchState(k_pools, v_pools, tables, lens, prefill=True)
            views = [PagedCacheView(st, i, bs) for i in range(layers)]
            with torch.no_grad():
                logits = model(ids, caches=views, pos_offset=0)
            row, nxt = _prefill_pick(logits, plen)
            return tuple(st.k_pools), tuple(st.v_pools), row, nxt

        return prefill_fn

    # ------------------------------------------------------------------
    # health lifecycle
    # ------------------------------------------------------------------
    @property
    def health(self) -> str:
        """One of :data:`HEALTH_STATES` — what a router routes on."""
        return self._health

    def serviceable(self) -> bool:
        """May this engine accept NEW work right now?"""
        return self._health not in ("draining", "dead")

    def _set_health(self, state: str, why: str):
        if state == self._health:
            return
        if state not in HEALTH_STATES:
            raise ValueError(f"unknown health state {state!r}")
        prev, self._health = self._health, state
        profiler.count("serve_health_transitions")
        _trace.emit("serve", site="engine", phase="health", engine=self._uid,
                    prev=prev, state=state, why=why[:120])

    @staticmethod
    def _now() -> float:
        """Deadline clock (wall seconds). A method so tests can drive
        expiry with a virtual clock instead of sleeps."""
        return time.time()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               priority: str = "interactive") -> int:
        """Queue one request; returns its request id. Requests that can
        NEVER be served (context exceeds the pool or the model's positions)
        are rejected immediately with a Response — admission refusal, not
        an out-of-memory. ``deadline_ms`` (default
        FLAGS_serving_default_deadline_ms; 0/None = none) and ``priority``
        ('interactive' > 'batch') feed the SLO-aware admission controller:
        a submit the engine predicts it cannot serve in time — or one
        arriving past FLAGS_serving_queue_max / the queue-wait p99 trip
        wire — is shed with a structured retriable 'overloaded' response
        instead of queueing toward a timeout."""
        if deadline_ms is None:
            default_dl = float(flags.flag("serving_default_deadline_ms"))
            deadline_ms = default_dl if default_dl > 0 else None
        req = Request(
            prompt=np.asarray(prompt),
            max_new_tokens=max_new_tokens or self._default_max_new,
            eos_token_id=eos_token_id,
            deadline_ms=deadline_ms,
            priority=priority,
        )
        if self._health == "dead":
            self._reject(req, "engine is dead (closed, or supervisor "
                              "restarts exhausted)")
            return req.request_id
        if self._draining:
            self._reject(req, "engine is draining (preemption)")
            return req.request_id
        plen = int(req.prompt.size)
        ctx = (self._buckets.prompt_bucket(plen) + req.max_new_tokens)
        if ctx > self._max_positions:
            self._reject(
                req,
                f"context {ctx} exceeds the model's max positions "
                f"{self._max_positions}",
            )
            return req.request_id
        n_blk = self._buckets.ctx_blocks(plen, req.max_new_tokens)
        cap = self._pool.num_blocks
        if self._plan_ctx_blocks is not None:
            cap = min(cap, self._plan_ctx_blocks)
        if n_blk > cap:
            profiler.count("serve_admission_refusals")
            self._reject(
                req,
                f"KV cache overflow: request needs {n_blk} blocks > "
                f"admissible context {cap} (FLAGS_serving_num_blocks)",
            )
            return req.request_id
        shed = self._admission.decide(
            req, queue=self._queue, active=self._active, now=self._now())
        if shed is not None:
            self._shed(req, shed)
            return req.request_id
        self._queue.push(req)
        self._accepted.add(req.request_id)
        _trace.emit("serve", site="engine", phase="admit", rid=req.request_id,
                    prompt_len=plen, blocks=n_blk, priority=req.priority)
        return req.request_id

    def response(self, request_id: int) -> Optional[Response]:
        return self._responses.get(request_id)

    def pop_response(self, request_id: int) -> Optional[Response]:
        """``response()`` + evict — long-running callers retrieve results
        with this so the response map doesn't grow with total traffic.
        The id leaves the drop-audit set too: a retrieved response IS the
        answered contract."""
        r = self._responses.pop(request_id, None)
        if r is not None:
            self._accepted.discard(request_id)
        return r

    def step(self):
        """One scheduler tick: expire what already missed its deadline,
        admit + prefill what fits, then one decode step for every active
        group."""
        self._tick_no += 1
        self._expire_deadlines(stage="queued")
        self._admit()
        groups = group_for_decode(self._active)
        for n_blk in sorted(groups):
            seqs = groups[n_blk]
            cap = self._buckets.max_decode_batch
            for i in range(0, len(seqs), cap):
                # pool recovery (_recover_pools) tears down EVERY active
                # sequence mid-tick: drop stale snapshot entries and, if a
                # batch reports the pool was rebuilt, abort this tick —
                # the requeued sequences re-prefill on the next one
                chunk = [s for s in seqs[i:i + cap] if s in self._active]
                if chunk and not self._decode_batch(chunk, n_blk):
                    self._end_tick()
                    return
        self._end_tick()

    def _end_tick(self):
        # a per-ENGINE heartbeat source: one engine going idle must not
        # erase a still-wedged sibling's stall signal
        _rt.on_step_end(source=f"serve[{self._uid}]")
        if self._health == "warming":
            self._set_health("ready", "first tick completed")
        elif (self._health == "degraded"
              and self._degraded_until is not None
              and self._tick_no >= self._degraded_until):
            self._degraded_until = None
            self._set_health("ready", "degraded cooldown elapsed")

    def _expire_deadlines(self, stage: str):
        """Answer every queued/active request whose deadline has passed.
        Queued expiry runs BEFORE admission so a dead-on-arrival request
        never wastes a prefill; active expiry removes the sequence from
        its decode group (the group is recomputed each tick, so the other
        rows are untouched) and recycles its blocks."""
        now = self._now()
        for req in self._queue.take_expired(now):
            self._expire(req, stage=stage)
        for seq in [s for s in self._active if s.req.expired(now)]:
            self._release(seq)
            self._expire(seq.req, stage="decode", seq=seq)

    def run_until_idle(self):
        """Drive the loop until every accepted request has a response."""
        while self._queue or self._active:
            self.step()
        self._audit_drops()
        # an IDLE engine looks exactly like a stalled one to the stall
        # watchdog: stand THIS engine's heartbeat down (the next tick
        # re-arms it)
        _trace.watchdog_disarm(f"serve[{self._uid}]")

    def _audit_drops(self):
        """The zero-drop tripwire: at idle, every accepted request must
        have produced exactly one Response, and — the pool-leak half —
        every KV block must be back on the free-list. Anything missing is
        counted (serve_requests_dropped / serve_block_leaks), answered with
        an error response so no caller ever hangs on a lost id, and leaked
        blocks are reclaimed so the pool doesn't starve admission
        forever."""
        missing = self._accepted - set(self._responses)
        for rid in missing:
            profiler.count("serve_requests_dropped")
            self._responses[rid] = Response(
                request_id=rid, status="error",
                error="request lost by the engine (dropped) — engine bug",
                done_time=time.time(),
            )
        self._accepted.clear()
        if not self._active and self._pool.used_blocks:
            leaked = self._pool.reclaim_all()
            profiler.count("serve_block_leaks", leaked)
            _trace.emit("serve", site="engine", phase="block_leak",
                        engine=self._uid, blocks=leaked)

    def serve(self, requests: Seq, **submit_kw) -> List[Response]:
        """Convenience: submit every prompt, run to completion, return (and
        evict) the responses in submit order."""
        ids = [self.submit(p, **submit_kw) for p in requests]
        self.run_until_idle()
        return [self.pop_response(i) for i in ids]

    # -- supervision -----------------------------------------------------
    def restart(self, err: BaseException):
        """Tear the runtime down to a known-good state after a wedge or a
        tick exception escaped the resilience ladder: evict this engine's
        captured programs (a wedged graph must not be replayed; the next
        tick captures them again), requeue every in-flight sequence through
        the requeue path without burning its retries (greedy decode ⇒ the
        re-run reproduces the same tokens), and zero the pool in place. The
        engine comes back 'degraded' until a cooldown of clean ticks. The
        Supervisor owns the restart BUDGET
        (FLAGS_serving_max_engine_restarts) and calls :meth:`fail_clean`
        past it."""
        from ..core.lazy import reset_serve_programs

        self._restarts += 1
        self._last_restart_error = f"{type(err).__name__}: {err}"
        profiler.count("serve_engine_restarts")
        _trace.emit("serve", site="engine", phase="restart", engine=self._uid,
                    restarts=self._restarts, error=type(err).__name__)
        reset_serve_programs(owner=self._uid)
        for seq in list(self._active):
            if (self._draining and self._drain_barrier is not None
                    and seq.req.request_id not in self._drain_barrier):
                # a restart racing a preemption drain: work that landed
                # AFTER the barrier snapshot must not be re-admitted past
                # it; it answers a terminal retriable response instead,
                # never re-enters a draining engine's queue
                self._release(seq)
                self._n_shed += 1
                profiler.count("serve_requests_shed")
                self._responses[seq.req.request_id] = Response(
                    request_id=seq.req.request_id, status="overloaded",
                    error=("engine restarted while draining: request was "
                           "outside the drain barrier — retry on a peer"),
                    retriable=True,
                    prompt_len=int(seq.req.prompt.size),
                    submit_time=seq.req.submit_time, done_time=time.time(),
                    retry_after_ms=self._admission.retry_after_ms(),
                )
                _trace.emit("serve", site="engine", phase="drain_barrier_refusal",
                            rid=seq.req.request_id, engine=self._uid)
                continue
            self._requeue_seq(seq, err, count_retry=False)
        self._pool.reset_storage()
        self._mark_degraded(f"engine restart: {type(err).__name__}")

    def fail_clean(self, err: BaseException, why: Optional[str] = None):
        """The restart budget is exhausted (or, with ``why`` saying so, the
        engine cannot be restarted): answer EVERY queued and in-flight
        request with a terminal error response (zero hangs, zero silent
        drops), release their blocks, go 'dead' (submits from here on are
        rejected) and dump an ``engine_dead`` postmortem. Host work only:
        it runs on a lost CUDA context too."""
        if why is None:
            why = (f"engine dead after {self._restarts} restarts "
                   f"(FLAGS_serving_max_engine_restarts): {err}")
        for seq in list(self._active):
            self._release(seq)
            self._error(seq.req, why, seq)
        while True:
            req = self._queue.pop()
            if req is None:
                break
            self._error(req, why)
        self._set_health("dead", why)
        _trace.dump_postmortem("engine_dead", exc=err, engine=self._uid,
                               restarts=self._restarts)

    @property
    def pending(self) -> int:
        """Accepted-but-unanswered work (queued + in flight)."""
        return len(self._queue) + len(self._active)

    # -- preemption ------------------------------------------------------
    def begin_drain(self):
        """Stop admitting NEW requests; everything already submitted still
        completes (the SIGTERM drain contract — zero dropped requests)."""
        if not self._draining:
            self._draining = True
            # snapshot the drain BARRIER: exactly the accepted-but-
            # unanswered ids the drain contract covers
            self._drain_barrier = set(self._accepted) - set(self._responses)
            profiler.count("serve_preempt_drains")
            if self._health != "dead":
                self._set_health("draining", "preemption drain")

    def install_preemption_handler(self, signals=(_signal.SIGTERM,)):
        """Make each of ``signals`` call :meth:`begin_drain`. Call from the
        main thread (``signal.signal`` works only there)."""
        for s in signals:
            if s in self._prev_handlers:
                continue  # already installed — keep the ORIGINAL previous
            self._prev_handlers[s] = _signal.signal(
                s, lambda signum, frame: self.begin_drain())

    def uninstall_preemption_handler(self):
        for s, h in self._prev_handlers.items():
            _signal.signal(s, h)
        self._prev_handlers.clear()

    def drain(self) -> List[Response]:
        """begin_drain + run to idle; returns every retained response."""
        self.begin_drain()
        self.run_until_idle()
        return list(self._responses.values())

    def close(self):
        """Release this engine's captured programs (their step functions
        hold the model and their graphs hold device memory), unregister its
        latency histograms, restore any signal handlers and stand its
        heartbeat down. Safe to call twice."""
        from ..core.lazy import reset_serve_programs

        from ..profiler import attribution as _attribution
        from ..profiler import diag as _diag
        from ..profiler import sentinel as _sentinel

        self.uninstall_preemption_handler()
        _diag.unregister_engine(self)
        _trace.watchdog_disarm(f"serve[{self._uid}]")
        reset_serve_programs(owner=self._uid)
        profiler.metrics.default_registry().remove(
            "serve_token_lat_ms", labels={"engine": str(self._uid)})
        # a closed engine's keys get no further observations: a tripped one
        # could never clear, and per-engine state must not grow with churn
        _sentinel.retire(f"serve[{self._uid}]")
        _sentinel.retire(f"serve_decode[{self._uid}:")
        _sentinel.retire(f"serve_queue_wait[{self._uid}]")
        try:
            _attribution.retire(f"serve:prefill:{self._uid}:")
            _attribution.retire(f"serve:decode:{self._uid}:")
            _attribution.retire(f"serve[{self._uid}]")
        except Exception:
            pass
        self._admission.close()
        self._health = "dead"

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter shutdown — caches are going away anyway

    # -- introspection ---------------------------------------------------
    def reset_stats(self):
        """Drop the latency histogram and the step timings (e.g. after a
        warm-up window, so steady-state percentiles don't average in capture
        time). Counters in profiler.dispatch_counters() reset separately;
        pool peak occupancy is lifetime."""
        self._token_lat.reset()
        self._timings.clear()

    def step_timings(self) -> List[StepTiming]:
        """The last steps' ``StepTiming`` records, oldest first (at most
        the last 16384 steps since the engine started or ``reset_stats``)."""
        return list(self._timings)

    def stats(self) -> Dict[str, Any]:
        """Percentiles come from the streaming histogram: O(buckets), no
        reservoir copy, lifetime coverage (bounded relative error from the
        log bucketing — see profiler.metrics.Histogram)."""
        from ..core.lazy import serve_capture_state

        p50 = self._token_lat.quantile(0.5)
        p99 = self._token_lat.quantile(0.99)
        return {
            "health": self._health,
            "completed": self._n_completed,
            "rejected": self._n_rejected,
            "shed": self._n_shed,
            "expired": self._n_expired,
            "errors": self._n_errors,
            "restarts": self._restarts,
            "admission": self._admission.state(),
            "pending": self.pending,
            "pool_blocks": self._pool.num_blocks,
            "pool_occupancy": round(self._pool.occupancy(), 4),
            "pool_peak_occupancy": round(self._pool.peak_occupancy, 4),
            "token_lat_p50_ms": None if p50 is None else round(p50, 3),
            "token_lat_p99_ms": None if p99 is None else round(p99, 3),
            "token_lat_count": self._token_lat.count,
            "capture": serve_capture_state(),
        }

    def routing_signals(self) -> Dict[str, Any]:
        """The cost/queue signals a router routes on.
        ``prefill_ema_ms`` is the bucket-average scalar (the per-bucket
        table rides in ``admission``)."""
        adm = self._admission.state()
        pre = adm.get("prefill_ema_ms") or {}
        return {
            "engine": self._uid,
            "health": self._health,
            "queue_depth": len(self._queue),
            "inflight": len(self._active),
            "prefill_ema_ms": (round(sum(pre.values()) / len(pre), 3)
                               if pre else None),
            "tok_ema_ms": adm.get("decode_tok_ema_ms"),
            "admission": adm,
        }

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _release(self, seq: Sequence):
        """The one teardown path every sequence exit goes through: out of
        the active set, blocks back on the free-list, exactly once — the
        leak audit in run_until_idle stays at zero because nothing frees
        by hand."""
        if seq in self._active:
            self._active.remove(seq)
        if seq.blocks:
            self._pool.free(seq.blocks)
            seq.blocks = []

    def _reject(self, req: Request, why: str):
        profiler.count("serve_requests_rejected")
        self._n_rejected += 1
        self._responses[req.request_id] = Response(
            request_id=req.request_id, status="rejected", error=why,
            prompt_len=int(req.prompt.size), submit_time=req.submit_time,
        )
        _trace.emit("serve", site="engine", phase="reject", rid=req.request_id,
                    why=why[:120])

    def _shed(self, req: Request, decision):
        """Load shedding: a structured, retriable 'overloaded' response —
        the admission controller predicted this request cannot be served
        in time (or the queue is at cap / the trip wire is open), so the
        honest answer is 'retry elsewhere/later', not a queue slot that
        ends in a timeout."""
        profiler.count("serve_requests_shed")
        profiler.count_labeled("serve_shed_reasons", decision.reason)
        self._n_shed += 1
        self._responses[req.request_id] = Response(
            request_id=req.request_id, status="overloaded",
            error=f"overloaded ({decision.reason}): {decision.detail}",
            retriable=True,
            prompt_len=int(req.prompt.size), submit_time=req.submit_time,
            done_time=time.time(),
            retry_after_ms=self._admission.retry_after_ms(),
        )
        _trace.emit("serve", site="engine", phase="shed", rid=req.request_id,
                    reason=decision.reason, priority=req.priority)

    def _expire(self, req: Request, stage: str,
                seq: Optional[Sequence] = None):
        """Deadline expiry: a terminal 'timeout' response. Mid-decode
        expiry keeps the partial output when FLAGS_serving_deadline_partial
        is on (greedy decode makes partials meaningful); the caller has
        already released the sequence's blocks."""
        profiler.count("serve_deadline_expired")
        profiler.count_labeled("serve_expire_stages", stage)
        self._n_expired += 1
        partial = bool(flags.flag("serving_deadline_partial"))
        tokens = list(seq.tokens) if (seq is not None and partial) else []
        n_gen = 0 if seq is None else len(seq.tokens)
        self._responses[req.request_id] = Response(
            request_id=req.request_id, status="timeout",
            error=(f"deadline of {req.deadline_ms:.0f} ms exceeded at "
                   f"stage '{stage}' after {n_gen} tokens"),
            tokens=tokens,
            prompt_len=int(req.prompt.size), submit_time=req.submit_time,
            first_token_time=getattr(req, "_first_token_time", None),
            done_time=time.time(),
        )
        _trace.emit("serve", site="engine", phase="expire", rid=req.request_id,
                    stage=stage, tokens=n_gen, priority=req.priority)

    def _error(self, req: Request, why: str, seq: Optional[Sequence] = None):
        self._n_errors += 1
        self._responses[req.request_id] = Response(
            request_id=req.request_id, status="error", error=why,
            tokens=list(seq.tokens) if seq is not None else [],
            prompt_len=int(req.prompt.size), submit_time=req.submit_time,
            done_time=time.time(),
        )
        _trace.emit("serve", site="engine", phase="error", rid=req.request_id,
                    why=why[:120])

    def _complete(self, seq: Sequence):
        self._release(seq)
        profiler.count("serve_requests_completed")
        _trace.emit("serve", site="engine", phase="complete",
                    rid=seq.req.request_id, tokens=len(seq.tokens))
        self._n_completed += 1
        self._responses[seq.req.request_id] = Response(
            request_id=seq.req.request_id, status="ok",
            tokens=list(seq.tokens), prompt_len=int(seq.req.prompt.size),
            submit_time=seq.req.submit_time,
            first_token_time=getattr(seq.req, "_first_token_time", None),
            done_time=time.time(),
            logits=list(seq.logits) if self._keep_logits else None,
        )

    def _requeue_seq(self, seq: Sequence, err: BaseException,
                     count_retry: bool = True):
        """Tear one sequence down and re-run it from its prompt (greedy
        decode is deterministic — the re-run reproduces the same tokens).
        Past FLAGS_serving_request_retries, the request gets an error
        response. ``count_retry=False`` is the restart path: the engine
        wedged, not the request, so in-flight work must not burn its
        retries — the restart budget (FLAGS_serving_max_engine_restarts →
        fail_clean) is the bound there."""
        self._release(seq)
        req = seq.req
        if count_retry:
            req.retries += 1
            if req.retries > int(flags.flag("serving_request_retries")):
                self._error(
                    req, f"failed after {req.retries - 1} retries: {err}", seq)
                return
        profiler.count("serve_request_requeues")
        _trace.emit("serve", site="engine", phase="requeue", rid=req.request_id,
                    retries=req.retries, error=type(err).__name__)
        self._queue.push_front(req)

    def _recover_pools(self, err: _PoolsConsumed):
        """A fault escaped the captured rung: the pool may be half-written.
        Zero the storage in place and restart every in-flight sequence."""
        self._pool.reset_storage()
        for seq in list(self._active):
            self._requeue_seq(seq, err.cause)
        self._mark_degraded(f"pool rebuilt after {type(err.cause).__name__}")

    def _mark_degraded(self, why: str):
        if self._health in ("draining", "dead"):
            return  # terminal-ish states outrank degraded
        self._degraded_until = self._tick_no + _DEGRADED_COOLDOWN_TICKS
        self._set_health("degraded", why)

    def _admit(self):
        from ..models.gpt import CacheOverflow

        while True:
            # pop-first, not peek-then-pop: the engine always operates on
            # the request it actually popped and push_front restores it on
            # backpressure
            req = self._queue.pop()
            if req is None:
                return
            # last call before the expensive part: a request that expired
            # between the tick-start queue scan and this pop must not
            # burn a prefill (or the blocks behind it)
            if req.expired(self._now()):
                self._expire(req, stage="prefill")
                continue
            n_blk = self._buckets.ctx_blocks(
                int(req.prompt.size), req.max_new_tokens)
            try:
                blocks = self._pool.alloc(n_blk)
            except CacheOverflow as e:
                profiler.count("serve_admission_refusals")
                self._reject(req, str(e))
                continue
            if blocks is None:
                # backpressure: wait for a completion to free blocks
                self._queue.push_front(req)
                return
            wait_ms = (self._now() - req.submit_time) * 1000.0
            self._admission.note_queue_wait(wait_ms)
            _sentinel().observe(f"serve_queue_wait[{self._uid}]", wait_ms)
            seq = Sequence(req, blocks, n_blk)
            try:
                self._prefill(seq)
            except _PoolsConsumed as e:
                self._active.append(seq)  # so recovery requeues it too
                self._recover_pools(e)
                return
            except Exception as e:  # every rung failed — requeue just this one
                self._requeue_seq(seq, e)
                return

    def _prefill(self, seq: Sequence):
        t0 = time.perf_counter()
        req = seq.req
        plen = int(req.prompt.size)
        padded = self._buckets.pad_prompt(req.prompt)
        P = int(padded.shape[-1])
        args = (
            tuple(self._pool.k), tuple(self._pool.v),
            _feed([seq.table_row()]), _feed(padded[None, :]), _feed([plen]),
        )
        key = ("prefill", self._uid, P, seq.n_blk)
        row, nxt, prefill_ms = self._finish(
            key, self._launch(key, self._prefill_fn, args), t0, (req.request_id,))
        tok = int(nxt[0])
        profiler.count("serve_prefills")
        self._token_lat.observe(prefill_ms)
        self._admission.note_prefill(P, prefill_ms)
        _trace.emit("serve", site="engine", phase="prefill", rid=req.request_id,
                    bucket=P, blocks=seq.n_blk, ms=round(prefill_ms, 3))
        seq.length = plen
        seq.tokens.append(tok)
        seq.last_token = tok
        req._first_token_time = time.time()
        if row is not None:
            seq.logits.append(row[0])
        self._active.append(seq)
        if seq.done:
            self._complete(seq)

    def _decode_batch(self, seqs: List[Sequence], n_blk: int) -> bool:
        """One decode step for one batch. Returns False only when a fault
        forced a pool rebuild (the caller must abort its group snapshot for
        this tick)."""
        from ..models.gpt import CacheOverflow

        # sequences at context capacity can't take another token — finish
        # them with what they have rather than corrupting a neighbor block
        ready = []
        for s in seqs:
            if s.length + 1 > s.n_blk * self._block_size:
                self._release(s)
                self._error(
                    s.req,
                    str(CacheOverflow(s.length + 1,
                                      s.n_blk * self._block_size)),
                    s,
                )
            else:
                ready.append(s)
        if not ready:
            return True
        t0 = time.perf_counter()
        B = self._buckets.batch_bucket(len(ready))
        rows = [s.table_row() for s in ready]
        lens = [s.length for s in ready]
        toks = [s.last_token for s in ready]
        for slot in range(len(ready), B):  # pad rows → per-slot scratch block
            rows.append([slot] * n_blk)
            lens.append(0)
            toks.append(0)
        args = (
            tuple(self._pool.k), tuple(self._pool.v),
            _feed(rows), _feed(lens), _feed(toks),
        )
        key = ("decode", self._uid, B, n_blk)
        try:
            launched = self._launch(key, self._decode_fn, args)
        except _PoolsConsumed as e:
            self._recover_pools(e)
            return False
        except Exception as e:  # every rung failed — requeue this batch only
            for s in ready:
                self._requeue_seq(s, e)
            return True
        # outside the try, as the JAX engine's device_get: an error the
        # device reports at the read escapes the tick to the Supervisor
        row_np, out, step_ms = self._finish(
            key, launched, t0, tuple(s.req.request_id for s in ready))
        profiler.count("serve_decode_steps")
        _trace.emit("serve", site="engine", phase="decode",
                    rids=tuple(s.req.request_id for s in ready), batch=B,
                    blocks=n_blk, ms=round(step_ms, 3))
        self._admission.note_decode(step_ms, len(ready))
        # one regression baseline per decode bucket, on the step's device
        # time (its CUDA events, read with the tokens) on the card
        timing = self._timings[-1] if self._timings else None
        dev_ms = timing.device_ms if timing is not None else None
        _sentinel().observe(f"serve_decode[{self._uid}:{B}x{n_blk}]",
                            step_ms if dev_ms is None else dev_ms)
        now = self._now()
        for i, s in enumerate(ready):
            tok = int(out[i])
            s.length += 1
            s.tokens.append(tok)
            s.last_token = tok
            if row_np is not None:
                s.logits.append(row_np[i])
            self._token_lat.observe(step_ms)
            if s.done:
                self._complete(s)
            elif s.req.expired(now):
                # mid-decode expiry: this row leaves the group here (the
                # group list is rebuilt every tick, so no other row moves)
                # and answers 'timeout' with its partial output
                self._release(s)
                self._expire(s.req, stage="decode", seq=s)
        return True

    def _launch(self, key, fn, args):
        """One step through the rungs; returns what ``_finish`` reads."""
        t_launch = time.perf_counter()
        if self._events:
            self._events[0].record()
        _, _, row, nxt = self._run_tiered(key, fn, args)
        if self._events:
            self._events[1].record()
        return row, nxt, t_launch

    def _finish(self, key, launched, t_feed, request_ids):
        """A launched step's next tokens (and logits rows with keep_logits)
        read back to the host and its ``StepTiming`` recorded. Returns
        ``(rows or None, tokens, ms)``: ``ms`` runs from the launch to the
        tokens on the host, what the latency histogram and the admission
        controller's cost EMAs observe. The read is where an asynchronous
        CUDA error of the step surfaces."""
        row, nxt, t_launch = launched
        t_wait = time.perf_counter()
        nxt = nxt.cpu().numpy()
        row = row.cpu().numpy() if self._keep_logits else None
        end = time.perf_counter()
        device_ms = self._events[0].elapsed_time(self._events[1]) if self._events else None
        self._timings.append(StepTiming(
            kind=key[0], request_ids=request_ids, batch=int(nxt.shape[0]),
            blocks=key[3], end=end,
            feed_ms=(t_launch - t_feed) * 1e3, launch_ms=(t_wait - t_launch) * 1e3,
            wait_ms=(end - t_wait) * 1e3, device_ms=device_ms, rung=self._rung))
        self._note_program(key, (end - t_launch) * 1e3 if device_ms is None else device_ms)
        return row, nxt, (end - t_launch) * 1e3

    def _note_program(self, key, ms):
        """One run of a bucket program into the attribution registry: the
        step's device ms on the card (its CUDA events), the launch to the
        tokens on the host clock on the CPU. A key's first run built it."""
        from ..profiler import attribution as _attribution

        akey = "serve:" + ":".join(str(x) for x in key)
        if akey in self._noted and self._rung == "captured":
            _attribution.note_run(akey, "serve", ms)
        elif akey not in self._noted:
            self._noted.add(akey)
            from ..core import lazy as _lazy

            # the IR its first run recorded, not the program (which holds
            # the model): the registry must not keep a closed engine alive
            prog = _lazy.serve_program_if_cached(key)
            ir = None if prog is None else prog.ir
            _attribution.register(akey, "serve",
                                  ir_thunk=None if ir is None else (lambda: ir))

    def _run_tiered(self, key, fn, args):
        """captured (in place) → retained (on copies) → eager, each rung
        under ``resilience.runtime.execute`` at site ``key[0]`` (prefill or
        decode), the floor at site ``op``."""
        from ..core import lazy as _lazy

        kind = key[0]
        device = args[0][0].device

        def floor():
            return fn(args[0], args[1], *_lazy.stage_feeds(args[2:], device))

        if not flags.flag("serving_capture"):
            self._rung = "eager"
            return _rt.execute(kind, floor)
        prog = _lazy.serve_program(key, fn)
        if flags.flag("serving_capture_donate") and _rt.captured_tier_ok(key):
            try:
                self._rung = "captured"
                return _rt.execute(
                    kind, lambda: prog.run(args, donate=True),
                    fresh=not prog.built(True), ladder_key=key, retry_unsafe=True)
            except Exception as e:
                profiler.count("serve_capture_fallbacks")
                if not isinstance(e, _faults.InjectedFault):
                    # the graph may have written part of the pool before it
                    # failed: never reuse those contents
                    raise _PoolsConsumed(e)
                # injected faults raise BEFORE the graph runs: the pool is
                # intact, take the retry-safe rung over it
        try:
            self._rung = "retained"
            return _rt.execute(kind, lambda: prog.run(args, donate=False),
                               fresh=not prog.built(False), ladder_key=key)
        except Exception:
            # the retained rung wrote only copies, so the floor runs over
            # an intact pool; a deterministic bug fails again below and
            # propagates to the requeue/error path
            profiler.count("serve_capture_fallbacks")
        self._rung = "eager"
        return _rt.execute("op", floor)
