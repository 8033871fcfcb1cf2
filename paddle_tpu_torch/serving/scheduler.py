"""Request queue + shape-bucketed continuous-batching scheduler state: the
port of ``paddle_tpu/serving/scheduler.py`` (host code, line for line).

Every distinct shape is one captured program (a CUDA graph on the card),
so the scheduler funnels arbitrary traffic into a SMALL set of program
signatures (the ``io/bucketing.py`` padding policy, applied twice):

  - prompts pad up to a prompt-length bucket → one captured prefill
    program per (prompt bucket, context bucket);
  - each decode step pads its active-sequence batch up to a batch-size
    bucket → one captured decode program per (batch bucket, context
    bucket), idle rows pointed at per-slot scratch blocks.

A request whose context chain can never fit the block pool is REJECTED up
front (``CacheOverflow`` → an error response, not a dead engine), and a
request that merely has to wait for free blocks queues — continuous
batching refills decode slots as sequences complete.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core import flags
from ..io.bucketing import BucketSpec

__all__ = ["PRIORITIES", "Request", "Response", "RequestQueue",
           "Sequence", "ServingBuckets", "group_for_decode"]

_REQUEST_IDS = itertools.count(1)


PRIORITIES = ("interactive", "batch")


@dataclass
class Request:
    """One generation request: a prompt, its decode limits, and its SLO
    (deadline + priority class)."""

    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    request_id: int = field(default_factory=lambda: next(_REQUEST_IDS))
    submit_time: float = field(default_factory=time.time)
    # times the engine has torn this request down and re-enqueued it after
    # a non-recoverable fault (bounded by FLAGS_serving_request_retries)
    retries: int = 0
    # SLO: wall-clock deadline in ms from submit (None = inherit
    # FLAGS_serving_default_deadline_ms at admission; 0/None after that =
    # no deadline), and the priority class — 'interactive' admits and pops
    # ahead of 'batch', and 'batch' sheds first under overload
    deadline_ms: Optional[float] = None
    priority: str = "interactive"

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int64).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(self.max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got "
                f"{self.priority!r}")
        if self.deadline_ms is not None:
            self.deadline_ms = float(self.deadline_ms)
            if self.deadline_ms < 0:
                raise ValueError(
                    "deadline_ms must be >= 0 (0/None = no deadline)")
            if self.deadline_ms == 0:
                # the documented opt-out: an explicit 0 means NO deadline —
                # it is the only way to override a configured
                # FLAGS_serving_default_deadline_ms (None inherits it)
                self.deadline_ms = None

    @property
    def deadline_time(self) -> Optional[float]:
        """Absolute wall-clock deadline (seconds since epoch), or None."""
        if self.deadline_ms is None:
            return None
        return self.submit_time + self.deadline_ms / 1000.0

    def expired(self, now: float) -> bool:
        dl = self.deadline_time
        return dl is not None and now >= dl

    def remaining_ms(self, now: float) -> Optional[float]:
        dl = self.deadline_time
        return None if dl is None else (dl - now) * 1000.0


@dataclass
class Response:
    """The engine's answer. ``status`` is one of:

    - ``"ok"``          every requested token generated (or EOS hit)
    - ``"rejected"``    refused at admission (budget overflow / draining)
    - ``"overloaded"``  shed by SLO-aware admission (queue cap, queue-wait
                        p99 trip wire, or a predicted deadline miss) —
                        structured and ``retriable``: resubmit later
    - ``"timeout"``     the request's deadline passed; ``tokens`` carries
                        the partial output when the expiry was mid-decode
                        and FLAGS_serving_deadline_partial is on
    - ``"error"``       accepted but failed after the retry budget

    A request is NEVER silently dropped: every submitted request gets
    exactly one terminal Response (the chaos serve gate fails otherwise)."""

    request_id: int
    status: str
    tokens: List[int] = field(default_factory=list)
    error: Optional[str] = None
    # True for load-shedding responses ('overloaded'): the request itself
    # was fine, the engine was not — resubmitting later can succeed
    retriable: bool = False
    prompt_len: int = 0
    # wall-clock timing (seconds since epoch): submit → first token → done
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    done_time: Optional[float] = None
    # per-generated-token logits rows ([vocab] float arrays) when the
    # engine runs with keep_logits=True (parity tests / debugging)
    logits: Optional[List[np.ndarray]] = None
    # for 'overloaded' (shed) responses: how long the admission controller
    # estimates the caller (or the FrontDoor re-dispatching to a sibling)
    # should wait before retrying, from the measured queue-wait EMA; None
    # when the controller has no measured waits yet
    retry_after_ms: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return (self.first_token_time - self.submit_time) * 1000.0

    @property
    def latency_ms(self) -> Optional[float]:
        if self.done_time is None:
            return None
        return (self.done_time - self.submit_time) * 1000.0


class RequestQueue:
    """Two-class admission queue: FIFO within a priority class, and
    ``interactive`` always pops ahead of ``batch`` — so batch traffic can
    never starve interactive under a storm (the shed policy is the other
    half: batch sheds first). Single-threaded engines drive it directly;
    per-class ``submit`` is safe to call from a signal handler
    (deque.append is atomic).

    The queue itself is pure mechanism — the CAP (FLAGS_serving_queue_max)
    is enforced by the engine's admission path, which must answer the
    over-cap request with a structured 'overloaded' response rather than
    silently refuse."""

    def __init__(self):
        self._qs: Dict[str, deque] = {"interactive": deque(),
                                      "batch": deque()}

    def push(self, req: Request):
        self._qs[req.priority].append(req)

    def push_front(self, req: Request):
        self._qs[req.priority].appendleft(req)

    def peek(self) -> Optional[Request]:
        for p in PRIORITIES:
            if self._qs[p]:
                return self._qs[p][0]
        return None

    def pop(self) -> Optional[Request]:
        for p in PRIORITIES:
            if self._qs[p]:
                return self._qs[p].popleft()
        return None

    def iter_priority(self, priority: str):
        """Queued requests of one class, pop order."""
        return iter(list(self._qs[priority]))

    def take_expired(self, now: float) -> List[Request]:
        """Remove and return every queued request whose deadline has
        passed — expired work must answer 'timeout' instead of wasting a
        prefill (and the blocks behind it)."""
        out: List[Request] = []
        for p in PRIORITIES:
            q = self._qs[p]
            # scan a snapshot, delete by IDENTITY: deque.remove would go
            # through Request's dataclass == (ambiguous ndarray truth
            # value), and a rotation would scramble FIFO order against a
            # concurrent signal-handler push. The common case (no
            # deadlines configured) never mutates the deque at all.
            for r in list(q):
                if not r.expired(now):
                    continue
                # indexed access, not an iterator: a concurrent
                # signal-handler append must not raise 'deque mutated
                # during iteration' out of the engine tick
                for i in range(len(q)):
                    try:
                        if q[i] is r:
                            del q[i]
                            out.append(r)
                            break
                    except IndexError:
                        break  # raced with a concurrent pop
        return out

    def __iter__(self):
        for p in PRIORITIES:
            yield from list(self._qs[p])

    def __len__(self):
        return sum(len(q) for q in self._qs.values())

    def __bool__(self):
        return any(self._qs.values())


def _validate_buckets(out: List[int], origin) -> List[int]:
    if not out or sorted(out) != out or any(b <= 0 for b in out):
        raise ValueError(
            f"bucket list {origin!r} must be ascending positive ints")
    return out


def _parse_buckets(text: str) -> List[int]:
    out = [int(t) for t in str(text).split(",") if t.strip()]
    return _validate_buckets(out, text)


class ServingBuckets:
    """Both bucket tables plus the context arithmetic, validated against the
    block size once at engine construction."""

    def __init__(self, *, block_size: int,
                 prompt_buckets: Optional[List[int]] = None,
                 decode_batch_buckets: Optional[List[int]] = None):
        self.block_size = int(block_size)
        pb = (_validate_buckets([int(b) for b in prompt_buckets],
                                prompt_buckets)
              if prompt_buckets is not None
              else _parse_buckets(flags.flag("serving_prompt_buckets")))
        for b in pb:
            if b % self.block_size != 0:
                raise ValueError(
                    f"prompt bucket {b} is not a multiple of "
                    f"FLAGS_serving_block_size={self.block_size}"
                )
        # BucketSpec gives the rounding rule (each distinct padded shape is
        # one captured prefill); its recompile-budget warning fires where it
        # records shapes (apply, collate), which prompt padding does not call,
        # as in the JAX scheduler
        self.prompt_spec = BucketSpec(boundaries=pb, axis=-1, pad_value=0)
        db = (_validate_buckets([int(b) for b in decode_batch_buckets],
                                decode_batch_buckets)
              if decode_batch_buckets is not None
              else _parse_buckets(flags.flag("serving_decode_batch_buckets")))
        self.decode_batch_buckets = db

    @property
    def max_decode_batch(self) -> int:
        return self.decode_batch_buckets[-1]

    def prompt_bucket(self, length: int) -> int:
        return self.prompt_spec.bucket_for(int(length))

    def batch_bucket(self, n: int) -> int:
        for b in self.decode_batch_buckets:
            if n <= b:
                return b
        return self.decode_batch_buckets[-1]

    def ctx_blocks(self, prompt_len: int, max_new: int) -> int:
        """Logical blocks a sequence needs for its whole life: the padded
        prompt plus every token it may generate, rounded up to blocks."""
        ctx = self.prompt_bucket(prompt_len) + int(max_new)
        return -(-ctx // self.block_size)

    def pad_prompt(self, prompt: np.ndarray) -> np.ndarray:
        return self.prompt_spec.pad(np.asarray(prompt, np.int64))


class Sequence:
    """One admitted, in-flight generation."""

    __slots__ = ("req", "blocks", "n_blk", "length", "tokens", "last_token",
                 "logits")

    def __init__(self, req: Request, blocks: List[int], n_blk: int):
        self.req = req
        self.blocks = blocks
        self.n_blk = int(n_blk)
        self.length = 0          # tokens currently cached (post-prefill)
        self.tokens: List[int] = []
        self.last_token: int = 0
        self.logits: List[np.ndarray] = []

    @property
    def done(self) -> bool:
        if len(self.tokens) >= self.req.max_new_tokens:
            return True
        eos = self.req.eos_token_id
        return eos is not None and bool(self.tokens) and self.tokens[-1] == eos

    def table_row(self) -> List[int]:
        return list(self.blocks)


def group_for_decode(active: List[Sequence]) -> Dict[int, List[Sequence]]:
    """Continuous batching: bucket the active set by context width (table
    shape) — each group decodes as one padded batch per step."""
    groups: Dict[int, List[Sequence]] = {}
    for s in active:
        groups.setdefault(s.n_blk, []).append(s)
    return groups
