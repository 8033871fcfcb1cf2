"""SLO-aware admission control: predict, then shed — never hang. The port of
``paddle_tpu/serving/admission.py`` (host code, line for line).

Costs come from the serving engine's own timings (the same samples that
feed its ``serve_token_lat_ms`` histogram):

- per-bucket **prefill cost** EMA (one per prompt bucket — each bucket is
  its own captured program with its own cost);
- per-row **decode token cost** EMA (decode-step ms divided by the live
  rows in the batch — continuous batching amortizes the step across rows);
- a **queue-wait trip wire**: waits are recorded both into the
  ``serve_queue_wait_ms`` streaming histogram (lifetime, for
  observability) and a bounded recent window whose p99 is the overload
  signal — storms age out of the window, so the trip wire recovers.

An incoming request's predicted completion time is

    backlog_ms(ahead of it) + prefill_ema[its bucket] + max_new * tok_ema

and admission sheds — a structured, *retriable* ``overloaded`` response,
never a silent queue-in-to-time-out — when:

1. the queue is at ``FLAGS_serving_queue_max`` (hard cap, both classes);
2. the queue-wait p99 exceeds ``FLAGS_serving_queue_wait_p99_ms``
   (trip wire — batch only: interactive rides through a storm);
3. the prediction misses the request's deadline (both classes; batch
   counts ALL queued work ahead of it while interactive counts only
   interactive, which is the other half of "batch sheds first").

Cold start admits optimistically: with no measured costs yet there is no
prediction, and the deadline enforcement in the engine (queue/prefill/
decode expiry) is the backstop.
"""
from __future__ import annotations

import time as _time
from collections import deque
from typing import List, Optional, Tuple

from ..core import flags

__all__ = ["AdmissionController", "ShedDecision"]

# EMA smoothing for the cost estimates — a handful of samples dominates,
# so the estimate tracks drift
_ALPHA = 0.25
# minimum queue-wait samples before the p99 trip wire may fire (a single
# slow wait must not flip the engine into shedding)
_TRIP_MIN_SAMPLES = 8
# the trip wire's p99 is computed over a RECENT window, not the lifetime
# histogram: a lifetime p99 would stay tripped long after a storm passed
# (and while tripped, shed batch traffic contributes no new samples to
# dilute it), so recovery would depend on unrelated interactive volume
_TRIP_WINDOW = 128
# samples also age out by WALL TIME: a batch-only workload that trips the
# wire stops admitting (and therefore stops sampling), so a count-bounded
# window alone would latch the trip forever — after this horizon with no
# fresh slow waits the wire stands down and batch traffic probes again
_TRIP_MAX_AGE_S = 30.0


class ShedDecision:
    """Why admission shed a request (reason is the counter label)."""

    __slots__ = ("reason", "detail")

    def __init__(self, reason: str, detail: str):
        self.reason = reason
        self.detail = detail

    def __repr__(self):
        return f"<ShedDecision {self.reason}: {self.detail}>"


class AdmissionController:
    """Measured-cost admission policy for one engine."""

    def __init__(self, engine_uid: int, bucket_of=None):
        from ..profiler import metrics as _metrics

        self._uid = str(engine_uid)
        # prompt length -> padded prompt bucket (the prefill-program key);
        # identity when the engine doesn't provide its bucket table
        self._bucket_of = bucket_of or (lambda n: int(n))
        self._prefill_ema = {}  # prompt bucket -> ms
        self._decode_tok_ema: Optional[float] = None  # ms per live row
        self._queue_wait = _metrics.default_registry().histogram(
            "serve_queue_wait_ms",
            doc="queue wait from submit to admission (prefill pop), ms",
            labels={"engine": self._uid},
        )
        # bounded recent-wait window for the trip wire (the registered
        # histogram above stays lifetime, for observability)
        self._recent_waits = deque(maxlen=_TRIP_WINDOW)
        # queue-wait EMA: the retry_after_ms hint on shed responses — how
        # long admitted work is currently waiting, i.e. roughly when a
        # retry would land in a shorter queue
        self._queue_wait_ema: Optional[float] = None

    # -- cost feedback (engine calls these with its measured timings) -----
    def note_prefill(self, bucket: int, ms: float):
        prev = self._prefill_ema.get(bucket)
        self._prefill_ema[bucket] = (
            ms if prev is None else prev + _ALPHA * (ms - prev))

    def note_decode(self, ms: float, rows: int):
        if rows < 1:
            return
        per_row = ms / rows
        prev = self._decode_tok_ema
        self._decode_tok_ema = (
            per_row if prev is None else prev + _ALPHA * (per_row - prev))

    def note_queue_wait(self, ms: float):
        self._queue_wait.observe(ms)
        self._recent_waits.append((_time.monotonic(), float(ms)))
        prev = self._queue_wait_ema
        self._queue_wait_ema = (
            float(ms) if prev is None else prev + _ALPHA * (ms - prev))

    def retry_after_ms(self) -> Optional[float]:
        """The hint shed ('overloaded') responses carry: the measured
        queue-wait EMA — what admitted work is waiting right now, so a
        retry after this long lands once the current backlog has drained a
        queue-slot's worth. None during cold start (no measured waits):
        the caller retries at its own cadence."""
        if self._queue_wait_ema is None:
            return None
        return round(max(1.0, self._queue_wait_ema), 3)

    # -- prediction -------------------------------------------------------
    def _prefill_cost(self, bucket: int) -> Optional[float]:
        c = self._prefill_ema.get(bucket)
        if c is not None:
            return c
        if self._prefill_ema:  # unseen bucket: borrow the known average
            return sum(self._prefill_ema.values()) / len(self._prefill_ema)
        return None

    def _request_cost_ms(self, bucket: int, max_new: int) -> Optional[float]:
        pre = self._prefill_cost(bucket)
        tok = self._decode_tok_ema
        if pre is None or tok is None:
            return None  # cold start: no prediction available
        return pre + max_new * tok

    def predict_completion_ms(self, *, bucket: int, max_new: int,
                              backlog: List[Tuple[Optional[int], int]],
                              ) -> Optional[float]:
        """Predicted ms until a request with (bucket, max_new) completes,
        given the work ahead of it as (prefill_bucket_or_None,
        remaining_tokens) items — None bucket means the prefill already
        ran (an in-flight sequence: only its decode tail remains).
        Returns None while costs are unmeasured (cold start admits)."""
        own = self._request_cost_ms(bucket, max_new)
        if own is None:
            return None
        total = own
        tok = self._decode_tok_ema or 0.0
        for b, remaining in backlog:
            pre = self._prefill_cost(b) if b is not None else 0.0
            total += (pre or 0.0) + max(0, remaining) * tok
        return total

    # -- the decision -----------------------------------------------------
    def queue_wait_p99(self) -> Optional[float]:
        """p99 of the RECENT queue waits (the trip-wire signal). Storms
        age out two ways: displaced by fresh samples (count window) or by
        wall time (_TRIP_MAX_AGE_S) — the latter matters when tripping
        itself stops the sampling (batch-only traffic shed pre-queue
        would otherwise freeze the window and latch the trip forever)."""
        horizon = _time.monotonic() - _TRIP_MAX_AGE_S
        while self._recent_waits and self._recent_waits[0][0] < horizon:
            self._recent_waits.popleft()
        waits = sorted(ms for _, ms in self._recent_waits)
        if len(waits) < _TRIP_MIN_SAMPLES:
            return None
        i = min(len(waits) - 1, int(0.99 * (len(waits) - 1) + 0.5))
        return waits[i]

    def decide(self, req, *, queue, active, now: float):
        """None to admit, or a :class:`ShedDecision`. ``queue`` is the
        engine's RequestQueue, ``active`` its in-flight Sequence list."""
        cap = int(flags.flag("serving_queue_max"))
        if cap > 0 and len(queue) >= cap:
            return ShedDecision(
                "queue_full",
                f"queue at FLAGS_serving_queue_max={cap}")
        trip_ms = float(flags.flag("serving_queue_wait_p99_ms"))
        if trip_ms > 0 and req.priority == "batch":
            p99 = self.queue_wait_p99()
            if p99 is not None and p99 > trip_ms:
                return ShedDecision(
                    "queue_p99",
                    f"queue-wait p99 {p99:.1f} ms > trip wire "
                    f"{trip_ms:.1f} ms — batch sheds first")
        remaining = req.remaining_ms(now)
        if remaining is None:
            return None  # no deadline, nothing to predict against
        backlog: List[Tuple[Optional[int], int]] = [
            (None, s.req.max_new_tokens - len(s.tokens)) for s in active]
        # interactive jumps the batch queue, so only interactive work is
        # ahead of it; batch waits behind everything
        ahead = (queue.iter_priority("interactive")
                 if req.priority == "interactive" else iter(queue))
        for q in ahead:
            backlog.append((self._bucket_of(int(q.prompt.size)),
                            q.max_new_tokens))
        predicted = self.predict_completion_ms(
            bucket=self._bucket_of(int(req.prompt.size)),
            max_new=req.max_new_tokens, backlog=backlog)
        if predicted is not None and predicted > remaining:
            return ShedDecision(
                "predicted_deadline_miss",
                f"predicted completion {predicted:.1f} ms > remaining "
                f"deadline {remaining:.1f} ms")
        return None

    def state(self) -> dict:
        """Snapshot for Engine.stats() / postmortems. ``queue_wait_p99_ms``
        is the recent-window value admission actually acts on; the
        lifetime distribution lives in the serve_queue_wait_ms
        histogram."""
        p99 = self.queue_wait_p99()
        return {
            "prefill_ema_ms": {k: round(v, 3)
                               for k, v in sorted(self._prefill_ema.items())},
            "decode_tok_ema_ms": (
                None if self._decode_tok_ema is None
                else round(self._decode_tok_ema, 4)),
            "queue_wait_p99_ms": None if p99 is None else round(p99, 3),
            "queue_wait_ema_ms": (
                None if self._queue_wait_ema is None
                else round(self._queue_wait_ema, 3)),
            "queue_wait_samples": self._queue_wait.count,
        }

    def close(self):
        from ..profiler import metrics as _metrics

        _metrics.default_registry().remove(
            "serve_queue_wait_ms", labels={"engine": self._uid})
