"""The streaming latency histogram: the port's copy of the ``Histogram`` and
the default ``MetricsRegistry`` of ``paddle_tpu/profiler/metrics.py``.

A ``Histogram`` is log-bucketed, with O(1) ``observe`` and O(buckets)
quantiles: no sample reservoir, lifetime coverage. The serving engine's
per-token latency and the admission controller's queue wait are histograms
in the default registry, keyed by (name, labels). Host code, copied as it
is. The counters, gauges, snapshots and the Prometheus exposition are not
ported (ROADMAP queue 1 item 12): no caller in the port reads them.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

__all__ = ["Histogram", "MetricsRegistry", "default_registry"]


class Histogram:
    """Log-bucketed streaming histogram.

    Buckets are geometric: upper bounds ``start * factor**i`` for
    ``i < nbuckets``, plus an overflow bucket. ``observe`` is an O(log)
    bucket-index computation and one increment — no sample is retained, so
    the histogram covers the metric's LIFETIME at fixed memory. ``quantile``
    interpolates inside the winning bucket geometrically, so relative error
    is bounded by ``factor`` (default 1.3 → ≤ ~15%, plenty for p50/p99
    latency reporting; narrow the factor for tighter bounds)."""

    def __init__(self, name: str = "", doc: str = "", labels=None, *,
                 start: float = 0.001, factor: float = 1.3,
                 nbuckets: int = 90):
        self.name = name
        self.doc = doc
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        if not (start > 0 and factor > 1 and nbuckets > 0):
            raise ValueError("need start > 0, factor > 1, nbuckets > 0")
        self.start = float(start)
        self.factor = float(factor)
        self._log_factor = math.log(self.factor)
        self.nbuckets = int(nbuckets)
        self._counts = [0] * (self.nbuckets + 1)  # +1: overflow
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._dropped = 0  # non-finite observations (see observe)

    def _index(self, v: float) -> int:
        if v <= self.start:
            return 0
        i = int(math.log(v / self.start) / self._log_factor) + 1
        return min(i, self.nbuckets)

    def upper_bound(self, i: int) -> float:
        """Upper bound of bucket ``i`` (inf for the overflow bucket)."""
        if i >= self.nbuckets:
            return math.inf
        return self.start * self.factor ** i

    def observe(self, v: float):
        v = float(v)
        if not math.isfinite(v):
            # NaN/inf would crash the bucket index (and poison the extremes)
            # — an observability layer must never add a second failure, so
            # the sample is dropped and counted instead of raised
            with self._lock:
                self._dropped += 1
            return
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    def quantile(self, q: float) -> Optional[float]:
        """Streaming quantile estimate; None while empty. Exact min/max are
        tracked, so q=0/q=1 (and estimates beyond the observed range) are
        clamped to the true extremes."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        with self._lock:  # one internally consistent copy of the state
            counts, total, mn, mx = (list(self._counts), self._count,
                                     self._min, self._max)
        if not total:
            return None
        if q <= 0.0:
            return mn
        if q >= 1.0:
            return mx
        rank = q * (total - 1) + 1
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                lo = self.start * self.factor ** (i - 1) if i else 0.0
                hi = self.upper_bound(i)
                if math.isinf(hi):
                    est = mx
                elif lo <= 0:
                    est = hi
                else:
                    est = math.sqrt(lo * hi)  # geometric midpoint
                return max(mn, min(mx, est))
        return mx  # unreachable, but keep the contract total

    def reset(self):
        with self._lock:
            self._counts = [0] * (self.nbuckets + 1)
            self._count = 0
            self._min = None
            self._max = None
            self._dropped = 0


class MetricsRegistry:
    """Named histogram store with a get-or-create accessor.

    A histogram's identity is (name, labels); re-requesting it returns the
    SAME object, and requesting it with different bucket parameters
    raises."""

    def __init__(self):
        self._metrics: Dict[Tuple, Histogram] = {}
        self._lock = threading.Lock()

    def histogram(self, name: str, doc: str = "", labels=None,
                  **kw) -> Histogram:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Histogram(
                    name=name, doc=doc, labels=labels, **kw)
            else:
                # get-or-create must not silently hand back a histogram
                # with a DIFFERENT bucket geometry than requested
                for k, v in kw.items():
                    if getattr(m, k, None) != v:
                        raise ValueError(
                            f"metric {name!r} already registered with "
                            f"{k}={getattr(m, k, None)!r}, requested {v!r}"
                        )
            return m

    def remove(self, name: str, labels=None):
        """Unregister one histogram (e.g. a closed serving engine's latency
        histograms); missing entries are a no-op."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            self._metrics.pop(key, None)


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the runtime's own metrics register into."""
    return _default
