"""The unified typed metrics registry: the port of
``paddle_tpu/profiler/metrics.py``, host code copied as it is.

  Counter    monotonically increasing value (events, accumulated ms)
  Gauge      last-set value (cadence frequency, pool occupancy)
  Histogram  log-bucketed streaming distribution with O(1) ``observe`` and
             O(buckets) quantiles: no sample reservoir, lifetime coverage

plus a ``MetricsRegistry`` with a stable ``snapshot()`` API and Prometheus
text exposition. The hot-path dispatch counters stay in their flat dict
(``profiler.dispatch_counters()``: one ``+=`` per event); the registry
ADOPTS them at snapshot and exposition time with a declared type schema, so
``snapshot()`` / ``prometheus_text()`` are the one window over everything.
The serving engine's per-token latency, the admission controller's queue
wait, the attribution layer's program costs and telemetry gauges and the
diagnostics server's scrape counters register here.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "escape_label_value",
    "parse_prometheus_text",
    "prometheus_text",
    "snapshot",
    "unescape_label_value",
]


def escape_label_value(v: str) -> str:
    """Prometheus exposition-format (v0.0.4) label-value escaping:
    backslash, double-quote, and newline. Without this, an error-string or
    request-id label value containing any of the three corrupts the whole
    exposition — a raw newline even splits one sample into two junk lines."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def unescape_label_value(v: str) -> str:
    """Inverse of :func:`escape_label_value` (consumer-side helper)."""
    out, i, n = [], 0, len(v)
    while i < n:
        c = v[i]
        if c == "\\" and i + 1 < n:
            nxt = v[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _label_str(labels: Dict[str, str]) -> str:
    # escaped in snapshot keys AND the exposition (one serialization, so
    # parse_prometheus_text round-trips against snapshot() verbatim)
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    """Shared identity bits: name, doc, labels, and the per-metric lock."""

    kind = "untyped"

    def __init__(self, name: str, doc: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.doc = doc
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        # the escaped label string, built once: every scrape renders it
        self._lstr = _label_str(self.labels)

    def full_name(self) -> str:
        return self.name + self._lstr


class Counter(_Metric):
    """Monotonic counter. ``inc`` is thread-safe; negative increments raise
    (a counter that can go down is a Gauge)."""

    kind = "counter"

    def __init__(self, name: str, doc: str = "", labels=None):
        super().__init__(name, doc, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


class Gauge(_Metric):
    """Last-set value (may go up or down); ``add`` for deltas."""

    kind = "gauge"

    def __init__(self, name: str, doc: str = "", labels=None):
        super().__init__(name, doc, labels)
        self._value = 0.0

    def set(self, v: float):
        # one attribute store is atomic under the interpreter lock: no lock
        # (the telemetry record sets three gauges per parameter group a step)
        self._value = float(v)

    def add(self, n: float):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


class Histogram(_Metric):
    """Log-bucketed streaming histogram.

    Buckets are geometric: upper bounds ``start * factor**i`` for
    ``i < nbuckets``, plus an overflow bucket. ``observe`` is an O(log)
    bucket-index computation and one increment — no sample is retained, so
    the histogram covers the metric's LIFETIME at fixed memory. ``quantile``
    interpolates inside the winning bucket geometrically, so relative error
    is bounded by ``factor`` (default 1.3 → ≤ ~15%, plenty for p50/p99
    latency reporting; narrow the factor for tighter bounds)."""

    kind = "histogram"

    def __init__(self, name: str = "", doc: str = "", labels=None, *,
                 start: float = 0.001, factor: float = 1.3,
                 nbuckets: int = 90):
        super().__init__(name, doc, labels)
        if not (start > 0 and factor > 1 and nbuckets > 0):
            raise ValueError("need start > 0, factor > 1, nbuckets > 0")
        self.start = float(start)
        self.factor = float(factor)
        self._log_factor = math.log(self.factor)
        self.nbuckets = int(nbuckets)
        self._counts = [0] * (self.nbuckets + 1)  # +1: overflow
        self._count = 0
        self._sum = 0.0
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
            # NaN/inf would crash the bucket index (and poison sum/extremes)
            # — an observability layer must never add a second failure, so
            # the sample is dropped and counted instead of raised
            with self._lock:
                self._dropped += 1
            return
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def mean(self) -> Optional[float]:
        return self._sum / self._count if self._count else None

    def _state_copy(self):
        """One locked, internally consistent copy of the live state."""
        with self._lock:
            return (list(self._counts), self._count, self._sum,
                    self._min, self._max)

    def _quantile_of(self, q, counts, total, mn, mx) -> Optional[float]:
        """Quantile over a consistent state copy (pure). Exact min/max are
        tracked, so q=0/q=1 (and estimates beyond the observed range) are
        clamped to the true extremes."""
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

    def quantile(self, q: float) -> Optional[float]:
        """Streaming quantile estimate; None while empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        counts, count, _total, mn, mx = self._state_copy()
        return self._quantile_of(q, counts, count, mn, mx)

    def reset(self):
        with self._lock:
            self._counts = [0] * (self.nbuckets + 1)
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None
            self._dropped = 0

    def to_dict(self) -> Dict[str, Any]:
        # count/sum/min/max/quantiles/buckets all derive from ONE locked
        # copy, so a snapshot taken mid-observe can never pair a stale
        # count with fresher extremes or report a p50 outside its buckets
        counts, count, total, mn, mx = self._state_copy()
        out = {
            "count": count,
            "sum": round(total, 6),
            "min": mn,
            "max": mx,
            "p50": self._quantile_of(0.5, counts, count, mn, mx),
            "p99": self._quantile_of(0.99, counts, count, mn, mx),
        }
        if self._dropped:
            out["dropped"] = self._dropped
        # cumulative Prometheus-style buckets, empty tail elided
        cum, buckets = 0, []
        for i, c in enumerate(counts):
            cum += c
            if c:
                buckets.append([self.upper_bound(i), cum])
        out["buckets"] = buckets
        return out


# ---------------------------------------------------------------------------
# The dispatch-counter adoption schema: every key of
# profiler.dispatch_counters() is a counter unless named here. Nested dicts
# (flush_reasons, ...) become
# labeled counter families.
# ---------------------------------------------------------------------------
_DISPATCH_GAUGES = frozenset(("ckpt_auto_save_freq",))
_DISPATCH_LABEL_KEYS = {
    "flush_reasons": "reason",
    "capture_fallback_reasons": "reason",
    "fault_sites": "site",
    "serve_shed_reasons": "reason",
    "serve_expire_stages": "stage",
    "perf_regression_sites": "site",
    "telemetry_spike_groups": "group",
}


_dispatch_labels: Dict[Tuple, str] = {}  # a family's escaped label strings


def _dispatch_label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    key = tuple(labels.items())
    text = _dispatch_labels.get(key)
    if text is None:
        text = _dispatch_labels[key] = _label_str(labels)
    return text


def _dispatch_items():
    """(name, labels, kind, value) rows for the current dispatch counters."""
    from collections.abc import Mapping

    from .. import profiler

    rows: List[Tuple[str, Dict[str, str], str, float]] = []
    for k, v in profiler.dispatch_counters().items():
        if isinstance(v, Mapping):  # incl. the immutable MappingProxyType
            label = _DISPATCH_LABEL_KEYS.get(k, "key")
            for sub, n in sorted(v.items()):
                rows.append((k, {label: str(sub)}, "counter", float(n)))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            kind = "gauge" if k in _DISPATCH_GAUGES else "counter"
            rows.append((k, {}, kind, float(v)))
    return rows


class MetricsRegistry:
    """Named metric store with get-or-create accessors.

    A metric's identity is (name, labels); re-requesting it returns the
    SAME object (so modules can hold references or re-resolve by name), and
    requesting an existing name with a different type raises."""

    def __init__(self):
        self._metrics: Dict[Tuple, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, doc: str, labels, **kw) -> _Metric:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name=name, doc=doc, labels=labels, **kw)
                self._metrics[key] = m
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            elif kw:
                # get-or-create must not silently hand back a metric with
                # DIFFERENT parameters than requested — a histogram asked
                # for with a tighter bucket geometry would otherwise carry
                # the old error bound with no signal
                for k, v in kw.items():
                    if getattr(m, k, None) != v:
                        raise ValueError(
                            f"metric {name!r} already registered with "
                            f"{k}={getattr(m, k, None)!r}, requested {v!r}"
                        )
            return m

    def counter(self, name: str, doc: str = "", labels=None) -> Counter:
        return self._get(Counter, name, doc, labels)

    def gauge(self, name: str, doc: str = "", labels=None) -> Gauge:
        return self._get(Gauge, name, doc, labels)

    def histogram(self, name: str, doc: str = "", labels=None,
                  **kw) -> Histogram:
        return self._get(Histogram, name, doc, labels, **kw)

    def remove(self, name: str, labels=None):
        """Unregister one metric (e.g. a closed serving engine's latency
        histograms); missing entries are a no-op."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            self._metrics.pop(key, None)

    def clear(self):
        with self._lock:
            self._metrics.clear()

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- the stable snapshot API --------------------------------------------
    def snapshot(self, include_dispatch: bool = True) -> Dict[str, Any]:
        """One structured, detached snapshot of everything: registry-native
        metrics plus (by default) the adopted dispatch-counter family.
        Mutating the result never touches live state."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            fname = m.full_name()
            if m.kind == "counter":
                out["counters"][fname] = m.value
            elif m.kind == "gauge":
                out["gauges"][fname] = m.value
            else:
                out["histograms"][fname] = m.to_dict()
        if include_dispatch:
            for name, labels, kind, value in _dispatch_items():
                bucket = "gauges" if kind == "gauge" else "counters"
                out[bucket][name + _label_str(labels)] = value
        return out

    def prometheus_text(self, include_dispatch: bool = True,
                        prefix: str = "paddle_") -> str:
        """Prometheus text exposition (v0.0.4) of the same snapshot.
        Histograms render the standard ``_bucket{le=}``/``_sum``/``_count``
        triplet with cumulative counts."""
        lines: List[str] = []
        seen_help = set()

        def head(name, kind, doc):
            if name not in seen_help:
                seen_help.add(name)
                if doc:
                    lines.append(f"# HELP {name} {doc}")
                lines.append(f"# TYPE {name} {kind}")

        for m in sorted(self.metrics(), key=lambda m: m.full_name()):
            name = prefix + m.name
            if m.kind in ("counter", "gauge"):
                head(name, m.kind, m.doc)
                lines.append(f"{name}{m._lstr} {_fmt(m.value)}")
            else:
                head(name, "histogram", m.doc)
                d = m.to_dict()
                for le, cum in d["buckets"]:
                    lbl = dict(m.labels)
                    lbl["le"] = "+Inf" if math.isinf(le) else _fmt(le)
                    lines.append(f"{name}_bucket{_label_str(lbl)} {cum}")
                lbl = dict(m.labels)
                lbl["le"] = "+Inf"
                if not d["buckets"] or not math.isinf(d["buckets"][-1][0]):
                    lines.append(
                        f"{name}_bucket{_label_str(lbl)} {d['count']}")
                lines.append(f"{name}_sum{m._lstr} {_fmt(d['sum'])}")
                lines.append(f"{name}_count{m._lstr} {d['count']}")
        if include_dispatch:
            for dname, labels, kind, value in _dispatch_items():
                name = prefix + dname
                head(name, kind, "")
                lines.append(f"{name}{_dispatch_label_str(labels)} {_fmt(value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the runtime's own metrics register into."""
    return _default


def snapshot(include_dispatch: bool = True) -> Dict[str, Any]:
    """``default_registry().snapshot()`` — module-level convenience."""
    return _default.snapshot(include_dispatch=include_dispatch)


def prometheus_text(include_dispatch: bool = True) -> str:
    """``default_registry().prometheus_text()`` — ready to serve from a
    ``/metrics`` endpoint."""
    return _default.prometheus_text(include_dispatch=include_dispatch)


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Minimal parser for the exposition format this module emits (the
    round-trip half the tests and tools use): ``{full_name: value}`` for
    every sample line, comments skipped."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        out[name] = float(value)
    return out
