"""The statistics report over the profiler's host spans: the port of
``paddle_tpu/profiler/statistic.py``, host code copied as it is.

Reference analogue: python/paddle/profiler/profiler_statistic.py
(StatisticData + _build_table). The span list is flat (the device side is
``torch.profiler``'s trace), so the report classifies spans by name into
the reference's Overview and Operator views and aggregates totals,
averages and extremes.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["StatisticData", "build_summary_report"]

_FRAMEWORK_PREFIXES = ("dataloader", "optimizer", "backward", "forward", "step")


class StatisticData:
    def __init__(self, events: List[dict]):
        self.events = events

    def _agg(self, names=None):
        agg: Dict[str, dict] = {}
        for e in self.events:
            if names is not None and e["name"] not in names:
                continue
            a = agg.setdefault(
                e["name"], {"calls": 0, "total_us": 0.0, "max_us": 0.0, "min_us": float("inf")}
            )
            a["calls"] += 1
            a["total_us"] += e["dur"]
            a["max_us"] = max(a["max_us"], e["dur"])
            a["min_us"] = min(a["min_us"], e["dur"])
        return agg

    def overview(self):
        """Totals per category — the reference's Overview Summary."""
        cats = {"Framework": 0.0, "Operator": 0.0, "UserDefined": 0.0}
        for e in self.events:
            name = e["name"].lower()
            if any(name.startswith(p) for p in _FRAMEWORK_PREFIXES):
                cats["Framework"] += e["dur"]
            elif name.isidentifier() and name == name.lower():
                cats["Operator"] += e["dur"]
            else:
                cats["UserDefined"] += e["dur"]
        return cats

    def operator_summary(self):
        return self._agg()


def _fmt_table(title, header, rows):
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(str(h))
              for i, h in enumerate(header)]
    sep = "-" * (sum(widths) + 2 * len(widths))
    out = [sep, title, sep,
           "  ".join(str(h).ljust(w) for h, w in zip(header, widths))]
    for r in rows:
        out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    out.append(sep)
    return "\n".join(out)


def build_summary_report(events, sorted_by="total", time_unit="ms") -> str:
    """The reference's _build_table equivalent: Overview + Operator views."""
    data = StatisticData(events)
    div = {"ms": 1e3, "us": 1.0, "s": 1e6}[time_unit]

    cats = data.overview()
    total = sum(cats.values()) or 1.0
    over_rows = [
        (k, f"{v/div:.3f}", f"{100*v/total:.1f}%")
        for k, v in sorted(cats.items(), key=lambda kv: -kv[1])
    ]
    parts = [_fmt_table("Overview Summary", ("Category", f"Total({time_unit})", "Ratio"), over_rows)]

    agg = data.operator_summary()
    keyfns = {
        "total": lambda a: a["total_us"],
        "max": lambda a: a["max_us"],
        "calls": lambda a: a["calls"],
        "avg": lambda a: a["total_us"] / a["calls"],
    }
    keyfn = keyfns[sorted_by]
    op_rows = [
        (
            name[:48],
            a["calls"],
            f"{a['total_us']/div:.3f}",
            f"{a['total_us']/a['calls']/div:.3f}",
            f"{a['max_us']/div:.3f}",
            f"{a['min_us']/div:.3f}",
        )
        for name, a in sorted(agg.items(), key=lambda kv: -keyfn(kv[1]))
    ]
    parts.append(
        _fmt_table(
            "Operator Summary",
            ("Name", "Calls", f"Total({time_unit})", f"Avg({time_unit})",
             f"Max({time_unit})", f"Min({time_unit})"),
            op_rows,
        )
    )
    return "\n\n".join(parts)
