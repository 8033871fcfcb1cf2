"""The typed metrics registry of the port (``paddle_tpu_torch/profiler/
metrics.py``) against the JAX package's: the same observations give equal
``snapshot()`` dicts and equal ``prometheus_text()`` strings, label values
escape and parse back, and the dispatch counters are adopted under their
declared types. A scrape on another thread never sees a torn exposition
while counters are written and reset.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu.profiler.metrics as jm
import paddle_tpu_torch.profiler as tprof
import paddle_tpu_torch.profiler.metrics as tm

LABELS = ["plain", 'quo"te', "back\\slash", "new\nline", "all \\ \" \n three", ""]


def _fill(m, seed):
    rng = np.random.default_rng(seed)
    reg = m.MetricsRegistry()
    for i, lab in enumerate(LABELS):
        c = reg.counter("requests_total", doc="requests", labels={"route": lab})
        c.inc(float(rng.integers(1, 100)))
        g = reg.gauge("pool_occupancy", doc="occupancy", labels={"engine": str(i)})
        g.set(float(rng.uniform(0, 1)))
        g.add(0.125)
    for name, start, factor in (("lat_ms", 0.001, 1.3), ("wait_ms", 0.01, 1.1)):
        h = reg.histogram(name, doc="latency", labels={"k": name}, start=start, factor=factor)
        for v in rng.lognormal(0.0, 1.5, 500):
            h.observe(float(v))
        h.observe(float("nan"))  # dropped and counted, never raised
    reg.counter("plain_total").inc()
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_observations_give_equal_snapshots_and_text(seed):
    jr, tr = _fill(jm, seed), _fill(tm, seed)
    assert tr.snapshot(include_dispatch=False) == jr.snapshot(include_dispatch=False)
    text = tr.prometheus_text(include_dispatch=False)
    assert text == jr.prometheus_text(include_dispatch=False)
    assert tm.parse_prometheus_text(text) == jm.parse_prometheus_text(text)


def test_histogram_surface_equals_the_reference():
    rng = np.random.default_rng(3)
    hs = [m.Histogram("h", labels={"a": "1"}, factor=1.2) for m in (jm, tm)]
    for v in rng.exponential(2.0, 1000):
        for h in hs:
            h.observe(float(v))
    j, t = hs
    assert (t.count, t.sum, t.mean(), t.kind, t.full_name()) == \
        (j.count, j.sum, j.mean(), j.kind, j.full_name())
    assert t.to_dict() == j.to_dict()
    assert [t.quantile(q) for q in (0, 0.5, 0.9, 0.99, 1)] == \
        [j.quantile(q) for q in (0, 0.5, 0.9, 0.99, 1)]
    with pytest.raises(ValueError):
        tm.Counter("c").inc(-1)
    with pytest.raises(TypeError):
        reg = tm.MetricsRegistry()
        reg.counter("x")
        reg.gauge("x")


@pytest.mark.parametrize("value", LABELS)
def test_escape_and_parse_round_trip(value):
    assert tm.escape_label_value(value) == jm.escape_label_value(value)
    assert tm.unescape_label_value(tm.escape_label_value(value)) == value
    reg = tm.MetricsRegistry()
    reg.gauge("g", labels={"v": value}).set(2.5)
    parsed = tm.parse_prometheus_text(reg.prometheus_text(include_dispatch=False))
    (key,) = parsed
    assert parsed[key] == 2.5 and "\n" not in key
    inner = key[len('paddle_g{v="'):-2]
    assert tm.unescape_label_value(inner) == value


def test_dispatch_counters_are_adopted_under_their_types():
    tprof.reset_dispatch_counters()
    tprof.count("programs", 3)
    tprof.gauge_locked("ckpt_auto_save_freq", 7)
    tprof.count_labeled_locked("perf_regression_sites", "train[1]")
    tprof.count_labeled_locked("telemetry_spike_groups", "linear_0")
    try:
        snap = tm.snapshot()
        assert snap["counters"]["programs"] == 3.0
        assert snap["gauges"]["ckpt_auto_save_freq"] == 7.0
        assert snap["counters"]['perf_regression_sites{site="train[1]"}'] == 1.0
        text = tm.prometheus_text()
        assert "# TYPE paddle_ckpt_auto_save_freq gauge" in text
        parsed = tm.parse_prometheus_text(text)
        assert parsed['paddle_telemetry_spike_groups{group="linear_0"}'] == 1.0
        # the same schema as the reference's
        assert tm._DISPATCH_GAUGES == jm._DISPATCH_GAUGES
        assert tm._DISPATCH_LABEL_KEYS == jm._DISPATCH_LABEL_KEYS
    finally:
        tprof.reset_dispatch_counters()


def test_concurrent_scrape_vs_reset_exposition():
    """Scrapes on two threads while another writes counters (new labels
    included) and a third resets them: never an error, never a torn
    exposition. ``reset_dispatch_counters`` zeroes in place, so no scrape
    sees a counter missing mid-reset."""
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        try:
            while not stop.is_set():
                tprof.count_locked("async_compile_ms", 0.5)
                tprof.count_labeled_locked("flush_reasons", f"r{i % 7}")
                tprof.count_locked("programs")
                i += 1
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def resetter():
        try:
            while not stop.is_set():
                tprof.reset_dispatch_counters()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def scraper():
        while not stop.is_set():
            try:
                snap = tm.snapshot(include_dispatch=True)
                assert "programs" in snap["counters"]
                parsed = tm.parse_prometheus_text(tm.prometheus_text(include_dispatch=True))
                assert "paddle_programs" in parsed
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=f) for f in (writer, resetter, scraper, scraper)]
    for t in threads:
        t.start()
    time.sleep(0.4)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    tprof.reset_dispatch_counters()
    assert not errors, errors[:1]
