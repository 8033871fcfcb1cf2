"""The profiler API of the port (``paddle_tpu_torch/profiler/__init__.py``,
``statistic.py``) against the JAX package's, and the flight recorder's
repairs.

- ``make_scheduler`` gives the reference's state sequences over a grid of
  ``closed``, ``ready``, ``record``, ``repeat`` and ``skip_first``;
  ``on_trace_ready`` fires at the same steps; the export has the
  reference's keys and reads back through ``load_profiler_result``;
  ``build_summary_report`` prints the same text for the same events.
- The device side is a ``torch.profiler`` session whose chrome trace lands
  in the directory the export's metadata names; ``RecordEvent`` annotates
  it.
- The reference's ``tests/test_observability.py`` runs here with ``paddle``
  bound to the port: the ring, events by kind and site, the step clock,
  the flush / program / capture events and the fallback reasons they
  carry, fault and ladder events, checkpoint events, the registry, the
  serving histogram and request lanes, postmortems and the stall
  watchdog. Not run here: the two cases that drive the JAX dispatcher's
  private counter functions (held in ``test_torch_metrics.py`` through the
  port's own), the verifier's postmortem (item 12b), and the two
  subprocess cases the reference marks slow.
"""
import json
import os
import tempfile

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import paddle_tpu.profiler as jprof
import paddle_tpu.profiler.statistic as jstat
import paddle_tpu_torch as tp
import paddle_tpu_torch.profiler as tprof
import paddle_tpu_torch.profiler.statistic as tstat
from tests import torch_ref_port

globals().update(torch_ref_port.collect(
    torch_ref_port.load("test_observability.py"), "ref",
    skip=("concurrent_scrape_vs_reset_exposition", "counter_reset_race_free_helper",
          "verification_error_postmortem", "postmortem_on_injected_fatal_fault_subprocess",
          "obs_probe_cli")))


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


@settings(max_examples=60, deadline=None)
@given(closed=st.integers(0, 3), ready=st.integers(0, 3), record=st.integers(1, 4),
       repeat=st.integers(0, 3), skip_first=st.integers(0, 3))
def test_scheduler_states_equal_the_reference(closed, ready, record, repeat, skip_first):
    kw = dict(closed=closed, ready=ready, record=record, repeat=repeat, skip_first=skip_first)
    j, t = jprof.make_scheduler(**kw), tprof.make_scheduler(**kw)
    assert [t(s).name for s in range(40)] == [j(s).name for s in range(40)]


def _fired(prof, scheduler, steps=12):
    fired = []
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU], scheduler=scheduler, timer_only=True,
                      on_trace_ready=lambda pr: fired.append(pr._step))
    p.start()
    for _ in range(steps):
        p.step()
    p.stop()
    return fired


@pytest.mark.parametrize("sched", [dict(closed=1, ready=1, record=2),
                                   dict(closed=0, ready=0, record=3, repeat=2),
                                   dict(closed=2, ready=1, record=1, skip_first=3),
                                   (2, 5)])
def test_on_trace_ready_fires_at_the_same_steps(sched):
    def make(prof):
        return prof.make_scheduler(**sched) if isinstance(sched, dict) else sched

    assert _fired(tprof, make(tprof)) == _fired(jprof, make(jprof))


def _export(prof, d):
    with prof.RecordEvent("step"):
        with prof.RecordEvent("data"):
            pass
    path = os.path.join(d, "trace.json")
    prof.Profiler(timer_only=True).export(path)
    return prof.load_profiler_result(path)


def test_export_keys_equal_the_reference_and_read_back():
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        jdoc, tdoc = _export(jprof, a), _export(tprof, b)
    assert sorted(tdoc) == sorted(jdoc)
    assert sorted(tdoc["metadata"]) == sorted(jdoc["metadata"])
    assert tdoc["metadata"]["framework"] == "paddle_tpu_torch"
    spans = {e["name"] for e in tdoc["traceEvents"] if e.get("cat") == "host"}
    assert {"step", "data"} <= spans
    host = [e for e in tdoc["traceEvents"] if e.get("cat") == "host"]
    assert sorted(host[0]) == sorted(next(e for e in jdoc["traceEvents"]
                                          if e.get("cat") == "host"))


EVENTS = [{"name": n, "ph": "X", "ts": float(i), "dur": d, "pid": 1, "tid": 1, "cat": "host"}
          for i, (n, d) in enumerate([("forward", 120.0), ("backward", 250.5), ("matmul", 31.0),
                                      ("matmul", 29.0), ("MyBlock", 77.7), ("dataloader", 12.0),
                                      ("optimizer_step", 40.25), ("relu", 3.5)])]


@pytest.mark.parametrize("sorted_by", ["total", "avg", "max", "calls"])
@pytest.mark.parametrize("unit", ["ms", "us", "s"])
def test_summary_report_is_the_reference_text(sorted_by, unit):
    assert tstat.build_summary_report(EVENTS, sorted_by=sorted_by, time_unit=unit) == \
        jstat.build_summary_report(EVENTS, sorted_by=sorted_by, time_unit=unit)


def test_device_trace_lands_where_the_metadata_says(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PADDLE_PROFILER_DIR", str(tmp_path / "dev"))
    exported = []
    prof = tprof.Profiler(targets=[tprof.ProfilerTarget.CPU],
                          scheduler=tprof.make_scheduler(closed=1, ready=0, record=1,
                                                         repeat=1),
                          on_trace_ready=tprof.export_chrome_tracing(str(tmp_path / "out")))
    prof._on_trace_ready = (lambda handler: lambda p: exported.append(handler(p)))(
        prof._on_trace_ready)
    import torch

    with prof:
        for _ in range(3):
            with tprof.RecordEvent("train_step"):
                torch.ones(8, 8) @ torch.ones(8, 8)
            prof.step()
    (path,) = exported
    doc = tprof.load_profiler_result(path)
    ddir = doc["metadata"]["device_trace_dir"]
    assert ddir and ddir.startswith(str(tmp_path / "dev"))
    with open(os.path.join(ddir, "device.pt.trace.json")) as f:
        device = json.load(f)
    names = {e.get("name") for e in device["traceEvents"]}
    assert "train_step" in names and "aten::mm" in names
    table = prof.summary()
    assert "train_step" in table and "train_step" in capsys.readouterr().out


def test_export_protobuf_wraps_the_chrome_trace(tmp_path):
    path = tprof.export_protobuf(str(tmp_path))(tprof.Profiler(timer_only=True))
    blob = open(path, "rb").read()
    assert blob[:8] == b"PDTRACE1"
    assert json.loads(blob[16:])["metadata"]["framework"] == "paddle_tpu_torch"


def test_benchmark_timer_counts_samples():
    timer = tprof.benchmark()
    timer.reset()
    for _ in range(3):
        timer.step(4)
    assert timer._n == 8 and timer.ips() > 0


def test_cpu_captured_step_runs_at_the_captured_site():
    """Repair (ROADMAP queue 3, F4): a captured step on the CPU runs
    under ``resilience.runtime.execute("captured")`` as the card's replay
    does, so an ``execute:captured`` fault plan fires there, is retried,
    and the run stays bitwise the clean one."""
    import numpy as np

    import paddle_tpu_torch.resilience as tres
    from paddle_tpu_torch.core import lazy

    def run(spec):
        tres.reset()
        lazy.reset_lazy_state()
        tprof.reset_dispatch_counters()
        tp.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_step_capture": True,
                      "FLAGS_fault_inject": spec, "FLAGS_retry_backoff_ms": 0.5})
        try:
            tp.seed(0)
            model = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.ReLU(), tp.nn.Linear(16, 4))
            opt = tp.optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
            x = tp.to_tensor(np.ones((4, 8), np.float32))
            y = tp.to_tensor(np.zeros((4,), np.int64))
            losses = []
            for _ in range(6):
                loss = tp.nn.CrossEntropyLoss()(model(x), y)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
            return losses, dict(tprof.dispatch_counters()["fault_sites"])
        finally:
            tp.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_fault_inject": "",
                          "FLAGS_retry_backoff_ms": 5.0})
            lazy.reset_lazy_state()
            tres.reset()

    clean, _ = run("")
    faulted, sites = run("execute:captured:p=1:x=2")
    assert faulted == clean
    assert sites.get("captured", 0) >= 1, sites
