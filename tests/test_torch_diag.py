"""The diagnostics server of the port (``paddle_tpu_torch/profiler/diag.py``)
against the JAX package's.

- The reference's ``tests/test_diag_server.py`` runs here with ``paddle``
  bound to the port, at its own assertions: off by default, every endpoint
  (exposition, healthz/readyz codes, flight filters, postmortem list and
  fetch with traversal safety, statusz, clockz, 404), the stale-heartbeat
  flip, the sentinel's 'degraded', engine health aggregation and a scrape
  storm against counter churn.
- One scenario against both servers in one process gives the same status
  codes and the same JSON keys on every endpoint.
"""
import json
import os
import tempfile
import urllib.error
import urllib.request

import pytest

import paddle_tpu as jp
import paddle_tpu.profiler as jprof
import paddle_tpu.resilience as jres
import paddle_tpu_torch as tp
import paddle_tpu_torch.profiler as tprof
import paddle_tpu_torch.resilience as tres
from tests import torch_ref_port

# the storm's writer bumps counters through the port's counter functions
# (its counters live in ``profiler``, not in ``core.dispatch``), with 64
# labels, so a family grows while the first scrapes copy it
_STORM = [(
    """    from paddle_tpu.core import dispatch

    stop = threading.Event()

    def writer():
        while not stop.is_set():
            dispatch._counters["programs"] += 1
            dispatch._counter_add_labeled("flush_reasons", "storm")
""",
    """    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        try:
            while not stop.is_set():
                prof.count("programs")
                prof.count_labeled_locked("flush_reasons", f"storm{i % 64}")
                i += 1
        except Exception as e:  # noqa: BLE001 — the writer must not die silently
            errors.append(e)
"""), (
    """    finally:
        stop.set()
        th.join(timeout=5)""",
    """    finally:
        stop.set()
        th.join(timeout=5)
    assert not errors, errors""")]
globals().update(torch_ref_port.collect(
    torch_ref_port.load("test_diag_server.py", edits=_STORM), "ref"))


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


def _get(addr, path):
    try:
        with urllib.request.urlopen(f"http://{addr}{path}", timeout=5.0) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _keys(body):
    try:
        doc = json.loads(body)
    except ValueError:
        return None
    return sorted(doc) if isinstance(doc, dict) else type(doc).__name__


def _scenario(pkg, prof, res, pmdir):
    """Start the server, feed a heartbeat, trip the sentinel, dump a
    postmortem; every endpoint's (code, JSON keys) at each stage."""
    res.reset()
    prof.reset_dispatch_counters()
    prof.trace.clear()
    prof.sentinel.reset()
    pkg.set_flags({"FLAGS_postmortem_dir": pmdir, "FLAGS_sentinel_pct": 25.0,
                   "FLAGS_sentinel_warmup_steps": 4, "FLAGS_sentinel_sustain_steps": 3})
    addr = prof.diag.start(port=0)
    out = []
    paths = ("/", "/healthz", "/readyz", "/flight?kind=perf_regression&last=4", "/postmortems",
             "/clockz", "/programz?static=0", "/nope", "/postmortems/../etc")
    try:
        res.on_step_end()
        for stage in ("healthy", "tripped"):
            if stage == "tripped":
                for ms in [10.0] * 6 + [40.0] * 4:
                    prof.sentinel.observe("train", ms)
            for path in paths:
                code, body = _get(addr, path)
                out.append((stage, path, code, _keys(body)))
            code, body = _get(addr, "/metrics")
            parsed = prof.metrics.parse_prometheus_text(body.decode())
            out.append((stage, "/metrics", code, parsed.get("paddle_perf_regressions")))
            code, body = _get(addr, "/statusz")
            out.append((stage, "/statusz", code, b"perf-regression sentinel" in body))
        name = sorted(f for f in os.listdir(pmdir) if f.startswith("postmortem_perf"))[0]
        code, body = _get(addr, "/postmortems/" + name)
        doc = json.loads(body)
        out.append(("fetch", code, sorted(doc), sorted(doc["attribution"])))
        health = json.loads(_get(addr, "/healthz")[1])
        out.append(("health", health["status"], health["reasons"], health["sentinel_tripped"]))
    finally:
        prof.diag.stop()
        pkg.set_flags({"FLAGS_postmortem_dir": "", "FLAGS_sentinel_pct": 0.0,
                       "FLAGS_sentinel_warmup_steps": 10})
        prof.sentinel.reset()
        prof.trace.watchdog_disarm()
        res.reset()
    return out


def test_same_codes_and_json_keys_as_the_reference_server():
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        ref = _scenario(jp, jprof, jres, a)
        port = _scenario(tp, tprof, tres, b)
    assert port == ref
    assert ("health", "degraded", ["perf_regression"], ["train"]) in port


def test_the_server_binds_the_loopback_interface_by_default():
    assert tp.get_flags("FLAGS_diag_host")["FLAGS_diag_host"] == "127.0.0.1"
    addr = tprof.diag.start(port=0)
    try:
        assert addr.startswith("127.0.0.1:")
    finally:
        tprof.diag.stop()
