"""The perf-regression sentinel of the port (``paddle_tpu_torch/profiler/
sentinel.py``) against the JAX package's.

- The reference's ``tests/test_sentinel.py`` runs here with ``paddle``
  bound to the port, at its own assertions: warm-up and arming, one trip
  with hysteresis, suppressions (ladder demotion, a checkpoint persist, an
  on-path snapshot), the trip's postmortem, lap keys, the training and
  serving feeds, retirement. One line differs: the on-path snapshot
  counts ``ckpt_snapshots`` through ``profiler.count`` (the port's
  counters live in ``profiler``, not in ``core.dispatch``).
- The same seeded observation sequences through both sentinels give equal
  ``state()``, trips, clears and suppressions.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.profiler as jprof
import paddle_tpu.resilience as jres
import paddle_tpu_torch as tp
import paddle_tpu_torch.profiler as tprof
import paddle_tpu_torch.resilience as tres

from tests import torch_ref_port

_REF = torch_ref_port.load("test_sentinel.py", edits=[(
    '''    from paddle_tpu.core import dispatch

    s = sentinel.PerfSentinel()
    _steady(s)
    dispatch._counters["ckpt_snapshots"] += 1  # a save landed this step''',
    '''    s = sentinel.PerfSentinel()
    _steady(s)
    prof.count("ckpt_snapshots")  # a save landed this step''')])
globals().update(torch_ref_port.collect(_REF, "ref"))


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


FLAGS = {"FLAGS_sentinel_pct": 25.0, "FLAGS_sentinel_warmup_steps": 4,
         "FLAGS_sentinel_sustain_steps": 3}
OFF = {"FLAGS_sentinel_pct": 0.0, "FLAGS_sentinel_warmup_steps": 10,
       "FLAGS_sentinel_sustain_steps": 3, "FLAGS_postmortem_dir": ""}


@pytest.fixture
def both():
    for pkg, prof, res in ((jp, jprof, jres), (tp, tprof, tres)):
        res.reset()
        prof.reset_dispatch_counters()
        prof.trace.clear()
        prof.sentinel.reset()
        pkg.set_flags(FLAGS)
    yield
    for pkg, prof, res in ((jp, jprof, jres), (tp, tprof, tres)):
        pkg.set_flags(OFF)
        prof.sentinel.reset()
        res.reset()


def _sequence(seed, n=80):
    """A seeded mix of steady phases, slowdowns, blips, speedups and
    recoveries over three keys, with key switches for ``lap``."""
    rng = np.random.default_rng(seed)
    base = {k: float(rng.uniform(2.0, 20.0)) for k in ("train", "serve_decode[1:2x4]",
                                                        "serve_queue_wait[1]")}
    seq = []
    for i in range(n):
        key = ("train", "serve_decode[1:2x4]", "serve_queue_wait[1]")[int(rng.integers(3))]
        phase = (i // 12) % 4  # steady, slow, recovered, fast
        factor = {0: 1.0, 1: 1.8, 2: 1.0, 3: 0.6}[phase]
        if rng.random() < 0.1:
            factor *= 3.0  # a one-step blip
        seq.append((key, round(base[key] * factor * float(rng.uniform(0.97, 1.03)), 4)))
    return seq


def _observable(prof):
    c = prof.dispatch_counters()
    trips = [(e.site, e.attrs["phase"]) for e in prof.trace.events(kind="perf_regression")]
    return (prof.sentinel.state(), prof.sentinel.tripped(), int(c["perf_regressions"]),
            int(c["perf_regression_clears"]), dict(c["perf_regression_sites"]), trips)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_observations_give_equal_states_and_trips(both, seed):
    seq = _sequence(seed)
    for key, ms in seq:
        jprof.sentinel.observe(key, ms)
        tprof.sentinel.observe(key, ms)
    assert _observable(tprof) == _observable(jprof)
    assert jprof.sentinel.state()["keys"]  # the sequence armed something


@pytest.mark.parametrize("seed", [4, 5])
def test_retire_and_external_trips_agree(both, seed):
    seq = _sequence(seed, n=50)
    for prof in (jprof, tprof):
        for key, ms in seq:
            prof.sentinel.observe(key, ms)
        prof.sentinel.trip_external("straggler[node-3]", drift_pct=41.0)
        prof.sentinel.trip_external("straggler[node-3]")  # idempotent while latched
        prof.sentinel.retire("serve_decode[1:")
        prof.sentinel.clear_external("straggler[node-3]")
    assert _observable(tprof) == _observable(jprof)


def test_suppressed_while_the_ladder_is_demoted_in_both(both):
    for pkg, prof in ((jp, jprof), (tp, tprof)):
        from importlib import import_module

        ladder = import_module(pkg.__name__ + ".resilience.ladder")
        pkg.set_flags({"FLAGS_ladder_demote_after": 1})
        for _ in range(6):
            prof.sentinel.observe("train", 10.0)
        ladder.degradation_ladder().record_fault("captured", key="k")
        for _ in range(8):
            prof.sentinel.observe("train", 40.0)
        pkg.set_flags({"FLAGS_ladder_demote_after": 2})
    assert _observable(tprof) == _observable(jprof)
    assert tprof.sentinel.state()["keys"]["train"]["last_suppressed"] == "ladder_demoted"
