"""The port's resilience runtime (``paddle_tpu_torch.resilience``) and flight
recorder (``paddle_tpu_torch.profiler.trace``) against the JAX package's, on
the CPU.

Host code on both sides, so the comparisons are exact: the same spec and seed
fire the same faults at the same (site, step) decision for decision, the same
fault/step sequence leaves the ladder in the same state, ``execute`` counts
the same retries, and ``is_transient`` classifies every non-CUDA error the
JAX test classifies as it does. The CUDA classification is the port's own and
is tested alone. The f32 Adam step under an ``optimizer`` fault and a
``nan:grads`` clause is held bitwise against the clean step with the same
fused update and a gradient poisoned by hand.
"""
import errno
import json
import os
import random
import signal
import threading
import time

import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.profiler as jprof
import paddle_tpu.resilience as jres
import paddle_tpu_torch as pt
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch import resilience as res
from paddle_tpu_torch.profiler import trace
from paddle_tpu_torch.resilience import faults, retry

SPECS = [
    "execute:p=0.3",
    "execute:p=0.2",
    "execute:p=0.5:decode,compile:prefill",
    "execute:p=1:x=3:decode",
    "execute:p=1:x=1:prefill",
    "execute:optimizer:p=1:x=1,nan:grads:step=2",
    "hang:p=0.4:step>=3:op,kill:checkpoint:step<=5",
]
SITES = ("op", "prefill", "decode", "optimizer", "checkpoint", "grads")
KINDS = ("execute", "compile", "hang", "nan", "kill")


@pytest.fixture(autouse=True)
def _isolation():
    res.reset()
    jres.reset()
    prof.reset_dispatch_counters()
    jprof.reset_dispatch_counters()
    trace.clear()
    yield
    flags = {"FLAGS_fault_inject": "", "FLAGS_retry_backoff_ms": 5.0,
             "FLAGS_retry_max": 2, "FLAGS_trace_stall_ms": 0.0,
             "FLAGS_postmortem_dir": "", "FLAGS_trace_ring_size": 4096,
             "FLAGS_numeric_rescue": "", "FLAGS_pallas_fused_update": False}
    pt.set_flags(flags)
    paddle.set_flags({"FLAGS_fault_inject": "", "FLAGS_retry_backoff_ms": 5.0})
    trace.watchdog_disarm()
    res.reset()
    jres.reset()


# ---------------------------------------------------------------------------
# faults: the spec grammar and the plan's decisions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", SPECS)
def test_parsed_spec_matches_jax(spec):
    ours, theirs = res.parse_fault_spec(spec), jres.parse_fault_spec(spec)
    slots = ("kind", "p", "step_lo", "step_hi", "step_eq", "repeat", "target", "index")
    assert [[getattr(c, a) for a in slots] for c in ours] == \
        [[getattr(c, a) for a in slots] for c in theirs]


@pytest.mark.parametrize("spec", ["execute:p=0.5:decoder", "bogus", "execute:q<3",
                                  "execute:op:decode"])
def test_invalid_specs_raise_in_both(spec):
    with pytest.raises(ValueError):
        jres.parse_fault_spec(spec)
    with pytest.raises(ValueError):
        res.parse_fault_spec(spec)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("spec", SPECS)
def test_would_fire_sequence_matches_jax(spec, seed):
    # the same spec and seed: the same would_fire answer and the same
    # consumption (three attempts per decision) at every (kind, site, step)
    ours = res.FaultPlan(res.parse_fault_spec(spec), seed)
    theirs = jres.FaultPlan(jres.parse_fault_spec(spec), seed)
    seq_ours, seq_theirs = [], []
    for step in range(12):
        for kind in KINDS:
            for site in SITES:
                for _ in range(3):
                    seq_ours.append(ours.would_fire(kind, site, step))
                    seq_theirs.append(theirs.would_fire(kind, site, step))
                    a, b = ours._fires(kind, site, step), theirs._fires(kind, site, step)
                    seq_ours.append(None if a is None else a.index)
                    seq_theirs.append(None if b is None else b.index)
    assert seq_ours == seq_theirs
    assert any(x not in (None, False) for x in seq_ours)


def test_fault_spec_accepts_serving_sites():
    plan = res.parse_fault_spec("execute:p=0.5:decode,compile:prefill")
    assert plan[0].target == "decode" and plan[1].target == "prefill"
    with pytest.raises(ValueError):
        res.parse_fault_spec("execute:p=0.5:decoder")


def test_active_plan_follows_flag_and_resets_on_toggle():
    pt.set_flags({"FLAGS_fault_inject": "execute:p=1:x=1:op"})
    plan = faults.active_plan()
    assert plan is faults.active_plan()  # cached per (spec, seed)
    with pytest.raises(res.InjectedExecuteError):
        plan.check("execute", "op", 0)
    plan.check("execute", "op", 0)  # x=1 spent
    pt.set_flags({"FLAGS_fault_inject": ""})
    assert faults.active_plan() is None
    pt.set_flags({"FLAGS_fault_inject": "execute:p=1:x=1:op"})
    with pytest.raises(res.InjectedExecuteError):  # replays from scratch
        faults.active_plan().check("execute", "op", 0)


def test_hang_injection_sleeps_then_raises_transient():
    pt.set_flags({"FLAGS_fault_inject": "hang:p=1:x=1:op", "FLAGS_fault_hang_ms": 30.0})
    try:
        t0 = time.perf_counter()
        with pytest.raises(res.InjectedHang) as ei:
            faults.active_plan().check("hang", "op", 0)
        assert time.perf_counter() - t0 >= 0.03
        assert res.is_transient(ei.value)
    finally:
        pt.set_flags({"FLAGS_fault_hang_ms": 20.0})


# ---------------------------------------------------------------------------
# retry: classification and backoff
# ---------------------------------------------------------------------------
NON_CUDA_CASES = [
    lambda m: m.InjectedExecuteError("x"),
    lambda m: ConnectionResetError("peer"),
    lambda m: OSError("disk briefly gone"),
    lambda m: RuntimeError("UNAVAILABLE: device preempted"),
    lambda m: ValueError("bad shape"),
    lambda m: FloatingPointError("nan"),
    lambda m: KeyboardInterrupt(),
    lambda m: RuntimeError("some deterministic bug"),
    lambda m: PermissionError(errno.EACCES, "denied"),
    lambda m: FileNotFoundError(errno.ENOENT, "gone"),
    lambda m: OSError(errno.ENOSPC, "no space"),
    lambda m: OSError(errno.EROFS, "read-only fs"),
    lambda m: OSError(errno.EIO, "io error"),
]


@pytest.mark.parametrize("case", range(len(NON_CUDA_CASES)))
def test_is_transient_matches_jax_on_non_cuda_errors(case):
    make = NON_CUDA_CASES[case]
    assert res.is_transient(make(res)) == jres.is_transient(make(jres))


@pytest.mark.parametrize("err,transient", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (torch.AcceleratorError("CUDA error: an illegal memory access was encountered"), False),
    (RuntimeError("CUDA error: device-side assert triggered"), False),
    # a CUDA error stays fatal whatever status word its message carries
    (RuntimeError("CUDA error: operation not permitted when stream is capturing "
                  "(UNAVAILABLE)"), False),
], ids=["oom", "accelerator_error", "device_assert", "cuda_error_with_marker"])
def test_is_transient_on_cuda_errors(err, transient):
    assert res.is_transient(err) is transient
    assert retry.is_cuda_error(err) is (not transient)


def test_retry_jitter_uses_its_own_generator():
    random.seed(5)
    want = random.random()
    random.seed(5)
    a = res.RetryPolicy(backoff_ms=4.0, backoff_max_ms=10.0, rng=random.Random(3))
    delays = [a.delay_ms(i) for i in (1, 2, 3, 4)]
    assert random.random() == want  # the module-global generator untouched
    b = res.RetryPolicy(backoff_ms=4.0, backoff_max_ms=10.0, rng=random.Random(3))
    assert [b.delay_ms(i) for i in (1, 2, 3, 4)] == delays
    assert 4.0 <= delays[0] <= 5.0 and 8.0 <= delays[1] <= 10.0
    assert 10.0 <= delays[2] <= 12.5 and 10.0 <= delays[3] <= 12.5  # capped base
    assert res.RetryPolicy(backoff_ms=0.0).delay_ms(3) == 0.0


# ---------------------------------------------------------------------------
# ladder
# ---------------------------------------------------------------------------
LADDER_SCRIPT = [
    ("fault", "captured", ("decode", 1, 2, 4)), ("end",),
    ("fault", "captured", ("decode", 1, 2, 4)), ("end",),
    ("fault", "captured", ("prefill", 1, 8, 2)), ("fault", "lazy", None),
    ("fault", "per_op", None), ("end",), ("fault", "lazy", None), ("end",),
] + [("end",)] * 9 + [("fault", "captured", ("decode", 1, 2, 4))] * 3 + [("end",)] * 4


def _run_ladder(ladder):
    states = []
    for op in LADDER_SCRIPT:
        if op[0] == "fault":
            ladder.record_fault(op[1], key=op[2])
        else:
            ladder.step_end()
        states.append(ladder.state())
        states.append([ladder.allows(t, k) for t in ("captured", "lazy", "per_op")
                       for k in (None, ("decode", 1, 2, 4))])
    return states


def test_ladder_state_matches_jax():
    ours = _run_ladder(res.DegradationLadder(res.LadderPolicy(2, 3)))
    theirs = _run_ladder(jres.DegradationLadder(jres.LadderPolicy(2, 3)))
    assert ours == theirs
    c, jc = prof.dispatch_counters(), jprof.dispatch_counters()
    assert (c["ladder_demotions"], c["ladder_promotions"]) == \
        (jc["ladder_demotions"], jc["ladder_promotions"])
    assert c["ladder_demotions"] >= 2 and c["ladder_promotions"] >= 2
    acts = [e.attrs["action"] for e in trace.events(kind="ladder")]
    assert acts.count("demote") == c["ladder_demotions"]
    assert acts.count("promote") == c["ladder_promotions"]


def test_ladder_policy_reads_flags_live():
    pol = res.LadderPolicy()
    pt.set_flags({"FLAGS_ladder_demote_after": 5})
    try:
        assert pol.demote_after == 5 and pol.cooldown_steps == 8
    finally:
        pt.set_flags({"FLAGS_ladder_demote_after": 2})
    assert res.LadderPolicy(1, 1).demote_after == 1


# ---------------------------------------------------------------------------
# runtime.execute
# ---------------------------------------------------------------------------
COUNTERS = ("fault_events", "injected_faults", "transient_faults", "fatal_faults",
            "retry_attempts", "retry_exhausted", "ladder_demotions")


def _drive(mod, pkg_flags, spec, steps=8):
    """Drive ``mod.execute`` through ``steps`` step boundaries at three
    sites; returns each call's outcome."""
    pkg_flags({"FLAGS_fault_inject": spec, "FLAGS_retry_backoff_ms": 0.0})
    out = []
    for step in range(steps):
        for site, key in (("optimizer", None), ("decode", ("decode", 1, 2, 4)), ("op", None)):
            try:
                out.append(mod.execute(site, lambda: step, ladder_key=key,
                                       retry_unsafe=site == "decode"))
            except Exception as e:  # noqa: BLE001 - the outcome is the data
                out.append(type(e).__name__)
        mod.on_step_end()
    return out


@pytest.mark.parametrize("spec", ["execute:p=0.3", "execute:p=1:x=3:decode",
                                  "execute:p=1:x=2:optimizer,hang:p=0.5:op"])
def test_execute_counts_match_jax(spec):
    ours = _drive(res, pt.set_flags, spec)
    theirs = _drive(jres, paddle.set_flags, spec)
    assert ours == theirs
    c, jc = prof.dispatch_counters(), jprof.dispatch_counters()
    assert {k: c[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    assert dict(c["fault_sites"]) == dict(jc["fault_sites"])
    assert c["injected_faults"] > 0
    assert res.state()["ladder"] == jres.state()["ladder"]


def test_execute_fast_path_counts_nothing():
    assert res.execute("op", lambda: 3) == 3
    c = prof.dispatch_counters()
    assert all(c[k] == 0 for k in COUNTERS)


def test_execute_retries_real_transient_fault():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: link flapped")
        return "ok"

    pt.set_flags({"FLAGS_retry_backoff_ms": 0.0})
    assert res.execute("op", flaky) == "ok"
    c = prof.dispatch_counters()
    assert len(calls) == 3 and c["retry_attempts"] == 2 and c["transient_faults"] == 2
    assert c["injected_faults"] == 0 and c["retry_exhausted"] == 0


def test_retry_unsafe_real_fault_is_never_rerun():
    calls = []

    def writes_in_place():
        calls.append(1)
        raise RuntimeError("UNAVAILABLE: failed after the launch")

    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        res.execute("decode", writes_in_place, ladder_key="k", retry_unsafe=True)
    assert len(calls) == 1
    c = prof.dispatch_counters()
    assert c["retry_attempts"] == 0 and c["fault_events"] == 1
    assert res.degradation_ladder().state()["faults"] == {"captured[k]": 1}


def test_retry_unsafe_still_retries_injected_faults():
    pt.set_flags({"FLAGS_fault_inject": "execute:p=1:x=2:optimizer",
                  "FLAGS_retry_backoff_ms": 0.0})
    calls = []
    assert res.execute("optimizer", lambda: calls.append(1) or 7, retry_unsafe=True) == 7
    assert len(calls) == 1  # the thunk ran once, after two injected faults
    assert prof.dispatch_counters()["retry_attempts"] == 2


def test_fatal_and_passthrough_errors():
    with pytest.raises(ValueError):
        res.execute("op", lambda: (_ for _ in ()).throw(ValueError("shape")))
    c = prof.dispatch_counters()
    assert c["fatal_faults"] == 1 and c["retry_attempts"] == 0
    with pytest.raises(FloatingPointError):
        res.execute("op", lambda: (_ for _ in ()).throw(FloatingPointError("nan")))
    assert prof.dispatch_counters()["fault_events"] == 1  # passed through, unrecorded
    with pytest.raises(res.Preempted):
        res.execute("op", lambda: (_ for _ in ()).throw(res.Preempted(signal.SIGTERM, 3)))


def test_on_step_end_advances_step_ladder_and_heartbeat():
    res.degradation_ladder().record_fault("captured", "k")
    res.degradation_ladder().record_fault("captured", "k")
    assert not res.runtime.captured_tier_ok("k")
    for _ in range(8):  # the faulted step, then 7 of the 8 clean ones
        res.on_step_end(source="serve[test]")
    assert not res.runtime.captured_tier_ok("k")
    res.on_step_end(source="serve[test]")
    assert res.current_step() == 9
    assert res.runtime.captured_tier_ok("k")
    assert trace.heartbeat_age_ms("serve[test]") is not None
    st = res.state()
    assert st["step"] == 9 and st["ladder"]["demoted"] == []
    res.reset()
    assert res.current_step() == 0


def test_public_surface():
    for name in ("parse_fault_spec", "FaultPlan", "is_transient", "RetryPolicy",
                 "DegradationLadder", "execute", "on_step_end", "state", "reset",
                 "Preempted", "PreemptionGuard"):
        assert hasattr(res, name), name
    assert set(jres.__all__) <= set(res.__all__)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------
class _Checkpointer:
    def __init__(self):
        self.calls = []

    def emergency_save(self, step, state):
        self.calls.append(("emergency_save", step, dict(state)))

    def wait(self):
        self.calls.append(("wait",))


def test_preemption_guard_sigterm_emergency_save(tmp_path):
    assert threading.current_thread() is threading.main_thread()
    pt.set_flags({"FLAGS_postmortem_dir": str(tmp_path)})
    ck = _Checkpointer()
    done = []
    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(res.Preempted) as ei:
        with res.PreemptionGuard(ck, {"w": 1}) as guard:
            for step in range(6):
                done.append(step)
                if step == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                guard.step_boundary(step)
    assert signal.getsignal(signal.SIGTERM) is prev  # uninstalled on exit
    assert done == [0, 1, 2] and ei.value.step == 2 and ei.value.code == 128 + signal.SIGTERM
    assert isinstance(ei.value, SystemExit) and "SIGTERM" in str(ei.value)
    assert ck.calls == [("emergency_save", 2, {"w": 1}), ("wait",)]
    c = prof.dispatch_counters()
    assert c["preemptions"] == 1 and c["emergency_saves"] == 1
    assert [e.attrs["signum"] for e in trace.events(kind="preempt")] == [signal.SIGTERM]
    doc = trace.read_postmortem(trace.last_postmortem_path())
    assert doc["reason"] == "preempted" and doc["exception"]["type"] == "Preempted"


def test_preemption_guard_plain_save_and_on_preempt():
    class Plain:
        def __init__(self):
            self.calls = []

        def save(self, step, state):
            self.calls.append(("save", step))

        def wait(self):
            self.calls.append(("wait",))

    seen, ck = [], Plain()
    guard = res.PreemptionGuard(on_preempt=seen.append)
    guard.bind(ck, {"w": 2})
    guard.step_boundary(0)  # no signal: nothing happens
    guard._handler(signal.SIGINT, None)
    with pytest.raises(res.Preempted):
        guard.step_boundary(1)
    assert seen == [1] and ck.calls == [("save", 1), ("wait",)]


# ---------------------------------------------------------------------------
# the flight recorder, postmortems and the stall watchdog
# ---------------------------------------------------------------------------
def test_trace_ring_filters_resizes_and_turns_off():
    trace.emit("fault", site="op", error="X")
    trace.emit("serve", site="engine", phase="admit", rid=1)
    trace.emit("serve", site="engine", phase="complete", rid=1)
    assert [e.kind for e in trace.events()] == ["fault", "serve", "serve"]
    assert len(trace.events(kind="serve")) == 2 and len(trace.events(last=1)) == 1
    assert trace.events(kind="serve", last=1)[0].attrs["phase"] == "complete"
    assert trace.events()[0].step == res.current_step()
    pt.set_flags({"FLAGS_trace_ring_size": 2})
    trace.emit("ladder", site="captured")
    assert [e.kind for e in trace.events()] == ["serve", "ladder"]  # carried over, bounded
    pt.set_flags({"FLAGS_trace_ring_size": 0})
    assert trace.emit("fault") is None and not trace.enabled()
    pt.set_flags({"FLAGS_trace_ring_size": 4096})
    d = trace.events()[-1].as_dict()
    assert d["kind"] == "ladder" and abs(d["ts"] - time.time()) < 60


def test_chrome_trace_request_lanes():
    trace.emit("serve", site="engine", phase="reject", rid=9)  # no admit: instant
    trace.emit("serve", site="engine", phase="admit", rid=1)
    trace.emit("serve", site="engine", phase="decode", rids=(1,))
    trace.emit("serve", site="engine", phase="complete", rid=1)
    trace.emit("serve", site="engine", phase="health", state="ready")
    trace.emit("retry", site="op", attempt=1)
    evs = trace.chrome_trace_events()
    assert [(e["name"], e["ph"]) for e in evs] == [
        ("serve:reject", "i"), ("request", "b"), ("request", "n"), ("request", "e"),
        ("serve:health", "i"), ("retry:op", "i")]
    assert json.dumps(evs)  # serializable


def test_postmortem_dump_contents_and_pruning(tmp_path):
    assert trace.dump_postmortem("x") is None  # off by default
    pt.set_flags({"FLAGS_postmortem_dir": str(tmp_path), "FLAGS_postmortem_keep": 2})
    try:
        prof.count("retry_attempts", 3)
        trace.emit("fault", site="op")
        paths = [trace.dump_postmortem("unit", exc=RuntimeError(f"boom {i}"), i=i)
                 for i in range(4)]
    finally:
        pt.set_flags({"FLAGS_postmortem_keep": 32})
    left = sorted(p for p in os.listdir(tmp_path) if p.endswith(".json"))
    assert left == sorted(os.path.basename(p) for p in paths[-2:])
    assert prof.dispatch_counters()["postmortems_pruned"] == 2
    doc = trace.read_postmortem(paths[-1])
    assert doc["reason"] == "unit" and doc["attrs"] == {"i": 3}
    assert doc["exception"]["message"] == "boom 3" and doc["exception"]["traceback"]
    assert doc["metrics"]["counters"]["retry_attempts"] == 3
    assert doc["memory"] is None  # no CUDA in this process
    assert doc["resilience"]["retry_max"] == 2
    # the attribution layer's triage section (profiler.attribution)
    assert set(doc["attribution"]) == {"programs", "telemetry", "batch"}
    assert any(e["kind"] == "fault" for e in doc["events"])


def test_stall_watchdog_trips_listeners_once_per_episode(tmp_path):
    pt.set_flags({"FLAGS_trace_stall_ms": 40.0, "FLAGS_postmortem_dir": str(tmp_path)})
    trips = []
    listener = trips.append
    trace.add_stall_listener(listener)
    try:
        before = trace.stall_count()
        trace.step_heartbeat("train[test]")
        time.sleep(0.25)
        assert trace.stall_count() == before + 1 and len(trips) == 1  # one per episode
        assert trips[0] >= 40.0
        assert trace.heartbeat_age_ms("train[test]") >= 200
        trace.watchdog_disarm("train[test]")
        assert trace.heartbeat_age_ms("train[test]") is None
    finally:
        trace.remove_stall_listener(listener)
        pt.set_flags({"FLAGS_trace_stall_ms": 0.0})
    stalls = [e for e in trace.events(kind="stall") if e.attrs["source"] == "train[test]"]
    assert len(stalls) == 1
    doc = trace.read_postmortem(sorted(tmp_path.iterdir())[-1])
    assert doc["reason"] == "stall" and doc["memory"] is None


# ---------------------------------------------------------------------------
# the optimizer step boundary: execute("optimizer") and nan:grads
# ---------------------------------------------------------------------------
def _adam_run(spec, poison_by_hand):
    """Five f32 Adam steps of a small MLP through the fused update's plain
    versions, rescue 'skip', poisoning the first gradient at step 2 by hand
    or through ``spec``. Returns the losses, the params and the states."""
    pt.set_flags({"FLAGS_pallas_fused_update": True, "FLAGS_numeric_rescue": "skip",
                  "FLAGS_retry_backoff_ms": 0.0})
    res.reset()
    pt.set_flags({"FLAGS_fault_inject": spec})
    pt.resilience.rescue.reset_counters()
    gen = torch.Generator().manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Tanh(), torch.nn.Linear(32, 4))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x = torch.randn(8, 16, generator=gen)
    y = torch.randn(8, 4, generator=gen)
    opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=list(net.parameters()),
                            weight_decay=pt.regularizer.L2Decay(0.01))
    losses = []
    for step in range(5):
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        if poison_by_hand and step == 2:
            next(net.parameters()).grad.fill_(float("nan"))
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    pt.set_flags({"FLAGS_fault_inject": ""})
    states = [{k: v.clone() for k, v in opt._accumulators[id(p)].items()}
              for p in net.parameters()]
    return losses, [p.detach().clone() for p in net.parameters()], states


def test_adam_step_under_optimizer_fault_and_nan_grads_bitwise():
    clean = _adam_run("", poison_by_hand=True)
    assert pt.resilience.rescue.counters["numeric_rescues"] == 1
    prof.reset_dispatch_counters()
    faulted = _adam_run("execute:optimizer:p=1:x=1,nan:grads:step=2", poison_by_hand=False)
    c = prof.dispatch_counters()
    assert c["retry_attempts"] == 5  # one injected fault per step, retried
    assert c["injected_faults"] == 6  # ... plus the poisoned gradient
    assert dict(c["fault_sites"]) == {"optimizer": 5}
    assert pt.resilience.rescue.counters["numeric_rescues"] >= 1
    assert faulted[0] == clean[0]
    for a, b in zip(faulted[1], clean[1]):
        assert torch.equal(a, b)
    for sa, sb in zip(faulted[2], clean[2]):
        assert sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert res.current_step() == 5  # step() ends at the resilience boundary


def test_optimizer_real_fault_after_launch_is_not_rerun(monkeypatch):
    from paddle_tpu_torch.optimizer import optimizer as topt

    net = torch.nn.Linear(4, 2)
    opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=list(net.parameters()))
    ((net(torch.ones(3, 4))) ** 2).sum().backward()
    calls = []
    real = topt.make_fused_update

    def half_applied(*a, **k):
        fn = real(*a, **k)

        def apply(*args):
            calls.append(1)
            fn(*args)
            raise RuntimeError("UNAVAILABLE: fault after the in-place update")
        return apply

    monkeypatch.setattr(topt, "make_fused_update", half_applied)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        opt.step()
    assert calls == [1]  # transient, but never re-run over half-written state
    assert res.current_step() == 1  # the boundary still ticked
    assert prof.dispatch_counters()["retry_attempts"] == 0


def test_rescue_emits_event_and_postmortem(tmp_path):
    pt.set_flags({"FLAGS_postmortem_dir": str(tmp_path)})
    _adam_run("", poison_by_hand=True)
    evs = trace.events(kind="rescue")
    assert [(e.site, e.attrs["policy"], e.step) for e in evs] == [
        ("optimizer", "skip", 2)]
    dumps = [p for p in os.listdir(tmp_path) if "numeric_rescue" in p]
    assert len(dumps) == 1
    doc = trace.read_postmortem(os.path.join(tmp_path, dumps[0]))
    assert doc["attrs"] == {"policy": "skip", "step": 2}


def test_abort_message_names_the_runtime_step():
    pt.set_flags({"FLAGS_numeric_rescue": "abort"})
    opt = pt.optimizer.SGD(parameters=[torch.zeros(2, requires_grad=True)])
    for _ in range(3):
        res.on_step_end()
    with pytest.raises(FloatingPointError, match=r"step 3\): numeric_rescue=abort"):
        pt.resilience.rescue.handle_sentinel(opt, torch.tensor(True))
