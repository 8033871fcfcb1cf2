"""The attribution layer of the port (``paddle_tpu_torch/profiler/
attribution.py``), its fused numerics telemetry and the analysis IR and
memory plan under it, against the JAX package.

- The reference's ``tests/test_attribution.py`` runs here with ``paddle``
  bound to the port, at its own assertions: the registry's keys by
  category (op, segment, captured, accum, serve, step), zero extra programs
  with telemetry at the per-op, lazy (3) and captured (1) tiers, bitwise
  steps with telemetry on and off, the telemetry gauges and events, the
  sentinel-trip and nan-rescue postmortems' triage, sample-id recovery
  through ``GlobalStepSampler``, ``/programz`` and the chrome counter lanes.
  The nan-rescue case reads the port's rescue counter
  (``resilience.rescue.counters``; the JAX package keeps it among the
  dispatch counters). Not run here: the static-profile case, which names
  the JAX IR's op (``dot_general``; held below against analytic counts),
  and the fleet table of ``distributed.fleet.obs`` (item 13).
- ``make_fused_update(telemetry=True)``'s rows against the reference's for
  Adam, Momentum, SGD and AdamW, kernel and rule paths, with the sentinel
  clear and set, within rtol 1e-5 (f32 sums in another order).
- ``record_telemetry`` on the same ``(n, 3)`` arrays gives equal group
  states; the one-step-late read, once flushed, gives the reference's
  history.
- The static profile of a small MLP step: its matmul FLOPs are 2·M·N·K
  exactly; ``analysis.memory.plan_memory`` on a hand-built program gives
  the hand-computed peak.
"""
import functools
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.profiler.attribution as jattr
import paddle_tpu_torch as tp
import paddle_tpu_torch.profiler as tprof
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import memory as tmem
from paddle_tpu_torch.core import lazy as tlazy
from paddle_tpu_torch.profiler import attribution as tattr
from tests import torch_ref_port

_RESCUE = [(
    '''    from paddle_tpu.io import GlobalStepSampler

    _set_tier("per_op")''',
    '''    from paddle_tpu_torch.io import GlobalStepSampler
    from paddle_tpu_torch.resilience import rescue as _rescue

    _rescue.reset_counters()
    _set_tier("per_op")'''), (
    '''    assert prof.dispatch_counters()["numeric_rescues"] == 1''',
    '''    assert _rescue.counters["numeric_rescues"] == 1''')]
globals().update(torch_ref_port.collect(
    torch_ref_port.load("test_attribution.py", edits=_RESCUE), "ref",
    skip=("static_profile_flops_top_ops_and_peak", "fleet_programs_merges_and_ranks")))


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


# ---------------------------------------------------------------------------
# telemetry rows against the reference's
# ---------------------------------------------------------------------------
SHAPES = [(7,), (4, 5), (3, 2, 4)]
RULES = {
    "adam": lambda pkg, ps: pkg.optimizer.Adam(learning_rate=0.01, parameters=ps),
    "adam_l2": lambda pkg, ps: pkg.optimizer.Adam(learning_rate=0.01, parameters=ps,
                                                  weight_decay=0.01),
    "momentum": lambda pkg, ps: pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                                       parameters=ps, weight_decay=0.001),
    "nesterov": lambda pkg, ps: pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                                       use_nesterov=True, parameters=ps),
    "sgd": lambda pkg, ps: pkg.optimizer.SGD(learning_rate=0.1, parameters=ps),
    "adamw": lambda pkg, ps: pkg.optimizer.AdamW(learning_rate=0.01, parameters=ps,
                                                 weight_decay=0.05),
}


def _arrays(seed, nan):
    rng = np.random.default_rng(seed)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    if nan:
        gs[1].reshape(-1)[3] = np.nan
    return ps, gs


@functools.lru_cache(maxsize=None)
def _jax_case(rule, case):
    """The reference's rows and updated parameters, once per rule and case."""
    ps, gs = _arrays(len(rule), nan=case == "set")
    return _jax_rows(rule, ps, gs, case == "set")


def _jax_rows(rule, ps, gs, sentinel):
    from paddle_tpu.optimizer.optimizer import make_fused_update

    params = [jp.to_tensor(p, stop_gradient=False) for p in ps]
    opt = RULES[rule](jp, params)
    states = [opt._create_state(p) for p in params]
    out = make_fused_update(opt, params, sentinel=sentinel, telemetry=True)(
        [p._value for p in params], [jp.to_tensor(g)._value for g in gs],
        np.float32(opt.get_lr()), states)
    return np.asarray(out[-1]), [np.asarray(p) for p in out[0]]


def _port_rows(rule, ps, gs, sentinel, fused):
    from paddle_tpu_torch.optimizer.optimizer import make_fused_update

    tp.set_flags({"FLAGS_pallas_fused_update": fused})
    try:
        params = [torch.tensor(p, requires_grad=True) for p in ps]
        opt = RULES[rule](tp, params)
        states = [opt._state_of(p) for p in params]
        with torch.no_grad():
            bad, tele = make_fused_update(opt, params, sentinel=sentinel, telemetry=True)(
                params, [torch.tensor(g) for g in gs],
                torch.tensor(opt.get_lr(), dtype=torch.float32), states)
    finally:
        tp.set_flags({"FLAGS_pallas_fused_update": False})
    return tele.numpy(), [p.detach().numpy() for p in params], bad


@pytest.mark.parametrize("fused", [False, True], ids=["rule", "kernel"])
@pytest.mark.parametrize("case", ["clear", "set"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_telemetry_rows_match_the_reference(rule, case, fused):
    ps, gs = _arrays(len(rule), nan=case == "set")
    sentinel = case == "set"
    jrows, _ = _jax_case(rule, case)
    trows, tnew, bad = _port_rows(rule, ps, gs, sentinel, fused)
    assert trows.shape == (len(SHAPES), 3) and trows.dtype == np.float32
    np.testing.assert_allclose(trows, jrows, rtol=1e-5, atol=0)
    if sentinel:
        assert bool(bad)
        np.testing.assert_array_equal(trows[:, 2], 0.0)  # a gated step applies nothing
        for a, p in zip(tnew, ps):
            np.testing.assert_array_equal(a, p)


def test_mixed_kernel_and_rule_rows_keep_the_parameters_order():
    """A non-contiguous parameter leaves the kernel route for the rule's
    torch ops; the rows of both routes come back in the parameters' order,
    as the reference's (Adam, kernel flag on)."""
    from paddle_tpu_torch.optimizer.optimizer import make_fused_update

    ps, gs = _arrays(9, nan=False)
    jrows, _ = _jax_rows("adam", ps, gs, False)
    tp.set_flags({"FLAGS_pallas_fused_update": True})
    try:
        params = [torch.tensor(p, requires_grad=True) for p in ps]
        strided = torch.empty(ps[1].shape[::-1]).t()  # the same shape, not contiguous
        strided.copy_(torch.tensor(ps[1]))
        params[1] = strided.requires_grad_()
        opt = RULES["adam"](tp, params)
        states = [opt._state_of(p) for p in params]
        with torch.no_grad():
            _, tele = make_fused_update(opt, params, telemetry=True)(
                params, [torch.tensor(g) for g in gs], torch.tensor(0.01), states)
    finally:
        tp.set_flags({"FLAGS_pallas_fused_update": False})
    np.testing.assert_allclose(tele.numpy(), jrows, rtol=1e-5, atol=0)


def test_kernel_route_partials_sum_over_blocks():
    """The kernel wrappers take the parameter's (blocks, 3) partial sums; on
    the CPU the plain version writes row 0, and the applier's sum over the
    blocks gives the rows."""
    from paddle_tpu_torch.ops.kernels import fused_update as fu

    assert fu.telemetry_blocks("cpu") == 1
    p = torch.tensor([1.0, 2.0, -1.0])
    g = torch.tensor([0.5, -0.5, 1.0])
    old = p.clone()
    tele = torch.zeros(3, 3)
    fu.fused_sgd(p, g, torch.tensor(0.1), wd=0.0, tele=tele[1:2])
    np.testing.assert_allclose(tele.sum(0).numpy(),
                               fu.telemetry_plain(g, old, p).numpy(), rtol=0)


# ---------------------------------------------------------------------------
# the host record and the lagged read
# ---------------------------------------------------------------------------
def _state(attr):
    """The telemetry state as JSON text (NaN included), without the host
    cost."""
    st = attr.telemetry_state()
    st.pop("record_cost_ms")
    st.pop("enabled")
    return json.dumps(st, sort_keys=True)


def test_record_telemetry_gives_equal_group_states():
    rng = np.random.default_rng(11)
    names = ["linear_0", "linear_0", "linear_1", "norm", "norm"]
    jattr.reset()
    tattr.reset()
    try:
        for step in range(12):
            arr = rng.uniform(0.1, 2.0, (5, 3))
            if step == 8:
                arr[2, 0] *= 1e4  # a spike
            if step == 10:
                arr[3, 0] = np.nan
            jattr.record_telemetry(names, arr, step=step)
            tattr.record_telemetry(names, torch.tensor(arr),
                                   step=step)
        assert _state(tattr) == _state(jattr)
        assert tattr.telemetry_state()["groups"]["linear_1"]["spikes"] == 1
    finally:
        jattr.reset()
        tattr.reset()


def _telemetry_history(pkg, attr, monkeypatch, steps=5):
    """The (step, rows) of every record of a per-op SGD MLP run with
    FLAGS_telemetry on; the port's reads are one step late, so its
    history is complete after ``flush_telemetry``."""
    seen = []
    real = attr.record_telemetry

    def capture(names, tele, step=None):
        rows = tele.detach().numpy() if hasattr(tele, "detach") else np.asarray(tele)
        seen.append((attr._current_step() if step is None else step,
                     np.array(rows, dtype=np.float64)))
        return real(names, tele, step)

    monkeypatch.setattr(attr, "record_telemetry", capture)
    pkg.set_flags({"FLAGS_telemetry": True, "FLAGS_eager_lazy_dispatch": False})
    try:
        model = pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(), pkg.nn.Linear(16, 4))
        rng = np.random.default_rng(7)
        for p in model.parameters():  # the same weights in both packages
            p.set_value(rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.3)
        opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
        for _ in range(steps):
            x = pkg.to_tensor(rng.standard_normal((4, 8)).astype(np.float32))
            y = pkg.to_tensor(rng.integers(0, 4, (4,)))
            loss = pkg.nn.CrossEntropyLoss()(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        pending = len(seen)
        if hasattr(attr, "flush_telemetry"):
            attr.flush_telemetry()
    finally:
        pkg.set_flags({"FLAGS_telemetry": False})
        attr.reset()
    return pending, seen


def test_lagged_history_matches_the_reference_once_flushed(monkeypatch):
    jpending, jseen = _telemetry_history(jp, jattr, monkeypatch)
    tpending, tseen = _telemetry_history(tp, tattr, monkeypatch)
    assert jpending == 5 and tpending == 4  # the port's last step waits for the flush
    # the same steps (each package's step clock starts elsewhere)
    assert [s - tseen[0][0] for s, _ in tseen] == [s - jseen[0][0] for s, _ in jseen]
    for (_, t), (_, j) in zip(tseen, jseen):
        np.testing.assert_allclose(t, j, rtol=1e-5)


def test_triage_section_has_the_reference_keys():
    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    jattr.reset()
    tattr.reset()
    assert keys(tattr.triage_section()) == keys(jattr.triage_section())


# ---------------------------------------------------------------------------
# the static profile and the memory plan
# ---------------------------------------------------------------------------
def test_static_profile_counts_matmul_flops_exactly():
    tlazy.reset_lazy_state()
    tprof.reset_dispatch_counters()
    tattr.reset()
    tp.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_step_capture": True})
    try:
        tp.seed(0)
        b, d_in, d_hid, d_out = 4, 8, 16, 4
        model = tp.nn.Sequential(tp.nn.Linear(d_in, d_hid), tp.nn.ReLU(),
                                 tp.nn.Linear(d_hid, d_out))
        opt = tp.optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
        x = tp.to_tensor(np.ones((b, d_in), np.float32))
        y = tp.to_tensor(np.zeros((b,), np.int64))
        for _ in range(5):
            loss = tp.nn.CrossEntropyLoss()(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        tlazy.flush_if_pending("test")
        (key,) = [k for k in tattr.program_costs(static=False) if k.startswith("captured:")]
        row = tattr.program_costs(top_k=3)[key]
        program = tlazy.captured_step_ir()
    finally:
        tp.set_flags({"FLAGS_eager_lazy_dispatch": False})
        tlazy.reset_lazy_state()
        tattr.reset()
    # forward: x·W1, h·W2; backward: dW2 = hᵀ·dy, dh = dy·W2ᵀ, dW1 = xᵀ·dh
    # (x needs no gradient)
    mm = 2 * b * d_in * d_hid + 2 * b * d_hid * d_out
    mm += 2 * d_hid * b * d_out + 2 * b * d_out * d_hid + 2 * d_in * b * d_hid
    assert analysis.matmul_flops(program) == mm
    assert row["top_ops"][0] == {"op": "mm", "flops_est": mm, "count": 5}
    assert row["flops_est"] > mm and row["bytes_est"] > 0 and row["eqns"] == len(program.ops)
    assert row["est_peak_hbm_mb"] > 0 and row["donated"] == 4 + 4 * 4  # params + Adam states


def test_plan_memory_of_a_hand_built_program():
    """in (4 KiB, written in place) → a (1 KiB) → b (2 KiB) → c (512 B,
    escapes); a dies at b, b at c. Live sums: entry 4096, op0 5120, op1
    7168, op2 6656 (a gone), exit 4608. The no-donation plan charges the
    in-place write at op2 another 4096."""
    V = analysis.Value
    values = {0: V(0, (1024,), "torch.float32", 4096, -1, written=True),
              1: V(1, (256,), "torch.float32", 1024, 0),
              2: V(2, (512,), "torch.float32", 2048, 1),
              3: V(3, (128,), "torch.float32", 512, 2)}
    ops = [analysis.Op(0, "a", (0,), (1,), (), (), 0, 0),
           analysis.Op(1, "b", (1,), (2,), (), (), 0, 0),
           analysis.Op(2, "c", (2, 0), (3, 0), (), (), 0, 0)]
    plan = tmem.plan_memory(analysis.Program(ops, values, escaping=[0, 3]))
    assert (plan.peak_bytes, plan.peak_index) == (7168, 1)
    assert plan.peak_no_donation_bytes == 6656 + 4096
    assert plan.donation_credit_bytes == 6656 + 4096 - 7168
    assert plan.boundary_bytes == 4096 + 512
    diags = analysis.check(analysis.Program(ops, values, escaping=[0, 3]),
                           memory_budget_mb=0.005)
    assert [d.severity for d in diags] == [analysis.Severity.ERROR, analysis.Severity.INFO]


def test_check_records_a_layer_and_refuses_static_programs():
    layer = tp.nn.Linear(8, 4)
    diags = analysis.check(layer, [((2, 8), "float32")], memory_budget_mb=64)
    (info,) = diags
    assert info.pass_name == "memory_budget" and info.data["peak_bytes"] > 0
    # the JAX package's registry order, without its three mesh passes (item 13)
    assert analysis.pass_names() == [
        "dtype_check", "dead_code", "redundant_ops", "numeric_hazards", "launch_budget",
        "determinism", "memory_budget", "donation_safety", "equivalence"]

    class Program:  # what a static.Program looks like to check()
        pass

    with pytest.raises(NotImplementedError, match="item 14"):
        analysis.check(Program())
