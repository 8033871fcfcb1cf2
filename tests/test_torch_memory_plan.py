"""The port's memory plan (``paddle_tpu_torch/analysis/{memory,plan}.py``)
against the JAX package's, on the CPU.

  - The remat plan, after ``tests/test_memory_plan2.py:119-250``: a 2-layer
    narrow GPT, weights carried from the JAX model by
    ``convert.state_dict_from_numpy``. The JAX planned step is bitwise its
    unplanned step (that test file asserts it, :171), so the JAX unplanned
    step stands for it: the port's planned ``compile_train_step`` is within
    the training tolerance of it, and bitwise the port's own unplanned step.
    The plan is feasible (its peak, and the planned step's recorded peak,
    under the budget), a stale plan falls back counted, ``"auto"`` plans and
    applies, and the whole-step capture under FLAGS_memory_plan='auto' is
    bitwise eager and keys its cache on the plan flags.
  - Liveness and donation, after ``tests/test_memory_plan.py:96-481``: the
    same golden bytes, the budget pass, the donation_safety verdicts, the
    tied-buffer and live-alias scans, the gates of the capture and of
    ``compile_train_step``.
  - The KV block pool: the ``(budget - overhead) // block_bytes`` rule, the
    engine's planner-sized pool and its "no room" error, and the port's
    overhead against the JAX planner's.

Where the installed jax cannot build the JAX package's analysis IR (jax 0.9
dropped ``jax.core.Literal``), comparisons that need it hold the port to
what the JAX tests assert instead.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.profiler as prof
from paddle_tpu_torch import analysis, jit, nn
from paddle_tpu_torch.analysis import ProgramVerificationError, Severity
from paddle_tpu_torch.analysis import memory as mem
from paddle_tpu_torch.analysis import plan as plan_mod
from paddle_tpu_torch.core import lazy

MB = 1 << 20
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32,
           dropout=0.0, attn_dropout=0.0)
# f32 on the CPU, as tests/test_torch_train.py states it: the two frameworks
# order matmul, softmax and reduction sums differently (~1e-7 relative an
# op), so losses of order 5 agree to ~1e-6 and parameters after 3 AdamW
# steps of 1e-3 to ~1e-6
TOL_LOSS = dict(atol=1e-5, rtol=1e-6)
TOL_PARAM = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    """The CPU for this file's tests, the caller's device after them; the
    donation gate's info findings, a warning each, are not this file's."""
    was = pt.get_device()
    pt.set_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    pt.set_device(was)


def hits(diags, pass_name, severity=None, needle=None):
    out = [d for d in diags if d.pass_name == pass_name]
    if severity is not None:
        out = [d for d in out if int(d.severity) == int(severity)]
    if needle is not None:
        out = [d for d in out if needle in d.message or needle in d.op or needle in d.hint]
    return out


# ---------------------------------------------------------------------------
# the remat plan
# ---------------------------------------------------------------------------
def _gpt(recompute=False, weights=None):
    from paddle_tpu_torch.convert import state_dict_from_numpy
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTPretrainingCriterion)

    pt.seed(0)
    cfg = GPTConfig(**CFG, use_recompute=recompute)
    m = GPTForPretraining(cfg, device="cpu")
    if weights is not None:
        state_dict_from_numpy(m, weights)
    opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters(), weight_decay=0.01)
    return m, GPTPretrainingCriterion(cfg), opt


def _batches(n=3):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, CFG["vocab_size"], (n, 4, CFG["max_seq_len"] + 1))
    return [(ids[i, :, :-1], ids[i, :, 1:]) for i in range(n)]


def _train(step, n=3):
    return [float(step(torch.tensor(x), torch.tensor(y))) for x, y in _batches(n)]


@pytest.fixture(scope="module")
def jax_weights():
    """The JAX GPT's weights and its compiled unplanned step's losses over
    the batches. The JAX step takes the dense attention path: its flash
    kernel in Pallas interpret mode compiles for ~15 s on the CPU, and the
    two paths compute the same function to ~1e-7 relative, far inside the
    tolerance (the port's step runs its flash kernel's plain version)."""
    import paddle_tpu as paddle
    from paddle_tpu import jit as jjit
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu.parallel.topology import use_mesh

    flash = paddle.get_flags(["FLAGS_use_flash_attention"])["FLAGS_use_flash_attention"]
    paddle.set_flags({"FLAGS_use_flash_attention": False})
    try:
        with use_mesh(None):
            paddle.seed(0)
            cfg = jgpt.GPTConfig(**CFG)
            jm = jgpt.GPTForPretraining(cfg)
            weights = {k: v.numpy() for k, v in jm.state_dict().items()}
            jo = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                                        weight_decay=0.01)
            step = jjit.compile_train_step(jm, jgpt.GPTPretrainingCriterion(cfg), jo)
            losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
                      for x, y in _batches()]
            params = [p.numpy() for p in jm.parameters()]
    finally:
        paddle.set_flags({"FLAGS_use_flash_attention": flash})
    return weights, losses, params


@pytest.fixture(scope="module")
def planned(jax_weights):
    """The unplanned port step, the uniform (use_recompute) one, a plan at a
    budget halfway between their peaks, and the planned step."""
    weights = jax_weights[0]
    m0, c0, o0 = _gpt(weights=weights)
    s0 = jit.compile_train_step(m0, c0, o0)
    l0 = _train(s0)
    peak0 = s0.memory_plan().peak_bytes
    mu, cu, ou = _gpt(recompute=True, weights=weights)
    su = jit.compile_train_step(mu, cu, ou)
    _train(su, 1)
    peak_u = su.memory_plan().peak_bytes
    budget_mb = (peak0 + peak_u) / 2 / MB
    plan = s0.plan_remat(budget_mb=budget_mb)
    m1, c1, o1 = _gpt(weights=weights)
    s1 = jit.compile_train_step(m1, c1, o1, memory_plan=plan)
    l1 = _train(s1)
    return dict(m0=m0, l0=l0, peak0=peak0, peak_u=peak_u, budget_mb=budget_mb, plan=plan,
                m1=m1, s1=s1, l1=l1)


def test_plan_is_feasible_and_cheaper_than_uniform(planned):
    plan = planned["plan"]
    assert planned["peak_u"] < planned["peak0"]
    assert plan.has_cuts and plan.feasible, plan.summary()
    assert plan.peak_after_bytes <= planned["budget_mb"] * MB
    assert plan.peak_after_bytes < plan.peak_before_bytes == planned["peak0"]
    assert 0 < plan.recompute_flops < plan.full_remat_flops and plan.recompute_pct < 100
    d = plan.to_dict()
    for key in ("source", "n_eqns", "stages", "cut_points", "budget_mb", "peak_before_mb",
                "peak_after_mb", "recompute_flops", "full_remat_flops", "recompute_pct",
                "feasible", "fingerprint", "evals", "note", "remat_layers"):
        assert key in d, key
    assert d["cut_points"] == sorted(d["cut_points"]) and len(d["fingerprint"]) == 16
    bounds = [(s["start"], s["end"]) for s in d["stages"]]
    assert bounds[0][0] == 0 and bounds[-1][1] == plan.program.n_forward
    for (_, e0), (s1, _) in zip(bounds, bounds[1:]):
        assert e0 == s1
    assert d["n_eqns"] == plan.program.n_forward_ops
    # the unit is a whole layer call below the model (a deliberate difference)
    assert all(p.startswith("GPTForPretraining.gpt.") for p in d["remat_layers"])


def test_planned_step_recorded_peak_fits_the_budget(planned):
    """The planner's estimate of a candidate runs nothing; the planned step's
    own recording confirms it."""
    assert planned["s1"].memory_plan().peak_bytes <= planned["budget_mb"] * MB
    assert planned["s1"].memory_plan().peak_bytes == planned["plan"].peak_after_bytes


def test_planned_step_matches_jax_and_is_bitwise_the_unplanned(planned, jax_weights):
    _w, jax_losses, jax_params = jax_weights
    assert planned["l1"] == planned["l0"]
    for a, b in zip(planned["m0"].parameters(), planned["m1"].parameters()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(planned["l1"], jax_losses, **TOL_LOSS)
    for p, q in zip(planned["m1"].parameters(), jax_params):
        np.testing.assert_allclose(p.detach().numpy(), q, **TOL_PARAM)


def test_step_frees_the_model_output_before_the_backward():
    """The planner frees the model's output at the loss function's last
    read; the step holds it no longer (else a 345M step's logits stay live
    through the backward, above the planned peak)."""
    import weakref

    m, crit, opt = _gpt()
    held = []

    def loss_fn(logits, labels):
        ref = weakref.ref(logits)
        w = m.gpt.embeddings.word_embeddings.weight
        w.register_hook(lambda g: held.append(ref() is not None))
        return crit(logits * 2.0, labels)

    _train(jit.compile_train_step(m, loss_fn, opt), 1)
    assert held == [False]


@pytest.mark.parametrize("stale", ["other_model", "other_depth"])
def test_stale_plan_falls_back_counted(planned, stale):
    before = prof.dispatch_counters()["memory_plan_failures"]
    if stale == "other_model":
        pt.seed(3)
        other = nn.Sequential(nn.Linear(16, 4))
        o = pt.optimizer.Adam(parameters=other.parameters(), learning_rate=1e-3)
        step = jit.compile_train_step(other, nn.CrossEntropyLoss(), o,
                                      memory_plan=planned["plan"])
        loss = step(torch.zeros(8, 16), torch.zeros(8, dtype=torch.int64))
    else:  # the layers it names exist, but the forward is another one
        from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                                 GPTPretrainingCriterion)

        cfg = GPTConfig(**dict(CFG, num_layers=1))
        m = GPTForPretraining(cfg, device="cpu")
        o = pt.optimizer.Adam(parameters=m.parameters(), learning_rate=1e-3)
        step = jit.compile_train_step(m, GPTPretrainingCriterion(cfg), o,
                                      memory_plan=planned["plan"])
        ids = np.random.default_rng(2).integers(0, CFG["vocab_size"], (4, 17))
        loss = step(torch.tensor(ids[:, :-1]), torch.tensor(ids[:, 1:]))
    assert np.isfinite(float(loss))  # it runs unplanned instead of raising
    assert prof.dispatch_counters()["memory_plan_failures"] == before + 1
    assert plan_mod.state()["compile_train_step"]["failed"]


def test_auto_mode_plans_and_matches(planned):
    builds = prof.dispatch_counters()["memory_plan_builds"]
    pt.set_flags({"FLAGS_memory_plan": "auto", "FLAGS_memory_budget_mb": planned["budget_mb"]})
    try:
        m, c, o = _gpt(weights=None)
        m0, c0, o0 = _gpt(weights=None)
        step, base = jit.compile_train_step(m, c, o), None
        auto = _train(step)
        assert step._last.plan is not None and step._last.plan.has_cuts
        assert prof.dispatch_counters()["memory_plan_builds"] > builds
        pt.set_flags({"FLAGS_memory_plan": ""})
        base = _train(jit.compile_train_step(m0, c0, o0))
        assert auto == base
    finally:
        pt.set_flags({"FLAGS_memory_plan": "", "FLAGS_memory_budget_mb": 0.0})


@pytest.fixture
def capture_mode():
    lazy.reset_lazy_state()
    prof.reset_dispatch_counters()
    plan_mod._reset_state()
    pt.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_step_capture": True})
    try:
        yield
    finally:
        lazy.flush_if_pending("test_teardown")
        pt.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_memory_plan": "",
                      "FLAGS_memory_budget_mb": 0.0})
        lazy.reset_lazy_state()
        prof.reset_dispatch_counters()  # later files read the capture counters


def _eager_run(n, recompute_gpt=False):
    if recompute_gpt:
        m, lf, o = _gpt(recompute=True)
        batches = [(pt.to_tensor(x), pt.to_tensor(y)) for x, y in _batches(n)]
    else:
        pt.seed(0)
        m = nn.Sequential(nn.Linear(64, 128), nn.GELU(approximate=True), nn.Linear(128, 128),
                          nn.GELU(approximate=True), nn.Linear(128, 16))
        o = pt.optimizer.Adam(learning_rate=1e-3, parameters=m.parameters())
        lf = nn.CrossEntropyLoss()
        rng = np.random.default_rng(0)
        batches = [(pt.to_tensor(rng.standard_normal((128, 64)).astype("float32")),
                    pt.to_tensor(rng.integers(0, 16, (128,)).astype("int64")))
                   for _ in range(n)]
    losses = []
    for x, y in batches:
        loss = lf(m(x), y)
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(loss.numpy().copy())
    return m, losses


def test_capture_planned_bitwise_vs_eager(capture_mode):
    pt.set_flags({"FLAGS_memory_plan": "auto", "FLAGS_memory_budget_mb": 0.5})
    m1, planned_losses = _eager_run(5)
    c = prof.dispatch_counters()
    assert c["capture_replays"] >= 1 and c["memory_plan_failures"] == 0, dict(c)
    st = plan_mod.state()
    assert "capture" in st, st
    assert st["capture"]["peak_after_mb"] < st["capture"]["peak_before_mb"]
    assert st["capture"]["cut_points"]
    pt.set_flags({"FLAGS_memory_plan": "", "FLAGS_memory_budget_mb": 0.0,
                  "FLAGS_eager_lazy_dispatch": False})
    m0, base = _eager_run(5)
    for a, b in zip(base, planned_losses):
        assert np.array_equal(a, b)
    for pa, pb in zip(m0.parameters(), m1.parameters()):
        assert torch.equal(pa, pb)


def test_capture_cache_key_tracks_plan_flags(capture_mode):
    pt.set_flags({"FLAGS_memory_plan": "auto", "FLAGS_memory_budget_mb": 0.5})
    _eager_run(4)
    builds = prof.dispatch_counters()["capture_builds"]
    assert builds >= 1
    lazy._tls.observer = None  # a fresh observation cycle, the same cache
    pt.set_flags({"FLAGS_memory_plan": "", "FLAGS_memory_budget_mb": 0.0})
    _eager_run(4)
    assert prof.dispatch_counters()["capture_builds"] > builds


def test_captured_recompute_gpt_is_bitwise_eager(capture_mode):
    """A recompute segment inside a lazily captured step runs its layers
    again in the backward: over the parameters' aliases, so its parameters
    get their gradients (the backward now runs with the aliases in place)."""
    m1, captured = _eager_run(4, recompute_gpt=True)
    assert prof.dispatch_counters()["capture_replays"] >= 1
    pt.set_flags({"FLAGS_eager_lazy_dispatch": False})
    m0, base = _eager_run(4, recompute_gpt=True)
    for a, b in zip(base, captured):
        assert np.array_equal(a, b)
    for pa, pb in zip(m0.parameters(), m1.parameters()):
        assert torch.equal(pa, pb)


# ---------------------------------------------------------------------------
# liveness and donation (tests/test_memory_plan.py:96-481)
# ---------------------------------------------------------------------------
def _relu_net(x, w):
    return torch.clamp_min(x._value @ w._value, 0.0).sum()


SPECS = [((64, 128), "float32"), ((128, 256), "float32")]


def test_plan_golden_bytes_exact():
    """x 32768 + w 131072 + the product 65536 + its relu 65536: the peak at
    the relu, as in the JAX golden (294912 bytes)."""
    plan = mem.plan_memory(analysis.record(_relu_net, SPECS))
    assert plan.peak_bytes == 294912
    assert plan.input_bytes == 32768 + 131072


def test_memory_budget_quiet_report_and_error():
    assert analysis.check(_relu_net, SPECS) == []
    diags = analysis.check(_relu_net, SPECS, memory_budget_mb=16)
    info = hits(diags, "memory_budget", Severity.INFO, "estimated peak")
    assert info and info[0].data["peak_bytes"] == 294912
    top = info[0].data["top_live"]
    assert top and top[0]["nbytes"] >= top[-1]["nbytes"]
    assert not hits(diags, "memory_budget", Severity.ERROR)
    over = hits(analysis.check(_relu_net, SPECS, memory_budget_mb=0.01), "memory_budget",
                Severity.ERROR, "exceeds the declared")
    assert over and over[0].data["peak_bytes"] == 294912
    pt.set_flags({"FLAGS_memory_budget_mb": 0.01})
    try:
        assert hits(analysis.check(_relu_net, SPECS), "memory_budget", Severity.ERROR)
    finally:
        pt.set_flags({"FLAGS_memory_budget_mb": 0.0})


def _roles(program):
    return {name: vid for vid, (_kind, name) in program.roles.items()}


@pytest.mark.parametrize("case", ["returned_unchanged", "double_bound", "external_ref", "clean"])
def test_donation_safety_verdicts(case):
    if case == "returned_unchanged":
        program = analysis.record(lambda a, b: (a, (a * b).sum()), [((8,), "float32")] * 2)
        a = _roles(program)["arg0"]
        ctx = analysis.Context(program, source="t", donated=(a,))
        want = (Severity.ERROR, "returned unchanged")
    elif case in ("double_bound", "external_ref"):
        program = analysis.record(lambda a, b: (a + b).sum(), [((8,), "float32")] * 2)
        a, b = _roles(program)["arg0"], _roles(program)["arg1"]
        kw = (dict(alias_groups=[(a, b)]) if case == "double_bound"
              else dict(alias_refs={a: ["tensor held_copy shape=(8,)"]}))
        ctx = analysis.Context(program, source="t", donated=(a,), **kw)
        want = (Severity.ERROR, "bound to" if case == "double_bound" else "use-after-donate")
    else:
        program = analysis.record(lambda a, b, c: (a * 2.0).sum() + b.sum(),
                                  [((8,), "float32")] * 3)
        r = _roles(program)
        ctx = analysis.Context(program, source="t", donated=(r["arg0"],))
        ctx.donated = (r["arg0"],) + ((r["arg2"],) if "arg2" in r else ())
        diags = analysis.run_passes(ctx, ["donation_safety"])
        assert not hits(diags, "donation_safety", Severity.ERROR), diags
        assert hits(diags, "donation_safety", Severity.INFO, "verified")
        verdicts = mem.donation_verdicts(ctx)
        assert verdicts and all(v["proven"] for v in verdicts)
        return
    diags = analysis.run_passes(ctx, ["donation_safety"])
    assert hits(diags, "donation_safety", *want), diags
    assert not all(v["proven"] for v in mem.donation_verdicts(ctx))


def test_donated_buffer_diags_flags_tied_buffers_and_live_views():
    t, other = torch.zeros(16), torch.ones(16)
    diags = mem.donated_buffer_diags([("param:tied_a", t), ("param:tied_b", t),
                                      ("param:c", other)], exclude=(t, other))
    dup = [d for d in diags if "bound to 2 donated positions" in d.message]
    assert len(dup) == 1 and dup[0].severity == Severity.ERROR, diags
    assert mem.donated_buffer_diags([("param:c", other)], exclude=(other,)) == []
    view = other.numpy()  # a held numpy view of the storage  # noqa: F841
    held = mem.donated_buffer_alias_diags([("param:c", other)], exclude=(other,))
    assert held and "use-after-donate" in held[0].message and "numpy" in held[0].message
    assert mem.tensor_aliases(other)


def _lenet():
    pt.seed(0)
    model = pt.vision.models.LeNet()
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    loss_fn = pt.nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    x = pt.to_tensor(rng.standard_normal((8, 1, 28, 28)).astype(np.float32))
    y = pt.to_tensor(rng.integers(0, 10, (8,)))

    def step():
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, step


def test_captured_step_plans_and_use_after_donate_flagged(capture_mode):
    """The captured LeNet step's plan credits its in-place writes; a detached
    view of a parameter held across a captured step is a use after donation,
    raised at FLAGS_check_programs=2 before the replay writes under it."""
    model, step = _lenet()
    for _ in range(4):
        step()
    assert prof.dispatch_counters()["capture_replays"] >= 1
    plans = mem.captured_step_plans()
    assert plans is not None and plans[0].peak_bytes > 0
    assert plans[1].peak_bytes >= plans[0].peak_bytes
    program, donated, roles = lazy.captured_step_program()
    assert donated and any(kind == "param" for kind, _ in roles.values())
    held = next(model.parameters()).detach()  # noqa: F841 — the live alias
    pt.set_flags({"FLAGS_check_programs": 2})
    try:
        with pytest.raises(ProgramVerificationError) as ei:
            step()
        assert any("use-after-donate" in d.message for d in ei.value.diagnostics)
        assert prof.dispatch_counters()["donation_alias_flags"] >= 1
    finally:
        pt.set_flags({"FLAGS_check_programs": 0})


def test_compile_train_step_memory_plan_and_alias_check():
    pt.seed(0)
    m = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    o = pt.optimizer.Adam(parameters=m.parameters(), learning_rate=1e-3)
    step = jit.compile_train_step(m, nn.CrossEntropyLoss(), o)
    x, y = torch.randn(8, 16), torch.randint(0, 4, (8,))
    step(x, y)
    plan = step.memory_plan()
    assert plan.peak_bytes > 0 and plan.donation_credit_bytes > 0
    assert step.memory_plan(donated=()).donation_credit_bytes == 0
    held = next(m.parameters()).detach().numpy()  # noqa: F841
    pt.set_flags({"FLAGS_check_programs": 2})
    try:
        with pytest.raises(ProgramVerificationError):
            step(x, y)
    finally:
        pt.set_flags({"FLAGS_check_programs": 0})


# ---------------------------------------------------------------------------
# the KV block pool
# ---------------------------------------------------------------------------
def test_plan_block_pool_rule():
    program = analysis.record(_relu_net, SPECS)
    plan = mem.plan_block_pool(lambda: program, block_bytes=4096, pool_bytes_in_trace=32768,
                               budget_mb=1.0)
    assert plan.trace_peak_bytes == 294912
    assert plan.overhead_bytes == 294912 - 32768
    assert plan.num_blocks == (MB - plan.overhead_bytes) // 4096
    assert plan.pool_bytes() == plan.num_blocks * 4096
    none = mem.plan_block_pool(lambda: program, block_bytes=4096)
    assert none.num_blocks is None and none.budget_bytes is None  # no budget on the CPU
    broken = mem.plan_block_pool(lambda: 1 / 0, block_bytes=4096, pool_bytes_in_trace=100,
                                 budget_mb=1.0)
    assert broken.overhead_bytes == 0 and broken.num_blocks == MB // 4096


def test_detected_budget_is_free_memory_less_headroom(monkeypatch):
    """The detected rung: the card's free memory, the allocator's cached
    bytes and the program's resident inputs, less a quarter of the card
    (the card's readings stubbed: there is none here)."""
    gib = 1 << 30
    monkeypatch.setattr(mem, "device_hbm_bytes", lambda: 80 * gib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (50 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 10 * gib)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 8 * gib)
    assert mem.DETECTED_HEADROOM == 0.25
    assert mem.detected_budget_bytes(3 * gib) == (50 + 2 + 3 - 20) * gib
    assert mem.detected_budget_bytes() == 32 * gib
    program = analysis.record(_relu_net, SPECS)
    held = sum(v.nbytes for v in program.values.values() if v.producer < 0)
    plan = mem.plan_block_pool(lambda: program, block_bytes=4096, pool_bytes_in_trace=32768)
    assert plan.budget_bytes == 32 * gib + held
    assert plan.num_blocks == (plan.budget_bytes - plan.overhead_bytes) // 4096
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (gib, 80 * gib))
    assert mem.detected_budget_bytes() == 0  # less free than the headroom: no room


def test_warm_ups_share_one_side_stream(monkeypatch):
    """Every warm-up of a device runs on one side stream: each stream that
    runs a matrix product keeps a cuBLAS workspace allocated for good (the
    stream made here is a stand-in: there is no card)."""
    from paddle_tpu_torch.core import cuda_graphs

    made = []
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: made.append(device) or object())
    monkeypatch.setattr(cuda_graphs, "_side_streams", {})
    first = cuda_graphs.side_stream("cuda:0")
    assert cuda_graphs.side_stream(torch.device("cuda", 0)) is first and len(made) == 1
    assert cuda_graphs.side_stream("cuda:1") is not first and len(made) == 2


def _serving_model():
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

    pt.seed(0)
    return GPTForPretraining(GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                                       num_heads=4, max_seq_len=64, dropout=0.0,
                                       attn_dropout=0.0), device="cpu").eval()


def _jax_overhead():
    """The JAX planner's overhead for the same engine geometry, or None where
    the installed jax cannot build its IR."""
    import paddle_tpu as paddle
    from paddle_tpu import serving as jserving
    from paddle_tpu.models import gpt as jgpt

    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                                               num_heads=4, max_seq_len=64, dropout=0.0,
                                               attn_dropout=0.0))
    eng = jserving.Engine(jm, jserving.ServingConfig(block_size=8, prompt_buckets=[8, 16],
                                                     num_blocks=0, memory_budget_mb=16.0))
    plan = eng._pool_plan
    return None if plan.trace_peak_bytes <= 0 or plan.overhead_bytes == 0 else plan


def test_engine_pool_sized_by_the_planner():
    from paddle_tpu_torch import serving

    model = _serving_model()
    eng = serving.Engine(model, serving.ServingConfig(block_size=8, prompt_buckets=[8, 16],
                                                      num_blocks=0, memory_budget_mb=16.0))
    plan = eng._pool_plan
    assert plan is not None and plan.budget_bytes == 16 * MB
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    assert plan.overhead_bytes >= weights  # the decode program reads every weight
    assert eng._pool.num_blocks == (16 * MB - plan.overhead_bytes) // plan.block_bytes
    out = eng.serve([[1, 2, 3], [5, 6]], max_new_tokens=4)
    assert all(r.status == "ok" for r in out) and eng.stats()["pool_blocks"] == eng._pool.num_blocks
    ref = _jax_overhead()
    if ref is not None:
        # the two planners over the same decode program, within 3x either
        # way: the JAX IR is the traced jaxpr (a functional scatter into the
        # pool, XLA's layout of the gathered blocks), the port's the aten ops
        # of one run (in-place writes into the pool, its own gather)
        assert 1 / 3 <= plan.overhead_bytes / ref.overhead_bytes <= 3.0
        assert ref.num_blocks == (16 * MB - ref.overhead_bytes) // ref.block_bytes
    pt.set_flags({"FLAGS_memory_budget_mb": 16.0})
    try:
        flagged = serving.Engine(model, serving.ServingConfig(block_size=8, prompt_buckets=[8],
                                                              num_blocks=0))
        assert flagged._pool_plan.budget_bytes == 16 * MB
    finally:
        pt.set_flags({"FLAGS_memory_budget_mb": 0.0})


def test_engine_budget_below_overhead_has_no_room():
    from paddle_tpu_torch import serving

    with pytest.raises(ValueError, match="memory budget leaves no room"):
        serving.Engine(_serving_model(), serving.ServingConfig(
            block_size=8, prompt_buckets=[8], num_blocks=0, memory_budget_mb=0.01))
