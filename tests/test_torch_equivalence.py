"""The port's equivalence prover (``paddle_tpu_torch/analysis/equivalence.py``)
against the JAX package's, on the CPU.

The prover units mirror the non-sharded cases of
``tests/test_equivalence.py:62-161``: the same pairs of functions, written
in torch, get the verdict the JAX test asserts (equivalent or divergent),
and a divergence is a structured diagnostic. Where the installed jax can
build the JAX package's analysis IR (jax 0.9 dropped ``jax.core.Literal``,
which its inliner needs), the JAX prover's verdict on the JAX pair is
checked too. Then the certificates of :462-665: a captured step proven
equivalent to a recorded 3-program step before it replays (MLP, LeNet, a
narrow GPT), a sabotaged reference that becomes a counted fallback with a
diagnostic, an unprovable one that falls through the counted ladder, a
serving program's rungs certified once, and a planned compile_train_step
certified against the unplanned one.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.profiler as prof
from paddle_tpu_torch.analysis import ProgramVerificationError, Severity
from paddle_tpu_torch.analysis import equivalence as eq
from paddle_tpu_torch.core import lazy

RNG = np.random.default_rng(0)
X = torch.tensor(RNG.standard_normal((4, 3)), dtype=torch.float32)
Y = torch.tensor(RNG.standard_normal((4, 3)), dtype=torch.float32)


@pytest.fixture(autouse=True)
def on_cpu():
    """The CPU for this file's tests, the caller's device after them."""
    was = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(was)


def jax_verdict(fa, fb, n_args=2, **kw):
    """The JAX prover's verdict on a JAX pair, or None where the installed
    jax cannot build its IR."""
    import jax

    from paddle_tpu.analysis import equivalence as jeq

    specs = [jax.ShapeDtypeStruct((4, 3), "float32")] * n_args
    try:
        return jeq.certify_callables(fa, fb, specs, **kw).equivalent
    except AttributeError as e:
        if "Literal" in str(e):
            return None
        raise


def _f(x, y):
    a = x * 2.0
    return a + y, a.amax(0)


def _g(x, y):  # the same function: commuted operands, folded literal, detach
    a = (x * (1.0 + 1.0)).detach()
    return y + a, a.amax(0)


def _h(x, y):  # diverges: scale 3.0 instead of 2.0
    a = x * 3.0
    return a + y, a.amax(0)


def _jf(x, y):
    a = x * 2.0
    return a + y, a.max(axis=0)


def _jg(x, y):
    import jax

    a = jax.lax.stop_gradient(x * (1.0 + 1.0))
    a = x * (1.0 + 1.0)
    return y + a, a.max(axis=0)


def _jh(x, y):
    a = x * 3.0
    return a + y, a.max(axis=0)


def test_prover_commutes_folds_and_elides_detach():
    cert = eq.certify_callables(_f, _g, [X, Y], label_a="f", label_b="g")
    assert cert.equivalent, cert.divergence
    s = cert.summary()
    assert "EQUIVALENT" in s and "f ≡ g" in s
    assert cert.divergence is None
    assert jax_verdict(_jf, _jg) in (None, True)


def test_prover_divergence_is_a_structured_diagnostic():
    cert = eq.certify_callables(_f, _h, [X, Y], label_a="f", label_b="h")
    assert not cert.equivalent
    assert "DIVERGENT" in cert.summary()
    d = cert.divergence
    assert d is not None and d.pass_name == "equivalence" and d.severity == Severity.ERROR
    assert "diverge" in d.message
    assert jax_verdict(_jf, _jh) in (None, False)


def test_prover_allows_declared_extra_trailing_outputs():
    def f3(x, y):  # the telemetry triple's shape: 3 extra trailing outputs
        return _f(x, y) + (x.sum(), torch.zeros(()), torch.ones(()))

    cert = eq.certify_callables(f3, _f, [X, Y], extra_outputs_a=3)
    assert cert.equivalent, cert.divergence
    assert not eq.certify_callables(f3, _f, [X, Y]).equivalent  # arities differ


def _loop(body, x, y):
    c = x
    for _ in range(3):  # the JAX test's scan of length 3, unrolled
        c = body(c, y)
    return c


@pytest.mark.parametrize("body,verdict", [
    (lambda c, y: y.sum() + (1.0 + 1.0) * c, True),  # commuted + folded in the body
    (lambda c, y: c * 2.5 + y.sum(), False),          # diverges in the body
], ids=["commuted", "divergent"])
def test_prover_canonicalizes_loop_bodies(body, verdict):
    cert = eq.certify_callables(lambda x, y: _loop(lambda c, v: c * 2.0 + v.sum(), x, y),
                                lambda x, y: _loop(body, x, y), [X, Y])
    assert cert.equivalent is verdict
    assert (cert.divergence is None) is verdict


def test_prover_canonicalizes_recompute_duplicates():
    """A recompute segment's replayed forward hashes to the original's keys
    (tests/test_equivalence.py:127, jax.checkpoint's duplicates)."""
    from paddle_tpu_torch.incubate.recompute import recompute

    def inner(x):
        return torch.tanh(x @ x.T)

    def grad_of(f):
        def run(x, y):
            v = x.detach().requires_grad_()
            with torch.enable_grad():
                return torch.autograd.grad(f(v).sum(), [v])[0]
        return run

    cert = eq.certify_callables(grad_of(inner), grad_of(lambda v: recompute(inner, v)), [X, Y],
                                label_a="plain", label_b="remat")
    assert cert.equivalent, cert.divergence


class _CustomGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(torch.cos(x))
        return torch.sin(x) * 2.0

    @staticmethod
    def backward(ctx, g):
        (res,) = ctx.saved_tensors
        return res * g * 2.0


def test_prover_sees_through_a_custom_autograd_function():
    """tests/test_equivalence.py:175: the primal body of a custom-gradient
    function is the plain function."""
    cert = eq.certify_callables(lambda x, y: _CustomGrad.apply(x),
                                lambda x, y: torch.sin(x) * 2.0, [X, Y])
    assert cert.equivalent, cert.divergence


def test_program_diff_lines():
    pa = eq._record_fn(_f, [X, Y], "f")[0]
    pb = eq._record_fn(_h, [X, Y], "h")[0]
    cert, lines = eq.program_diff(pa, pb, "f", "h")
    assert not cert.equivalent and lines[0] == cert.summary()
    assert any("diverge" in line for line in lines)


# ---------------------------------------------------------------------------
# captured-step certificates (FLAGS_check_programs=2)
# ---------------------------------------------------------------------------
@pytest.fixture
def certify_mode():
    lazy.reset_lazy_state()
    prof.reset_dispatch_counters()
    pt.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_step_capture": True,
                  "FLAGS_check_programs": 2})
    try:
        yield
    finally:
        lazy.flush_if_pending("test_teardown")
        pt.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_check_programs": 0})
        lazy.reset_lazy_state()
        prof.reset_dispatch_counters()  # later files read the capture counters


def _mlp_trainer(seed=0, bsz=4):
    pt.seed(seed)
    model = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(), pt.nn.Linear(16, 4))
    opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
    loss_fn = pt.nn.CrossEntropyLoss()
    rng = np.random.default_rng(7)
    x = pt.to_tensor(rng.standard_normal((bsz, 8)).astype(np.float32))
    y = pt.to_tensor(rng.integers(0, 4, (bsz,)))

    def step():
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return step


def _assert_certified(c):
    assert c["capture_equivalence_checks"] >= 1, dict(c)
    assert c["capture_equivalence_certified"] >= 1, dict(c)
    assert c["capture_equivalence_divergences"] == 0, dict(c)
    assert c["capture_replays"] >= 1, dict(c)
    cert = lazy.captured_step_certificate()
    assert cert is not None and cert.equivalent
    assert "captured-step ≡ 3-program-composition" in cert.summary()
    return cert


def test_captured_mlp_step_is_certified_once(certify_mode):
    step = _mlp_trainer()
    for _ in range(6):
        step()
    c = prof.dispatch_counters()
    assert c["capture_equivalence_checks"] == 1, dict(c)  # replays never re-check
    _assert_certified(c)


@pytest.mark.parametrize("model", ["lenet", "gpt"])
def test_captured_model_step_is_certified(certify_mode, model):
    pt.seed(0)
    rng = np.random.default_rng(0)
    if model == "lenet":
        net = pt.vision.models.LeNet()
        opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters())
        loss_fn = pt.nn.CrossEntropyLoss()
        x = pt.to_tensor(rng.standard_normal((4, 1, 28, 28)).astype(np.float32))
        y = pt.to_tensor(rng.integers(0, 10, (4,)))
    else:
        from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                                 GPTPretrainingCriterion)

        cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                        max_seq_len=32, dropout=0.0, attn_dropout=0.0)
        net = GPTForPretraining(cfg, device="cpu")
        loss_fn = GPTPretrainingCriterion(cfg)
        opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=net.parameters(),
                                 weight_decay=0.01)
        x = pt.to_tensor(rng.integers(0, 256, (1, 32)))
        y = pt.to_tensor(rng.integers(0, 256, (1, 32)))
    for _ in range(5):
        loss = loss_fn(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    cert = _assert_certified(prof.dispatch_counters())
    if model == "gpt":
        assert cert.outputs_compared > 100  # the proof had work to do


def test_captured_step_with_parked_moments_is_certified(certify_mode):
    """With the Adam moments parked on the host (optimizer.offload) the
    captured program stages them and the 3-program step brings them back:
    both copy the same host buffers, and the certificate holds."""
    from paddle_tpu_torch.optimizer import offload

    pt.seed(0)
    model = pt.nn.Sequential(pt.nn.Linear(64, 128), pt.nn.ReLU(), pt.nn.Linear(128, 8))
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    offload.enable(opt, overhead_pct=1e9, min_bytes=1024)
    x = pt.to_tensor(np.random.default_rng(0).standard_normal((32, 64)).astype(np.float32))
    y = pt.to_tensor(np.random.default_rng(1).integers(0, 8, (32,)))
    try:
        for _ in range(6):
            loss = pt.nn.CrossEntropyLoss()(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        cert = _assert_certified(prof.dispatch_counters())
        assert cert.rewrites.get("copy_elisions", 0) > 0
        assert offload.scheduler_of(opt).snapshot()["staged_steps"] >= 1
    finally:
        offload.disable(opt)


def _sabotaged(mutate):
    orig = lazy._build_captured_step

    def patched(rec, opt, live=()):
        entry = orig(rec, opt, live)
        entry.reference = mutate(lazy._tls.reference_done) or "unprovable"
        return entry

    return patched


def _double_a_scalar(ref):
    """The reference with its first float scalar argument doubled: the
    recorded step no longer computes what the captured one does."""
    program, labels, outs = ref
    bad = copy.copy(program)
    bad.ops = list(program.ops)
    for k, op in enumerate(bad.ops):
        pos = list(op.pos)
        for i, a in enumerate(pos):
            if isinstance(a, float) and np.isfinite(a) and a not in (0.0, 1.0):
                pos[i] = a * 2.0
                op = copy.copy(op)
                op.args = (tuple(pos), op.args[1])
                bad.ops[k] = op
                return bad, labels, outs
    raise AssertionError("no scalar argument to sabotage")


def test_forced_divergence_is_a_counted_fallback_with_diagnostic(certify_mode, monkeypatch):
    monkeypatch.setattr(lazy, "_build_captured_step", _sabotaged(_double_a_scalar))
    step = _mlp_trainer()
    with pytest.raises(ProgramVerificationError) as ei:
        for _ in range(6):
            step()
    c = prof.dispatch_counters()
    assert c["capture_equivalence_divergences"] == 1, dict(c)
    assert c["capture_equivalence_certified"] == 0, dict(c)
    assert dict(c["capture_fallback_reasons"]).get("verification_failed") == 1, dict(c)
    assert c["capture_fallbacks"] >= 1
    diags = ei.value.diagnostics
    assert diags and diags[0].pass_name == "equivalence" and diags[0].severity == Severity.ERROR
    assert "divergence" in diags[0].message
    assert lazy.captured_step_certificate() is None


def test_unprovable_reference_falls_through_counted_ladder(certify_mode, monkeypatch):
    monkeypatch.setattr(lazy, "_build_captured_step", _sabotaged(lambda ref: None))
    step = _mlp_trainer()
    losses = [float(step().numpy()) for _ in range(6)]
    assert len(losses) == 6 and all(np.isfinite(losses))
    c = prof.dispatch_counters()
    assert c["capture_equivalence_unprovable"] >= 1, dict(c)
    assert c["capture_equivalence_certified"] == 0
    assert c["capture_replays"] == 0
    assert dict(c["capture_fallback_reasons"]).get("equivalence_unprovable", 0) >= 1


def test_certified_capture_trains_as_the_uncertified_one():
    """The certificate never changes what the step computes."""
    def run(level):
        lazy.reset_lazy_state()
        pt.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_check_programs": level})
        try:
            step = _mlp_trainer()
            return [float(step().numpy()) for _ in range(6)]
        finally:
            lazy.flush_if_pending("test_teardown")
            pt.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_check_programs": 0})
            lazy.reset_lazy_state()
            prof.reset_dispatch_counters()

    assert run(2) == run(0)


def test_serve_rungs_certified_once_per_program():
    """tests/test_equivalence.py:634: the rungs of one serving program are
    proven once, and later runs do not check again. On the CPU the two
    recordings are the program's first two runs."""
    lazy.reset_serve_programs()
    prof.reset_dispatch_counters()
    pt.set_flags({"FLAGS_check_programs": 2})
    try:
        def decode_step(k_pools, v_pools, x):
            k_pools[0].add_(x.float())
            return k_pools, v_pools, (k_pools[0] * x).sum(0), x.argmax(0)

        prog = lazy.serve_program(("decode", 16), decode_step)
        kv = (torch.zeros(4, 16),), (torch.zeros(4, 16),)
        x = torch.ones(4, 16, dtype=torch.int64)
        prog.run((*kv, x), donate=True)
        prog.run((*kv, x), donate=True)
        c = prof.dispatch_counters()
        assert c["serve_equivalence_checks"] == 1 and c["serve_equivalence_certified"] == 1
        assert prog.certificate is not None and prog.certificate.equivalent
        assert "serve-donated ≡ serve-plain" in prog.certificate.summary()
        prog.run((*kv, x), donate=True)
        assert prof.dispatch_counters()["serve_equivalence_checks"] == 1
    finally:
        pt.set_flags({"FLAGS_check_programs": 0})
        lazy.reset_serve_programs()
        prof.reset_dispatch_counters()


def test_planned_step_certified_equivalent_to_unplanned():
    from paddle_tpu_torch import jit, nn
    from paddle_tpu_torch.analysis import plan as plan_mod

    plan_mod._reset_state()

    def build():
        pt.seed(0)
        layers = []
        for _ in range(4):
            layers += [nn.Linear(64, 64), nn.GELU(approximate=True)]
        m = nn.Sequential(*layers, nn.Linear(64, 16))
        return m, pt.optimizer.Adam(parameters=m.parameters(), learning_rate=1e-3)

    rng = np.random.default_rng(0)
    x = pt.to_tensor(rng.standard_normal((128, 64)).astype("float32"))
    y = pt.to_tensor(rng.integers(0, 16, (128,)).astype("int64"))
    m0, o0 = build()
    step0 = jit.compile_train_step(m0, nn.CrossEntropyLoss(), o0)
    unplanned = float(step0(x, y))
    plan = step0.plan_remat(budget_mb=0.6 * step0.memory_plan().peak_bytes / (1 << 20))
    assert plan.has_cuts, plan.summary()
    pt.set_flags({"FLAGS_check_programs": 2})
    try:
        m1, o1 = build()
        step1 = jit.compile_train_step(m1, nn.CrossEntropyLoss(), o1, memory_plan=plan)
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the donation gate's findings
            planned = float(step1(x, y))
        cert = step1._plan_certificate
        assert cert is not None and cert.equivalent, cert
        assert "planned-step ≡ unplanned-step" in cert.summary()
        assert planned == unplanned
    finally:
        pt.set_flags({"FLAGS_check_programs": 0})
