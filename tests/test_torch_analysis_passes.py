"""The port's lint passes (``paddle_tpu_torch/analysis/passes.py``) against
the JAX package's, on the CPU.

The same defect fixtures are built in both packages: the cases of
``tests/test_analysis.py:41-217``, its fixture suite (:241), and the
determinism cases of ``tests/test_equivalence.py:240-308``. The port is held
to the pass name and severity that the JAX test asserts for each fixture;
where the installed jax can build the JAX package's analysis IR (its
inliner needs ``jax.core.Literal``, which jax 0.9 dropped), the JAX
package's own diagnostics of the same fixture are checked to carry that
pass and severity too. Clean programs stay quiet in both. Plus the
FLAGS_check_programs hooks of the port's lazy segments, the pending-segment
check that does not flush, and the launch budget over the dispatch
counters.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import analysis as janalysis
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import ProgramVerificationError, Severity
from paddle_tpu_torch.core import lazy

ERR, WARN, INFO = Severity.ERROR, Severity.WARNING, Severity.INFO


@pytest.fixture(autouse=True)
def on_cpu():
    """The CPU for this file's tests, the caller's device after them."""
    was = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(was)


def hits(diags, pass_name, severity=None, needle=None):
    out = [d for d in diags if d.pass_name == pass_name]
    if severity is not None:
        out = [d for d in out if int(d.severity) == int(severity)]
    if needle is not None:
        out = [d for d in out if needle in d.message or needle in d.op or needle in d.hint]
    return out


def jax_check(*args, **kw):
    """The JAX package's diagnostics of a fixture, or None where the
    installed jax cannot build its IR."""
    try:
        return janalysis.check(*args, **kw)
    except AttributeError as e:
        if "Literal" in str(e):
            return None
        raise


# (fixture id, JAX builder, port builder, specs, [(pass, severity, needle)]):
# each expectation is what tests/test_analysis.py asserts of the JAX fixture
def _jax_cases():
    import jax.numpy as jnp
    import paddle_tpu.nn.functional as JF

    return {
        "f64_upcast": lambda x: jnp.asarray(x._value, jnp.float64) * 2.0,
        "bf16_f32_mix": lambda x, w: paddle.matmul(x, w).sum() + paddle.matmul(
            x.astype("bfloat16"), w.astype("bfloat16")).astype("float32").sum(),
        "feed_width": lambda x: x.astype("bfloat16").sum(),
        "transpose_pair": lambda x: paddle.transpose(paddle.transpose(x, [1, 0]), [1, 0])
        * 1.0 + 0.0,
        "broadcast_reduce": lambda x: paddle.expand(x.reshape([1, 4]), [512, 4]).sum(axis=0),
        "log_softmax": lambda x: paddle.log(JF.softmax(x, axis=-1)),
        "unguarded_log": lambda x: paddle.log(x),
        "unguarded_div": lambda x, d: x / d,
        "fp16_long_sum": lambda x: jnp.cumsum(jnp.asarray(x._value, jnp.float16)),
    }


def _port_cases():
    import paddle_tpu_torch.nn.functional as TF

    return {
        "f64_upcast": lambda x: x.astype("float64") * 2.0,
        "bf16_f32_mix": lambda x, w: pt.matmul(x, w).sum() + pt.matmul(
            x.astype("bfloat16"), w.astype("bfloat16")).astype("float32").sum(),
        "feed_width": lambda x: x.astype("bfloat16").sum(),
        "transpose_pair": lambda x: pt.transpose(pt.transpose(x, [1, 0]), [1, 0]) * 1.0 + 0.0,
        "broadcast_reduce": lambda x: pt.expand(x.reshape([1, 4]), [512, 4]).sum(axis=0),
        "log_softmax": lambda x: pt.log(TF.softmax(x, axis=-1)),
        "unguarded_log": lambda x: pt.log(x),
        "unguarded_div": lambda x, d: x / d,
        "fp16_long_sum": lambda x: pt.cumsum(x.astype("float16"), axis=0),
    }


CASES = [
    ("f64_upcast", [((4,), "float32")], [("dtype_check", ERR, "float64")]),
    ("bf16_f32_mix", [((4, 8), "float32"), ((8, 4), "float32")],
     [("dtype_check", WARN, "mixed-precision")]),
    ("feed_width", [((4,), "float32")], [("dtype_check", WARN, "casts")]),
    ("transpose_pair", [((3, 4), "float32")],
     [("redundant_ops", WARN, "transpose∘transpose"), ("redundant_ops", WARN, "x*1"),
      ("redundant_ops", WARN, "x+0")]),
    ("broadcast_reduce", [((4,), "float32")], [("redundant_ops", WARN, "broadcast-then-reduce")]),
    ("log_softmax", [((2, 5), "float32")], [("redundant_ops", WARN, "log_softmax")]),
    ("unguarded_log", [((4,), "float32")], [("numeric_hazards", ERR, "unguarded log")]),
    ("unguarded_div", [((4,), "float32"), ((4,), "float32")],
     [("numeric_hazards", WARN, "division")]),
    ("fp16_long_sum", [((4096,), "float32")], [("numeric_hazards", WARN, "4096")]),
]


@pytest.mark.parametrize("name,specs,want", CASES, ids=[c[0] for c in CASES])
def test_defect_fixture_has_the_jax_pass_and_severity(name, specs, want):
    diags = analysis.check(_port_cases()[name], specs)
    for pass_name, sev, needle in want:
        assert hits(diags, pass_name, sev, needle), (pass_name, sev, needle, diags)
    if name == "f64_upcast":
        import jax

        try:
            x64 = jax.experimental.enable_x64()
        except AttributeError:  # jax >= 0.9
            x64 = jax.enable_x64(True)
        with x64:
            ref = jax_check(_jax_cases()[name], specs)
    else:
        ref = jax_check(_jax_cases()[name], specs)
    if ref is not None:
        for pass_name, sev, _needle in want:
            assert hits(ref, pass_name, sev), (pass_name, ref)


CLEAN = [
    ("guarded_log", lambda x: pt.log(pt.clip(x, min=1e-6)),
     lambda x: paddle.log(paddle.clip(x, min=1e-6)), [((4,), "float32")], "numeric_hazards"),
    ("eps_div", lambda x, d: x / (pt.abs(d) + 1e-6), lambda x, d: x / (paddle.abs(d) + 1e-6),
     [((4,), "float32"), ((4,), "float32")], "numeric_hazards"),
    ("linear", lambda x: _LIN[0](x).sum(), None, [((4, 8), "float32")], None),
]
_LIN = []


@pytest.mark.parametrize("name,fn,jfn,specs,pass_name", CLEAN, ids=[c[0] for c in CLEAN])
def test_clean_program_is_quiet(name, fn, jfn, specs, pass_name):
    _LIN[:] = [pt.nn.Linear(8, 16)]
    diags = analysis.check(fn, specs)
    got = diags if pass_name is None else hits(diags, pass_name)
    assert got == [], got
    ref = jax_check(jfn, specs) if jfn is not None else None
    if ref is not None:  # tests/test_analysis.py:159-185 asserts these quiet
        assert hits(ref, pass_name) == []


@pytest.mark.parametrize("layer", ["batchnorm", "dropout"])
def test_layer_lint_stays_clean(layer):
    """tests/test_analysis.py:53 and :187: a batch norm's rsqrt(var + eps)
    is guarded; dropout lints dtype-clean."""
    if layer == "batchnorm":
        diags = analysis.check(pt.nn.BatchNorm2D(3), [((2, 3, 4, 4), "float32")])
        assert not hits(diags, "numeric_hazards"), diags
    else:
        diags = analysis.check(pt.nn.Dropout(0.5), [((8, 8), "float32")])
        assert not hits(diags, "dtype_check", ERR), diags


def test_dead_op_and_unused_parameter_and_feed():
    class Net(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.used = pt.nn.Linear(8, 4)
            self.orphan = pt.nn.Linear(8, 4)  # never called

        def forward(self, x):
            return self.used(x)

    diags = analysis.check(Net(), [((2, 8), "float32")])
    found = hits(diags, "dead_code", WARN, "unused parameter")
    assert any("orphan" in d.op for d in found), diags

    def f(x, unused):
        _dead = x * 2.0  # injected dead op
        return (x + 1.0).sum()

    diags = analysis.check(f, [((4, 8), "float32"), ((4,), "float32")])
    assert hits(diags, "dead_code", WARN, "dead op"), diags
    assert hits(diags, "dead_code", WARN, "unused feed"), diags


def test_fixture_suite_flags_all_injected_defects():
    def broken(x):
        t = pt.transpose(pt.transpose(x, [1, 0]), [1, 0])  # redundant
        _dead = x * 3.0                                    # dead op
        return pt.log(t).sum()                             # hazard

    diags = analysis.check(broken, [((3, 4), "float32")])
    assert hits(diags, "numeric_hazards", ERR, "unguarded log")
    assert hits(diags, "dead_code", WARN, "dead op")
    assert hits(diags, "redundant_ops", WARN, "transpose∘transpose")
    assert diags[0].severity == ERR
    assert diags == sorted(diags, key=lambda d: -int(d.severity))
    assert all(d.op and d.message for d in diags)
    def jax_broken(x):  # tests/test_analysis.py:242
        t = paddle.transpose(paddle.transpose(x, [1, 0]), [1, 0])
        _dead = x * 3.0
        return paddle.log(t).sum()

    ref = jax_check(jax_broken, [((3, 4), "float32")])
    if ref is not None:
        for pass_name, sev in (("numeric_hazards", ERR), ("dead_code", WARN),
                               ("redundant_ops", WARN)):
            assert hits(ref, pass_name, sev), ref


def test_run_passes_sorts_and_rejects_unknown():
    """tests/test_equivalence.py:199-237 over a recorded program."""
    def fn(x):
        _dead = x * 1.0  # redundant_ops WARNING; result unused -> dead_code
        return pt.log(x)  # unguarded log over a raw feed -> ERROR

    ctx = analysis.Context(analysis.record(fn, [((4,), "float32")]), source="probe")
    diags = analysis.run_passes(ctx, ["memory_budget", "dead_code", "numeric_hazards"])
    sevs = [int(d.severity) for d in diags]
    assert sevs == sorted(sevs, reverse=True)
    assert diags[0].pass_name == "numeric_hazards" and diags[0].severity == ERR
    assert any(d.pass_name == "dead_code" for d in diags)
    for a, b in zip(diags, diags[1:]):
        if a.severity == b.severity:
            assert a.pass_name <= b.pass_name
    with pytest.raises(ValueError, match="unknown analysis pass"):
        analysis.run_passes(ctx, ["no_such_pass"])


# ---------------------------------------------------------------------------
# determinism (tests/test_equivalence.py:240-308, the one-card cases)
# ---------------------------------------------------------------------------
def _t(x):
    return x._value  # the torch value of a Paddle Tensor feed


def _index_add(x, idx):
    return torch.zeros(8).index_add(0, _t(idx).long() % 8, _t(x))


def _unique_index_add(x):
    return torch.zeros(16).index_add(0, torch.arange(16), _t(x))


def _embedding_grad(table, idx):
    idx = _t(idx)
    t = _t(table).detach().requires_grad_()
    with torch.enable_grad():
        (g,) = torch.autograd.grad(t.index_select(0, idx.long() % 32).sum(), [t])
    return g


def _reused_generator(x):
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(4, generator=gen)
    gen.manual_seed(0)
    return x + a + torch.rand(4, generator=gen)


def _split_generator(x):
    gen = torch.Generator().manual_seed(0)
    return x + torch.randn(4, generator=gen) + torch.rand(4, generator=gen)


def _host_callback(x):
    return x * float(x.sum())  # the value leaves the device and comes back


DETERMINISM = [
    ("duplicate_scatter", _index_add, [((16,), "float32"), ((16,), "int32")], "duplicate"),
    ("unique_scatter", _unique_index_add, [((16,), "float32")], None),
    ("gather_transpose", _embedding_grad, [((32, 4), "float32"), ((16,), "int32")], None),
    ("reused_generator", _reused_generator, [((4,), "float32")], "IDENTICAL random streams"),
    ("split_generator", _split_generator, [((4,), "float32")], None),
    ("host_callback", _host_callback, [((4,), "float32")], "callback"),
]


@pytest.mark.parametrize("name,fn,specs,needle", DETERMINISM, ids=[c[0] for c in DETERMINISM])
def test_determinism(name, fn, specs, needle):
    """Positives warn with the JAX package's words; the negatives (unique
    indices, a gather's own gradient, an advancing generator) are silent,
    as in tests/test_equivalence.py."""
    ctx = analysis.Context(analysis.record(fn, specs), source="probe")
    d = analysis.run_passes(ctx, ["determinism"])
    if needle is None:
        assert d == [], d
    else:
        assert any(needle in x.message and x.severity == WARN for x in d), d


# ---------------------------------------------------------------------------
# launch budget over the dispatch counters (tests/test_analysis.py:207-238)
# ---------------------------------------------------------------------------
def test_launch_budget_over_and_under():
    over = analysis.check_launch_budget(
        counters={"programs": 13, "op_programs": 11, "backward_programs": 1,
                  "optimizer_programs": 1}, budget=3)
    assert hits(over, "launch_budget", WARN, "13"), over
    assert analysis.check_launch_budget(counters={"programs": 3}, budget=3) == []
    ref = janalysis.check_launch_budget(counters={"programs": 3}, budget=3)
    assert ref == []


def test_launch_budget_measures_live_step():
    """The per-op LeNet step is 4 programs (a deliberate difference of the port:
    the JAX package launches ~13): both blow a budget of 3."""
    pt.seed(0)
    model = pt.vision.models.LeNet()
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    loss_fn = pt.nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    x = pt.to_tensor(rng.standard_normal((2, 1, 28, 28)).astype(np.float32))
    y = pt.to_tensor(rng.integers(0, 10, (2,)))

    def step():
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss)

    diags = analysis.check_launch_budget(step, budget=3)
    assert hits(diags, "launch_budget", WARN), diags


# ---------------------------------------------------------------------------
# FLAGS_check_programs hooks
# ---------------------------------------------------------------------------
@pytest.fixture
def lazy_mode():
    pt.set_flags({"FLAGS_eager_lazy_dispatch": True})
    try:
        yield
    finally:
        lazy.flush_if_pending("test_teardown")
        pt.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_check_programs": 0})


def test_lazy_flush_warns_and_raises_per_flag_level(lazy_mode):
    """tests/test_analysis.py:312: level 1 warns at a segment's first run,
    level 2 raises ProgramVerificationError, and the failed segment keeps
    reporting its cause."""
    pt.set_flags({"FLAGS_check_programs": 1})
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        x = pt.to_tensor(np.ones(4, np.float32))
        float((x * 1.0).sum())
    assert any("x*1" in str(w.message) for w in seen), [str(w.message) for w in seen]

    pt.set_flags({"FLAGS_check_programs": 2})
    # a float64 upcast (error severity); the port's unary math functions run
    # per-op under lazy dispatch, so the JAX test's paddle.log is not a segment
    y = pt.to_tensor(np.full(3, 2.0, np.float32)).astype("float64")
    with pytest.raises(ProgramVerificationError) as ei:
        y.numpy()
    assert any(d.severity == ERR for d in ei.value.diagnostics)
    with pytest.raises(RuntimeError):
        y.numpy()


def test_check_pending_segment_does_not_flush(lazy_mode):
    x = pt.to_tensor(np.ones(4, np.float32))
    y = x * 1.0
    diags = analysis.check_pending_segment()
    assert hits(diags, "redundant_ops", WARN, "x*1"), diags
    assert lazy.pending_op_count() == 1  # still pending
    np.testing.assert_array_equal(y.numpy(), np.ones(4, np.float32))
    assert analysis.check_pending_segment() == []  # nothing pending now


def test_check_programs_flag_levels():
    for level in (0, 1, 2):
        pt.set_flags({"FLAGS_check_programs": level})
        assert pt.get_flags("FLAGS_check_programs")["FLAGS_check_programs"] == level
    pt.set_flags({"FLAGS_check_programs": 0})
    diags = analysis.check(lambda x: pt.log(x), [((4,), "float32")])
    assert analysis.enforce(diags, "t", level=0) == diags
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        analysis.enforce(diags, "t", level=1)
    assert any("unguarded log" in str(w.message) for w in seen)
    with pytest.raises(ProgramVerificationError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            analysis.enforce(diags, "t", level=2)


@pytest.mark.parametrize("model", ["gpt", "resnet"])
def test_model_lint_has_no_error(model):
    """The models chip_smoke.py lints at full width, here narrow: every pass,
    no error diagnostic."""
    if model == "gpt":
        from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

        pt.seed(0)
        m = GPTForPretraining(GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                                        num_heads=4, max_seq_len=32, dropout=0.0,
                                        attn_dropout=0.0), device="cpu")
        diags = analysis.check(m, [((2, 32), "int64")])
    else:
        m = pt.vision.models.resnet18(num_classes=10)
        diags = analysis.check(m, [((2, 3, 32, 32), "float32")])
    assert not [d for d in diags if d.severity >= ERR], diags
