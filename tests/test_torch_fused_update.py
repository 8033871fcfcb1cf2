"""The port's fused optimizer update against the JAX package's, on the CPU.

The JAX side runs its Pallas fused-update kernels in interpret mode
(``FLAGS_pallas_fused_update`` and ``FLAGS_pallas_update_interpret`` on, as
tests/test_pallas_update.py runs them); the port runs its kernels' plain
versions, which is what a CPU tensor gets. Inputs are made with numpy from a
seed and handed to both sides. Each tolerance is stated where it is used,
with its reason.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import fused_update as jfu
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.kernels import fused_update as tfu
from paddle_tpu_torch.resilience import rescue as trescue

import jax.numpy as jnp

# One update, JAX interpret-mode kernel against the port's plain version:
# XLA:CPU contracts b1·m + (1−b1)·g (and mu·v + g) into a fused multiply-add
# that rounds once, where torch rounds after each op, and it may order the
# terms otherwise. That moves a result by an ulp: for standard-normal inputs
# at this seed, 2.4e-7 on p, m and v and 4.8e-7 on Momentum's velocity (whose
# values reach ~5, where one f32 ulp is 4.8e-7).
TOL_UPDATE = dict(atol=5e-7, rtol=1e-6)

FLAGS_OFF = {"FLAGS_pallas_fused_update": False, "FLAGS_pallas_update_interpret": False,
             "FLAGS_numeric_rescue": ""}


@pytest.fixture
def fused_on():
    """The flag on, on both sides; everything the tests set is put back."""
    paddle.set_flags({"FLAGS_pallas_fused_update": True,
                      "FLAGS_pallas_update_interpret": True})
    pt.set_flags({"FLAGS_pallas_fused_update": True})
    trescue.reset_counters()
    import paddle_tpu.profiler as prof

    prof.reset_dispatch_counters()
    try:
        yield prof
    finally:
        paddle.set_flags(dict(FLAGS_OFF, FLAGS_numeric_rescue_lr_factor=0.5))
        pt.set_flags(dict(FLAGS_OFF, FLAGS_numeric_rescue_lr_factor=0.5))
        trescue.reset_counters()


def _state_arrays(kind, rng, shape):
    if kind == "sgd":
        return {}
    if kind == "momentum":
        return {"velocity": rng.standard_normal(shape).astype(np.float32)}
    return {
        "moment1": rng.standard_normal(shape).astype(np.float32),
        "moment2": np.abs(rng.standard_normal(shape)).astype(np.float32),
        # as after three earlier steps
        "beta1_pow": np.float32(0.9 ** 3),
        "beta2_pow": np.float32(0.999 ** 3),
    }


HYPER = {"sgd": {}, "momentum": {"mu": 0.9, "nesterov": False},
         "momentum_nesterov": {"mu": 0.9, "nesterov": True},
         "adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8}}


def _rule_of(kind, wd):
    """The port's optimizer of ``kind``, for its ``_update`` rule."""
    base = kind.split("_")[0]
    hyper = HYPER[kind]
    if base == "sgd":
        return pt.optimizer.SGD(parameters=[], weight_decay=wd)
    if base == "momentum":
        return pt.optimizer.Momentum(parameters=[], momentum=hyper["mu"],
                                     use_nesterov=hyper["nesterov"], weight_decay=wd)
    return pt.optimizer.Adam(parameters=[], weight_decay=wd)


@pytest.mark.parametrize("gate", [None, False, True])
@pytest.mark.parametrize("kind,wd", [("sgd", 0.0), ("sgd", 0.01), ("momentum", 0.0),
                                     ("momentum_nesterov", 0.01), ("adam", 0.0),
                                     ("adam", 0.01)])
def test_param_update_matches_the_jax_kernel_and_the_rule(fused_on, kind, wd, gate):
    base = kind.split("_")[0]
    rng = np.random.default_rng(0)
    shape = (64, 128)  # 8192 elements: a whole number of the JAX kernel's (8, 128) tiles
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    st = _state_arrays(base, rng, shape)
    lr = np.float32(1e-2)
    hyper = HYPER[kind]

    jp, jst = jfu.param_update(
        base, jnp.asarray(p), jnp.asarray(g), jnp.asarray(lr),
        {k: jnp.asarray(v) for k, v in st.items()}, hyper, wd=wd,
        bad=None if gate is None else jnp.asarray(gate))
    tp = torch.from_numpy(p.copy())
    tst = {k: torch.tensor(v) for k, v in st.items()}
    bad = None if gate is None else torch.tensor(gate)
    out_p, out_st = tfu.param_update(base, tp, torch.from_numpy(g), torch.tensor(lr), tst,
                                     hyper, wd=wd, bad=bad)
    assert out_p is tp and out_st is tst  # in place
    assert tfu.KERNELS[base].launches == 0  # CPU tensors run the plain version

    if gate:
        # a rescued update leaves every buffer and scalar as it was, on both sides
        np.testing.assert_array_equal(tp.numpy(), p)
        np.testing.assert_array_equal(np.asarray(jp), p)
        for k, v in st.items():
            np.testing.assert_array_equal(tst[k].numpy(), v)
            np.testing.assert_array_equal(np.asarray(jst[k]), v)
        return
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL_UPDATE)
    assert sorted(tst) == sorted(jst)
    for k in tst:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL_UPDATE,
                                   err_msg=k)

    # the plain version is the rule, to the bit
    rp, rst = type(_rule_of(kind, wd))._update(
        _rule_of(kind, wd), torch.from_numpy(p), torch.from_numpy(g), torch.tensor(lr),
        {k: torch.tensor(v) for k, v in st.items()}, **hyper)
    assert torch.equal(tp, rp)
    for k in rst:
        assert torch.equal(tst[k], rst[k]), k


# ---------------------------------------------------------------------------
# tests/test_pallas_update.py's _trainer, on both sides
# ---------------------------------------------------------------------------
def _factories(pkg):
    return {
        "sgd": lambda ps: pkg.optimizer.SGD(learning_rate=1e-2, parameters=ps,
                                            weight_decay=0.01),
        "momentum": lambda ps: pkg.optimizer.Momentum(learning_rate=1e-2, momentum=0.9,
                                                      use_nesterov=True, parameters=ps),
        "adam": lambda ps: pkg.optimizer.Adam(learning_rate=1e-2, parameters=ps),
    }


def _mlp_data():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((4, 8)).astype(np.float32),
            rng.standard_normal((4, 3)).astype(np.float32))


def _jax_trainer(kind, nan_at=None, n=5):
    paddle.seed(0)
    model = paddle.nn.Sequential(
        paddle.nn.Linear(8, 128, bias_attr=False), paddle.nn.ReLU(),
        paddle.nn.Linear(128, 3))
    weights = {k: v.numpy() for k, v in model.state_dict().items()}
    opt = _factories(paddle)[kind](model.parameters())
    loss_fn = paddle.nn.MSELoss()
    xs, ys = _mlp_data()
    x, y = paddle.to_tensor(xs), paddle.to_tensor(ys)
    losses = []
    for i in range(n):
        loss = loss_fn(model(x), y)
        loss.backward()
        if nan_at is not None and i == nan_at:
            p0 = list(model.parameters())[0]
            p0.grad = paddle.to_tensor(np.full(p0.shape, np.nan, np.float32))
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    params = [np.asarray(p.numpy()) for p in model.parameters()]
    states = [{k: np.asarray(v) for k, v in (opt._accumulators.get(id(p)) or {}).items()}
              for p in model.parameters()]
    return weights, opt, losses, params, states


def _port_trainer(kind, weights, nan_at=None, n=5):
    model = torch.nn.Sequential(
        pt.nn.Linear(8, 128, bias_attr=False, device="cpu"), torch.nn.ReLU(),
        pt.nn.Linear(128, 3, device="cpu"))
    state_dict_from_numpy(model, weights)
    opt = _factories(pt)[kind](list(model.parameters()))
    xs, ys = _mlp_data()
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    losses = []
    for i in range(n):
        loss = torch.mean(torch.square(model(x) - y))
        loss.backward()
        if nan_at is not None and i == nan_at:
            p0 = next(model.parameters())
            p0.grad = torch.full_like(p0, float("nan"))
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    params = [p.detach().numpy().copy() for p in model.parameters()]
    states = [{k: v.numpy().copy() for k, v in (opt._accumulators.get(id(p)) or {}).items()}
              for p in model.parameters()]
    return opt, losses, params, states


# Five steps of an MLP on both sides: the forward and backward sum in other
# orders (about 1e-7 relative per op) and each update adds TOL_UPDATE's ulp;
# Adam's first steps move a parameter by about lr·sign(g), so a gradient near
# 0 that differs by 1e-7 moves its update by up to lr_t·Δg/(√v + eps). The
# largest differences measured at this seed are 2.2e-7 on a loss, 1.5e-7 on a
# parameter and 1.5e-7 on a state tensor (Adam); 1e-6 leaves a margin and is
# 1e4 times below one step's lr.
TOL_TRAIN = dict(atol=1e-6, rtol=1e-6)


def _compare_training(j, t):
    _, _, jl, jp, js = j
    _, tl, tp, ts = t
    np.testing.assert_allclose(tl, jl, **TOL_TRAIN)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, **TOL_TRAIN)
    for a, b in zip(ts, js):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TOL_TRAIN, err_msg=k)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_mlp_training_matches_the_jax_kernel_path(fused_on, kind):
    j = _jax_trainer(kind)
    t = _port_trainer(kind, j[0])
    _compare_training(j, t)
    assert t[0]._step_count == j[1]._step_count == 5


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_flag_on_equals_flag_off_bitwise(fused_on, kind):
    """On the CPU the plain versions are the rule, so the flag changes no bit."""
    weights = _jax_trainer(kind, n=0)[0]
    on = _port_trainer(kind, weights)
    pt.set_flags({"FLAGS_pallas_fused_update": False})
    off = _port_trainer(kind, weights)
    assert on[1] == off[1]
    for a, b in zip(on[2] + [s for st in on[3] for s in st.values()],
                    off[2] + [s for st in off[3] for s in st.values()]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_nan_step_is_skipped_like_the_jax_sentinel(fused_on, kind):
    """numeric_rescue=skip with a NaN-poisoned grad at step 2: params and
    state are untouched that step on both sides, and the rescue is counted."""
    paddle.set_flags({"FLAGS_numeric_rescue": "skip"})
    pt.set_flags({"FLAGS_numeric_rescue": "skip"})
    prof = fused_on
    j = _jax_trainer(kind, nan_at=2)
    t = _port_trainer(kind, j[0], nan_at=2)
    _compare_training(j, t)
    assert all(np.isfinite(p).all() for p in t[2])
    assert trescue.counters["numeric_rescues"] == prof.dispatch_counters()["numeric_rescues"] == 1
    # the skipped step changed nothing: two steps, then a poisoned one, leave
    # the params and state of two clean steps, to the bit
    three = _port_trainer(kind, j[0], nan_at=2, n=3)
    two = _port_trainer(kind, j[0], n=2)
    for a, b in zip(three[2] + [s for st in three[3] for s in st.values()],
                    two[2] + [s for st in two[3] for s in st.values()]):
        np.testing.assert_array_equal(a, b)


def test_lr_backoff_multiplies_the_lr(fused_on):
    paddle.set_flags({"FLAGS_numeric_rescue": "lr_backoff",
                      "FLAGS_numeric_rescue_lr_factor": 0.25})
    pt.set_flags({"FLAGS_numeric_rescue": "lr_backoff",
                  "FLAGS_numeric_rescue_lr_factor": 0.25})
    prof = fused_on
    j = _jax_trainer("adam", nan_at=1, n=3)
    t = _port_trainer("adam", j[0], nan_at=1, n=3)
    assert t[0].get_lr() == j[1].get_lr() == 1e-2 * 0.25
    assert trescue.counters["rescue_lr_backoffs"] == 1
    assert prof.dispatch_counters()["rescue_lr_backoffs"] == 1
    _compare_training(j, t)


def test_lr_backoff_under_a_scheduler_warns_and_skips(fused_on):
    pt.set_flags({"FLAGS_numeric_rescue": "lr_backoff"})
    w = torch.nn.Parameter(torch.ones(4))
    sched = pt.optimizer.lr.StepDecay(0.1, step_size=2)
    opt = pt.optimizer.SGD(learning_rate=sched, parameters=[w])
    w.grad = torch.full((4,), float("inf"))
    with pytest.warns(UserWarning, match="scheduler-driven"):
        opt.step()
    assert torch.equal(w.detach(), torch.ones(4))
    assert trescue.counters == {"numeric_rescues": 1, "rescue_lr_backoffs": 0}


def test_abort_raises_floating_point_error(fused_on):
    pt.set_flags({"FLAGS_numeric_rescue": "abort"})
    w = torch.nn.Parameter(torch.ones(4))
    opt = pt.optimizer.Adam(learning_rate=0.1, parameters=[w])
    w.grad = torch.tensor([1.0, float("nan"), 0.0, 0.0])
    with pytest.raises(FloatingPointError, match="numeric_rescue=abort"):
        opt.step()
    assert torch.equal(w.detach(), torch.ones(4))
    pt.set_flags({"FLAGS_numeric_rescue": "bogus"})
    w.grad = torch.tensor([1.0, float("nan"), 0.0, 0.0])
    with pytest.raises(ValueError, match="unknown FLAGS_numeric_rescue policy"):
        opt.step()


def test_eligibility_rules():
    from paddle_tpu.optimizer import optimizer as jopt

    for pkg_fu, mod in ((jfu, jopt), (tfu, pt.optimizer.optimizer)):
        assert pkg_fu.rule_kind(mod.SGD) == "sgd"
        assert pkg_fu.rule_kind(mod.Momentum) == "momentum"
        assert pkg_fu.rule_kind(mod.Adam) == "adam"
        assert pkg_fu.rule_kind(mod.AdamW) is None  # decoupled decay: the rule's ops

        class CustomSGD(mod.SGD):
            def _update(self, p, g, lr, state):
                return p, state

        assert pkg_fu.rule_kind(CustomSGD) is None

    p = torch.zeros(8, 128)
    assert tfu.supported("sgd", p, p, {})
    assert not tfu.supported("sgd", p.bfloat16(), p.bfloat16(), {})
    assert not tfu.supported(None, p, p, {})
    assert not tfu.supported("sgd", p, p.bfloat16(), {})  # grad not cast yet
    assert not tfu.supported("sgd", p.t(), p.t(), {})  # not contiguous
    assert not tfu.supported("sgd", p[:0], p[:0], {})  # empty
    assert not tfu.supported("momentum", p, p, {"velocity": p.t().contiguous().t()})
    assert not tfu.supported("adam", p, p, {"moment1": p.double(), "moment2": p,
                                            "beta1_pow": torch.ones(()),
                                            "beta2_pow": torch.ones(())})
    # a ragged size the TPU's (8, 128) tile refuses and the port takes
    ragged = jnp.zeros((7, 129), jnp.float32)
    assert not jfu.supported("sgd", ragged, ragged, {})
    r = torch.zeros(7, 129)
    assert tfu.supported("sgd", r, r, {}) and tfu.supported("adam", r[0, :1], r[0, :1], {})


def test_ragged_parameter_updates_like_the_jax_rule(fused_on):
    """A (7, 129) parameter, which the JAX kernel leaves to the lax rule,
    goes through the port's fused path and lands where the JAX rule does."""
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((7, 129)).astype(np.float32)
    g = rng.standard_normal((7, 129)).astype(np.float32)
    paddle.seed(0)
    jlin = paddle.nn.Linear(7, 129, bias_attr=False)
    jlin.weight.set_value(w0)
    jw = jlin.weight
    jopt = paddle.optimizer.Adam(learning_rate=1e-2, parameters=[jw], weight_decay=0.01)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = pt.optimizer.Adam(learning_rate=1e-2, parameters=[tw], weight_decay=0.01)
    for _ in range(2):
        jw.grad = paddle.to_tensor(g)
        jopt.step()
        tw.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(), **TOL_UPDATE)


def test_telemetry_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        pt.optimizer.optimizer.make_fused_update(pt.optimizer.SGD(parameters=[]), [],
                                                 telemetry=True)


def test_other_devices_raise():
    p = torch.zeros(4, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        tfu.fused_sgd(p, p, torch.zeros((), device="meta"), wd=0.0)


# ---------------------------------------------------------------------------
# the slice as a whole: f32 GPT, Adam + L2Decay + global-norm clip + warmup
# ---------------------------------------------------------------------------
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
               dropout=0.0, attn_dropout=0.0)


def _gpt_run(pkg, model, ids, n_steps=3):
    crit = (jgpt if pkg is paddle else tgpt).GPTPretrainingCriterion()
    sched = pkg.optimizer.lr.LinearWarmup(
        pkg.optimizer.lr.CosineAnnealingDecay(1e-3, T_max=10), warmup_steps=2,
        start_lr=0.0, end_lr=1e-3)
    opt = pkg.optimizer.Adam(learning_rate=sched, parameters=model.parameters(),
                             weight_decay=pkg.regularizer.L2Decay(0.01),
                             grad_clip=pkg.nn.ClipGradByGlobalNorm(1.0))
    to = paddle.to_tensor if pkg is paddle else torch.as_tensor
    losses, lrs = [], []
    for _ in range(n_steps):
        loss = crit(model(to(ids[:, :-1])), to(ids[:, 1:]))
        loss.backward()
        lrs.append(opt.get_lr())
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.detach()))
    return opt, losses, lrs


def test_f32_gpt_adam_slice_matches_the_jax_package(fused_on):
    paddle.set_flags({"FLAGS_numeric_rescue": "skip", "FLAGS_use_flash_attention": True})
    pt.set_flags({"FLAGS_numeric_rescue": "skip", "FLAGS_use_flash_attention": True})
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**GPT_CFG))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**GPT_CFG), device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    ids = np.random.default_rng(5).integers(0, GPT_CFG["vocab_size"], (2, 65))
    jopt, jl, jlr = _gpt_run(paddle, jm, ids)
    topt, tl, tlr = _gpt_run(pt, tm, ids)
    assert tlr == jlr and tlr[0] == 0.0 and tlr[2] == 1e-3  # warmup, then the cosine
    # losses of order 5 in f32, summed in other orders: ~1e-6 of themselves
    # (tests/test_torch_train.py's TOL_LOSS)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-6)
    assert trescue.counters["numeric_rescues"] == 0
    # Parameters after two real Adam steps (the first has lr 0): each moves
    # by about lr·sign(g); gradients that differ by ~1e-7 between the
    # frameworks (tests/test_torch_train.py) move an update of a parameter
    # whose gradient is near 0 by up to lr_t·Δg/eps. The clip scales every
    # gradient by the same f32 factor on both sides. Measured: 1.4e-6 apart
    # at this seed (m 3.5e-8, v 3.3e-11); 2e-5 is test_torch_train.py's Adam
    # tolerance.
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n].numpy(), atol=2e-5, rtol=0,
                                   err_msg=n)
        jst, tst = jopt._accumulators[id(jparams[n])], topt._accumulators[id(p)]
        # the moments follow the clipped gradients (test_torch_train.py's
        # tolerances for m and v)
        np.testing.assert_allclose(tst["moment1"].numpy(), np.asarray(jst["moment1"]),
                                   atol=1e-6, rtol=0, err_msg=n)
        np.testing.assert_allclose(tst["moment2"].numpy(), np.asarray(jst["moment2"]),
                                   atol=1e-8, rtol=0, err_msg=n)
        np.testing.assert_allclose(tst["beta1_pow"].numpy(), np.asarray(jst["beta1_pow"]),
                                   rtol=1e-7)
