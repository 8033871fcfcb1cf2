"""The port's optimizer surface against the JAX package's, on the CPU: the LR
schedulers, the grad clips, SGD and Momentum state, the compiled step with a
grad clip, and Adamax, Adagrad, Adadelta, RMSProp, Lamb and Lars. Inputs
come from numpy with a seed; each tolerance is stated where it is used, with
its reason."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn.layer_base import Parameter as JParameter
from paddle_tpu.ops.pallas import fused_update as jfu
from paddle_tpu.parallel.topology import use_mesh
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.kernels import fused_update as tfu

SCHEDULERS = {
    "noam": lambda lr: lr.NoamDecay(d_model=64, warmup_steps=5, learning_rate=1.0),
    "piecewise": lambda lr: lr.PiecewiseDecay([5, 10], [0.1, 0.05, 0.01]),
    "natural_exp": lambda lr: lr.NaturalExpDecay(0.1, gamma=0.1),
    "inverse_time": lambda lr: lr.InverseTimeDecay(0.1, gamma=0.1),
    "polynomial": lambda lr: lr.PolynomialDecay(0.1, decay_steps=10, end_lr=1e-4, power=2.0),
    "polynomial_cycle": lambda lr: lr.PolynomialDecay(0.1, decay_steps=10, cycle=True),
    "linear_warmup": lambda lr: lr.LinearWarmup(0.1, warmup_steps=5, start_lr=0.0,
                                                end_lr=0.1),
    "warmup_cosine_inner": lambda lr: lr.LinearWarmup(
        lr.CosineAnnealingDecay(0.1, T_max=20, eta_min=1e-3), warmup_steps=5,
        start_lr=1e-3, end_lr=0.1),
    "exponential": lambda lr: lr.ExponentialDecay(0.1, gamma=0.9),
    "multi_step": lambda lr: lr.MultiStepDecay(0.1, milestones=[5, 12], gamma=0.5),
    "step": lambda lr: lr.StepDecay(0.1, step_size=4, gamma=0.5),
    "lambda": lambda lr: lr.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "cosine": lambda lr: lr.CosineAnnealingDecay(0.1, T_max=10),
    "one_cycle": lambda lr: lr.OneCycleLR(0.1, total_steps=30),
    "one_cycle_linear": lambda lr: lr.OneCycleLR(0.1, total_steps=30, anneal_strategy="linear"),
    "cyclic": lambda lr: lr.CyclicLR(0.01, 0.1, step_size_up=5, mode="triangular2"),
    "cyclic_exp": lambda lr: lr.CyclicLR(0.01, 0.1, step_size_up=4, step_size_down=6,
                                         mode="exp_range", exp_gamma=0.97),
    "warmup_cosine": lambda lr: lr.WarmupCosine(0.1, warmup_steps=5, decay_steps=25),
    "multiplicative": lambda lr: lr.MultiplicativeDecay(0.1, lambda e: 0.9),
    "reduce_on_plateau": lambda lr: lr.ReduceOnPlateau(0.1, patience=2, factor=0.5,
                                                       cooldown=1),
}

# a loss that falls, stalls and rises again, for ReduceOnPlateau
METRICS = [1.0 / (1 + i) if i < 10 else 0.1 + 0.01 * (i % 3) for i in range(30)]


@pytest.fixture(autouse=True)
def one_device():
    """The JAX reference on one device, whatever mesh an earlier test left
    installed: its tensor-parallel layers constrain to an installed mesh."""
    with use_mesh(None):
        yield


def _advance(sched, i):
    if hasattr(sched, "_is_better"):  # ReduceOnPlateau reads a metric
        sched.step(METRICS[i])
    else:
        sched.step()


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_the_jax_scheduler(name):
    """30 steps, exact: the port's lr.py is the JAX module's plain Python."""
    make = SCHEDULERS[name]
    ref, out = make(paddle.optimizer.lr), make(pt.optimizer.lr)
    resumed = None
    for i in range(30):
        assert out() == ref(), (name, i)
        if i == 15:  # a state_dict round-trip, mid-run, into a fresh scheduler
            sd = out.state_dict()
            assert sd == ref.state_dict()
            resumed = make(pt.optimizer.lr)
            resumed.set_state_dict(sd)
        if resumed is not None:
            assert resumed() == out(), (name, i)
            _advance(resumed, i)
        _advance(ref, i)
        _advance(out, i)
    assert math.isfinite(out())


def test_optimizer_reads_and_saves_its_scheduler():
    w = torch.nn.Parameter(torch.ones(3))
    sched = pt.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    opt = pt.optimizer.SGD(learning_rate=sched, parameters=[w])
    lrs = []
    for _ in range(5):
        w.grad = torch.ones(3)
        lrs.append(opt.get_lr())
        opt.step()
        sched.step()
    assert lrs == [0.1, 0.1, 0.05, 0.05, 0.025]
    # p moved by the sum of the lrs it was given
    np.testing.assert_allclose(w.detach().numpy(), 1 - sum(lrs), rtol=1e-6)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    sd = opt.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 5
    fresh_sched = pt.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    fresh = pt.optimizer.SGD(learning_rate=fresh_sched, parameters=[w])
    fresh.set_dict(sd)  # the alias of set_state_dict
    assert fresh.get_lr() == opt.get_lr() == 0.025 and fresh._step_count == 5
    assert fresh._lr is fresh_sched


def _grads(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * 3 for s in ((16, 8), (8,), (33,))]


CLIPS = {
    "value": lambda nn: nn.ClipGradByValue(2.0),
    "value_min": lambda nn: nn.ClipGradByValue(max=1.5, min=-0.5),
    "norm_clips": lambda nn: nn.ClipGradByNorm(5.0),
    "norm_passes": lambda nn: nn.ClipGradByNorm(1e3),
    "global_norm_clips": lambda nn: nn.ClipGradByGlobalNorm(1.0),
    "global_norm_passes": lambda nn: nn.ClipGradByGlobalNorm(1e3),
    "alias": lambda nn: nn.clip.GradientClipByGlobalNorm(2.0),
}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clip_matches_the_jax_clip(name):
    grads = _grads(0)
    jpairs = [(paddle.to_tensor(np.zeros_like(g)), paddle.to_tensor(g)) for g in grads]
    jpairs.insert(1, (paddle.to_tensor(np.zeros(4, np.float32)), None))
    tpairs = [(torch.zeros(g.shape), torch.from_numpy(g)) for g in grads]
    tpairs.insert(1, (torch.zeros(4), None))
    ref = CLIPS[name](paddle.nn)(jpairs)
    out = CLIPS[name](pt.nn)(tpairs)
    assert len(out) == len(ref) == 4
    assert out[1][1] is None and ref[1][1] is None  # a None grad stays None
    for (tp, tg), (jp, jg), (p0, _) in zip(out, ref, tpairs):
        assert tp is p0
        if tg is None:
            continue
        assert tg.dtype == torch.float32 and tuple(tg.shape) == tuple(jg.shape)
        # the norms are f32 sums over at most 128 values of order 3, which
        # the frameworks may take in other orders: ~1e-7 relative on the
        # scale, on grads of order 3 (bitwise equal at this seed)
        np.testing.assert_allclose(tg.numpy(), jg.numpy(), atol=1e-6, rtol=1e-6)
    if name.endswith("passes"):
        for (_, tg), g in zip([out[0], out[2], out[3]], grads):
            np.testing.assert_array_equal(tg.numpy(), g)


def test_global_norm_clip_keeps_bf16_grads_bf16():
    """The norm is taken in f32 over both grads, and a bf16 grad is scaled in
    f32 and rounded once to bf16, as the JAX clip's promotion does."""
    g = torch.from_numpy(_grads(1)[0])
    gb = g.bfloat16()
    out = pt.nn.ClipGradByGlobalNorm(1.0)([(None, gb), (None, g)])
    assert out[0][1].dtype == torch.bfloat16 and out[1][1].dtype == torch.float32
    norm = torch.sqrt(torch.sum(torch.square(gb.float())) + torch.sum(torch.square(g)))
    scale = 1.0 / norm.item()
    assert norm.item() > 1.0
    np.testing.assert_allclose(out[1][1].numpy(), (g * scale).numpy(), rtol=1e-6)
    np.testing.assert_allclose(out[0][1].float().numpy(),
                               (gb.float() * scale).bfloat16().float().numpy(), rtol=8e-3)


def _small_gpt():
    cfg = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
               dropout=0.0, attn_dropout=0.0)
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**cfg))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    ids = np.random.default_rng(7).integers(0, cfg["vocab_size"], (2, 65))
    return jm, tm, ids


@pytest.mark.parametrize("kind", ["sgd", "momentum"])
def test_sgd_and_momentum_state_dict_key_names(kind):
    jm, tm, ids = _small_gpt()

    def make(pkg, model):
        if kind == "sgd":
            return pkg.optimizer.SGD(learning_rate=1e-2, parameters=model.parameters())
        return pkg.optimizer.Momentum(learning_rate=1e-2, momentum=0.9,
                                      parameters=model.parameters(), use_nesterov=True,
                                      weight_decay=pkg.regularizer.L2Decay(1e-4))

    jopt, topt = make(paddle, jm), make(pt, tm)
    jloss = jgpt.GPTPretrainingCriterion()(jm(paddle.to_tensor(ids[:, :-1])),
                                           paddle.to_tensor(ids[:, 1:]))
    jopt.minimize(jloss)
    tloss = tgpt.GPTPretrainingCriterion()(tm(torch.as_tensor(ids[:, :-1])),
                                           torch.as_tensor(ids[:, 1:]))
    topt.minimize(tloss)  # backward and step
    topt.clear_gradients()
    assert all(p.grad is None for p in tm.parameters())
    jnames = [p.name for p in jm.parameters()]
    tnames = [p.param_name for p in tm.parameters()]

    def normalised(keys, names):
        index = {name: i for i, name in enumerate(names)}
        out = set()
        for k in keys:
            head, _, tail = k.partition(".")
            out.add(k if not tail else f"#{index[head]}.{tail}")
        return out

    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert normalised(tsd, tnames) == normalised(jsd, jnames)
    assert tsd["_step_count"] == jsd["_step_count"] == 1
    if kind == "momentum":
        assert len(tsd) == 1 + len(tnames)
        # velocity after one step is the (decayed) gradient: the frameworks'
        # gradients agree to ~1e-7 (tests/test_torch_train.py)
        for tn, jn in zip(tnames, jnames):
            np.testing.assert_allclose(tsd[f"{tn}.velocity"].numpy(),
                                       jsd[f"{jn}.velocity"].numpy(), atol=1e-6, rtol=0)
    else:
        assert set(tsd) == {"_step_count"}


def test_compile_train_step_with_a_grad_clip_matches_the_jax_step():
    jm, tm, ids = _small_gpt()
    jcrit, tcrit = jgpt.GPTPretrainingCriterion(), tgpt.GPTPretrainingCriterion()
    jopt = paddle.optimizer.Adam(learning_rate=1e-3, parameters=jm.parameters(),
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    topt = pt.optimizer.Adam(learning_rate=1e-3, parameters=tm.parameters(),
                             grad_clip=pt.nn.ClipGradByGlobalNorm(0.5))
    jstep = paddle.jit.compile_train_step(jm, lambda lo, lb: jcrit(lo, lb), jopt)
    tstep = pt.jit.compile_train_step(tm, lambda lo, lb: tcrit(lo, lb), topt)
    x, y = ids[:, :-1], ids[:, 1:]
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))) for _ in range(3)]
    tl = [float(tstep(torch.as_tensor(x), torch.as_tensor(y))) for _ in range(3)]
    # tests/test_torch_train.py's TOL_LOSS and Adam parameter tolerance, for
    # the reasons stated there; the clip scales every gradient by one f32
    # factor on both sides
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-6)
    assert tl[2] < tl[0]
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n].numpy(), atol=2e-5, rtol=0,
                                   err_msg=n)
        # the first moment sums (1 - b1)-weighted clipped gradients: the
        # gradients' global norm is 1.63 at this seed, so the 0.5 clip scales
        # them by ~0.3 and a step without it would miss by far more
        np.testing.assert_allclose(topt._accumulators[id(p)]["moment1"].numpy(),
                                   np.asarray(jopt._accumulators[id(jparams[n])]["moment1"]),
                                   atol=1e-6, rtol=0, err_msg=n)


# The six rules without a fused kernel, each with weight decay (L2 folded
# into g, or the rule's own decay) and a global-norm clip where the JAX
# optimizer takes them. Lars excludes the bias by name; Lamb is given an
# exclusion function, which both packages ignore.
NEW_OPTIMIZERS = {
    "adamax": lambda pkg, ps: pkg.optimizer.Adamax(
        learning_rate=1e-2, parameters=ps, weight_decay=0.01,
        grad_clip=pkg.nn.ClipGradByGlobalNorm(5.0)),
    "adagrad": lambda pkg, ps: pkg.optimizer.Adagrad(
        0.1, parameters=ps, weight_decay=pkg.regularizer.L2Decay(0.01),
        initial_accumulator_value=0.1, grad_clip=pkg.nn.ClipGradByGlobalNorm(5.0)),
    "adadelta": lambda pkg, ps: pkg.optimizer.Adadelta(
        learning_rate=1.0, rho=0.9, parameters=ps, weight_decay=0.01,
        grad_clip=pkg.nn.ClipGradByGlobalNorm(5.0)),
    "rmsprop": lambda pkg, ps: pkg.optimizer.RMSProp(
        1e-2, parameters=ps, weight_decay=0.01, grad_clip=pkg.nn.ClipGradByGlobalNorm(5.0)),
    "rmsprop_centered_momentum": lambda pkg, ps: pkg.optimizer.RMSProp(
        1e-2, rho=0.9, momentum=0.9, centered=True, parameters=ps, weight_decay=0.01,
        grad_clip=pkg.nn.ClipGradByGlobalNorm(5.0)),
    "lamb": lambda pkg, ps: pkg.optimizer.Lamb(
        learning_rate=1e-2, lamb_weight_decay=0.01, parameters=ps,
        grad_clip=pkg.nn.ClipGradByGlobalNorm(5.0),
        exclude_from_weight_decay_fn=lambda name: "bias" in name),
    "lars": lambda pkg, ps: pkg.optimizer.Lars(
        learning_rate=0.1, momentum=0.9, lars_coeff=0.01, lars_weight_decay=0.01,
        parameters=ps, grad_clip=pkg.nn.ClipGradByGlobalNorm(5.0),
        exclude_from_weight_decay=["bias"]),
}
PARAM_NAMES = ["fc.weight", "fc.bias", "emb.weight"]
# The rules are elementwise f32 arithmetic in the JAX rule's order; XLA:CPU
# contracts some of it into FMAs, which moves a result by an ulp here and
# there (tests/test_torch_fused_update.py's TOL_UPDATE, for the same reason)
TOL_UPDATE = dict(atol=5e-7, rtol=1e-6)


def _named_params(seed=10):
    """The same three f32 parameters in both packages, with the same names
    (``p.name`` in the JAX package, ``param_name`` in the port)."""
    values = _grads(seed)
    jps = [JParameter(paddle.to_tensor(v)._value, name=n) for v, n in zip(values, PARAM_NAMES)]
    tps = []
    for v, n in zip(values, PARAM_NAMES):
        p = torch.nn.Parameter(torch.from_numpy(v.copy()))
        p.param_name = n
        tps.append(p)
    return jps, tps


def _steps(jopt, topt, jps, tps, n=3):
    for i in range(n):
        for jp, tp, g in zip(jps, tps, _grads(20 + i)):
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()


def _assert_state_close(jopt, topt, jps, tps):
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), err_msg=tp.param_name,
                                   **TOL_UPDATE)
        jst, tst = jopt._accumulators[id(jp)], topt._accumulators[id(tp)]
        assert sorted(tst) == sorted(jst)
        for k, v in tst.items():
            assert v.dtype == torch.float32 and tuple(v.shape) == tuple(np.shape(jst[k])), k
            np.testing.assert_allclose(v.numpy(), np.asarray(jst[k]), **TOL_UPDATE,
                                       err_msg=f"{tp.param_name}.{k}")


@pytest.mark.parametrize("name", sorted(NEW_OPTIMIZERS))
def test_new_optimizers_match_the_jax_rules(name):
    """Three f32 steps on the same gradients, through the eager step() (the
    clip, then the update) on both sides: parameters and every state tensor."""
    jps, tps = _named_params()
    jopt = NEW_OPTIMIZERS[name](paddle, jps)
    topt = NEW_OPTIMIZERS[name](pt, tps)
    _steps(jopt, topt, jps, tps)
    assert jopt._step_count == topt._step_count == 3
    _assert_state_close(jopt, topt, jps, tps)
    moved = [np.abs(tp.detach().numpy() - v).max() for tp, v in zip(tps, _grads(10))]
    assert min(moved) > 1e-5, moved


def test_lars_excludes_by_param_name():
    """The bias decays in neither package, by its name; with the exclusion
    dropped, it does, and lands elsewhere."""
    out = {}
    for exclude in (["bias"], None):
        jps, tps = _named_params()
        kw = dict(learning_rate=0.1, momentum=0.9, lars_coeff=0.01, lars_weight_decay=0.5,
                  exclude_from_weight_decay=exclude)
        jopt = paddle.optimizer.Lars(parameters=jps, **kw)
        topt = pt.optimizer.Lars(parameters=tps, **kw)
        assert topt._per_param_hyper(tps[1]) == ({"wd": 0.0} if exclude else {})
        assert topt._per_param_hyper(tps[0]) == {}
        _steps(jopt, topt, jps, tps, n=2)
        _assert_state_close(jopt, topt, jps, tps)
        out[bool(exclude)] = tps[1].detach().numpy()
    assert np.abs(out[True] - out[False]).max() > 1e-4


@pytest.mark.parametrize("name", sorted(NEW_OPTIMIZERS))
def test_new_optimizer_state_dict_round_trips(name):
    """The JAX key names; a fresh optimizer loaded from the dict steps on as
    the original does, bit for bit."""
    jps, tps = _named_params()
    jopt, topt = NEW_OPTIMIZERS[name](paddle, jps), NEW_OPTIMIZERS[name](pt, tps)
    _steps(jopt, topt, jps, tps, n=2)
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert sorted(tsd) == sorted(jsd) and tsd["_step_count"] == 2
    clones = []
    for tp in tps:
        c = torch.nn.Parameter(tp.detach().clone())
        c.param_name = tp.param_name
        clones.append(c)
    fresh = NEW_OPTIMIZERS[name](pt, clones)
    fresh.set_state_dict(tsd)
    for opt, ps in ((topt, tps), (fresh, clones)):
        for p, g in zip(ps, _grads(30)):
            p.grad = torch.from_numpy(g)
        opt.step()
    for a, b in zip(tps, clones):
        assert torch.equal(a, b)
        for k, v in topt._accumulators[id(a)].items():
            assert torch.equal(v, fresh._accumulators[id(b)][k]), k


@pytest.mark.parametrize("name", sorted(NEW_OPTIMIZERS))
def test_new_optimizers_take_the_plain_rule_with_the_fused_flag_on(name, monkeypatch):
    """No fused kernel: rule_kind is None in both packages, and with
    FLAGS_pallas_fused_update on the eager step runs the rule's torch ops."""
    jps, tps = _named_params()
    topt = NEW_OPTIMIZERS[name](pt, tps)
    assert tfu.rule_kind(type(topt)) is None
    assert jfu.rule_kind(type(NEW_OPTIMIZERS[name](paddle, jps))) is None

    def no_kernel(*a, **kw):
        raise AssertionError("a fused kernel ran")

    monkeypatch.setattr(tfu, "param_update", no_kernel)
    pt.set_flags({"FLAGS_pallas_fused_update": True})
    try:
        for p, g in zip(tps, _grads(40)):
            p.grad = torch.from_numpy(g)
        topt.step()
    finally:
        pt.set_flags({"FLAGS_pallas_fused_update": False})
    assert topt._step_count == 1


@pytest.mark.parametrize("name", ["lars", "rmsprop_centered_momentum"])
def test_new_optimizers_through_compile_train_step_match_jax(name):
    """The compiled step's update (the rule alone, after the clip) on the
    small GPT of the clip test above: losses and parameters over 3 steps
    (Lamb's compiled steps: tests/test_torch_bert.py)."""
    jm, tm, ids = _small_gpt()
    jcrit, tcrit = jgpt.GPTPretrainingCriterion(), tgpt.GPTPretrainingCriterion()
    jopt = NEW_OPTIMIZERS[name](paddle, jm.parameters())
    topt = NEW_OPTIMIZERS[name](pt, tm.parameters())
    jstep = paddle.jit.compile_train_step(jm, lambda lo, lb: jcrit(lo, lb), jopt)
    tstep = pt.jit.compile_train_step(tm, lambda lo, lb: tcrit(lo, lb), topt)
    x, y = ids[:, :-1], ids[:, 1:]
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))) for _ in range(3)]
    tl = [float(tstep(torch.as_tensor(x), torch.as_tensor(y))) for _ in range(3)]
    # tests/test_torch_train.py's TOL_LOSS; gradients agree to ~1e-7 between
    # the frameworks (f32 sums in other orders), and these rules scale them
    # by at most ~1 (RMSProp's g/sqrt(ms) is ~3 in its first step)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-6)
    assert tl[2] < tl[0]
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n].numpy(), atol=1e-5, rtol=0,
                                   err_msg=n)
