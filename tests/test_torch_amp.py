"""The port's AMP against the JAX package's, on the CPU: O1 ``auto_cast`` and
its cast lists, and ``GradScaler`` (``tests/test_amp.py``'s cases, held
against the JAX scaler step by step).

The GPT is tests/test_torch_train.py's (2 layers, hidden 64, 4 heads, vocab
128, dropout 0) with its weights carried from the JAX model by
``convert.state_dict_from_numpy``; inputs come from numpy with a seed. The
JAX package runs its Pallas flash kernel in interpret mode, the port its
kernel's plain version.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel.topology import use_mesh
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.models import gpt as tgpt

SEED = 0
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
           dropout=0.0, attn_dropout=0.0)
BATCH = 2
LR = 1e-3
# The O2 step's tolerance of tests/test_torch_train.py, the reference's bf16
# one: bf16 and fp16 activations rounded at different places in the two
# frameworks (torch rounds every op's result, XLA on the CPU may keep f32
# between fused elementwise ops) move logits and the loss by a few ulps of
# the low dtype, ~1e-2 at magnitude 1.
TOL_LOW = 3e-2


@pytest.fixture(autouse=True)
def one_device():
    """The JAX reference on one device, whatever mesh an earlier test left
    installed: its tensor-parallel layers constrain to an installed mesh."""
    with use_mesh(None):
        yield


@pytest.fixture(autouse=True)
def flash_on():
    paddle.set_flags({"FLAGS_use_flash_attention": True})
    pt.set_flags({"FLAGS_use_flash_attention": True})


def _models():
    paddle.seed(SEED)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**CFG), device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed=1):
    ids = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                               (BATCH, CFG["max_seq_len"] + 1))
    return ids[:, :-1], ids[:, 1:]


def _name(dtype):
    return str(dtype).split(".")[-1]


def _recorder(seen, name):
    """A forward hook noting a layer's first input and output dtypes (once:
    the head's tied embedding runs once more); it returns None, so the
    output stays."""
    def hook(layer, ins, out):
        seen.setdefault(name, (_name(ins[0].dtype), _name(out.dtype)))
    return hook


def _jax_dtypes(jm, x, y, **amp):
    """{sublayer: (first input's dtype, output's dtype)} of a forward under
    auto_cast, and the loss's dtype, in the JAX package."""
    seen = {}
    hooks = [layer.register_forward_post_hook(_recorder(seen, name))
             for name, layer in jm.named_sublayers()]
    with paddle.amp.auto_cast(**amp):
        loss = jgpt.GPTPretrainingCriterion()(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    for h in hooks:
        h.remove()
    return seen, _name(loss.dtype)


def _port_dtypes(tm, x, y, **amp):
    seen = {}
    hooks = [module.register_forward_hook(_recorder(seen, name))
             for name, module in tm.named_modules() if name]
    with pt.amp.auto_cast(**amp):
        loss = tgpt.GPTPretrainingCriterion()(tm(torch.as_tensor(x)), torch.as_tensor(y))
    for h in hooks:
        h.remove()
    return seen, _name(loss.dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("lists", [
    {},
    {"custom_black_list": ["linear"]},
    {"custom_white_list": ["layer_norm", "softmax_with_cross_entropy"]},
    {"custom_white_list": ["matmul"], "custom_black_list": ["matmul", "flash_sdpa"]},
])
def test_o1_activation_dtypes_match_the_jax_package(dtype, lists):
    jm, tm = _models()
    x, y = _batch()
    ref, ref_loss = _jax_dtypes(jm, x, y, level="O1", dtype=dtype, **lists)
    out, out_loss = _port_dtypes(tm, x, y, level="O1", dtype=dtype, **lists)
    assert out == ref and out_loss == ref_loss
    layer = {k: v for k, v in out.items() if k.startswith("gpt.layers.0")}
    if not lists:  # what the lists give one decoder layer
        assert layer["gpt.layers.0.ln1"] == ("float32", "float32")
        assert layer["gpt.layers.0.attn.qkv_proj"] == ("float32", dtype)
        # the attention's output is low; out_proj's bias add promotes to f32
        assert layer["gpt.layers.0.attn.out_proj"] == (dtype, "float32")
        assert layer["gpt.layers.0.mlp.fc1"] == ("float32", dtype)
        assert layer["gpt.layers.0.mlp.fc2"] == (dtype, "float32")
        assert layer["gpt.layers.0"] == ("float32", "float32")
        assert out_loss == "float32"
    # outside the block nothing is cast
    plain, plain_loss = _port_dtypes(tm, x, y, enable=False)
    assert {v for pair in plain.values() for v in pair} == {"float32", "int64"}


def _worst_step_errors(grads, updates, jgrads, jupdates):
    """The worst leaf's gradient error and parameter-update error, each
    relative to the leaf's largest JAX value. Updates are compared where the
    gradient's sign is settled: AdamW's first step moves an element by about
    lr * sign(g), so one whose gradient lies within the gradient tolerance of
    0 may move either way in either package."""
    worst_g = worst_u = 0.0
    for n, jg in jgrads.items():
        g, du, jdu = grads[n], updates[n], jupdates[n]
        worst_g = max(worst_g, np.abs(g - jg).max() / np.abs(jg).max())
        settled = np.abs(jg) > 2 * TOL_LOW * np.abs(jg).max()
        worst_u = max(worst_u, np.abs(du - jdu)[settled].max() / np.abs(jdu).max())
    return worst_g, worst_u


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_one_o1_step_matches_the_jax_step(dtype):
    jm, tm = _models()
    x, y = _batch(seed=2)
    jopt = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                                  weight_decay=0.01)
    topt = pt.optimizer.AdamW(learning_rate=LR, parameters=tm.parameters(), weight_decay=0.01)
    with paddle.amp.auto_cast(level="O1", dtype=dtype):
        jloss = jgpt.GPTPretrainingCriterion()(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    with pt.amp.auto_cast(level="O1", dtype=dtype):
        tloss = tgpt.GPTPretrainingCriterion()(tm(torch.as_tensor(x)), torch.as_tensor(y))
    assert abs(tloss.item() - float(jloss)) <= TOL_LOW
    jloss.backward()
    tloss.backward()
    jparams = dict(jm.named_parameters())
    p0 = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for p in tm.parameters():
        assert p.dtype == p.grad.dtype == torch.float32  # O1 keeps f32 parameters
    jgrads = {n: p.grad.numpy() for n, p in jparams.items()}
    grads = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
    # a control stepped with the port's gradients negated
    flipped = copy.deepcopy(tm)
    for p, q in zip(flipped.parameters(), tm.parameters()):
        p.grad = -q.grad
    pt.optimizer.AdamW(learning_rate=LR, parameters=flipped.parameters(),
                       weight_decay=0.01).step()
    jp0 = {n: p.numpy().copy() for n, p in jparams.items()}
    jopt.step()
    topt.step()
    jupdates = {n: p.numpy() - jp0[n] for n, p in jparams.items()}
    updates = {n: (p.detach() - p0[n]).numpy() for n, p in tm.named_parameters()}
    worst_g, worst_u = _worst_step_errors(grads, updates, jgrads, jupdates)
    assert worst_g <= TOL_LOW and worst_u <= TOL_LOW, (worst_g, worst_u)
    # the negative controls: a skipped step and a wrong-signed gradient fail
    skipped = {n: np.zeros_like(u) for n, u in updates.items()}
    assert _worst_step_errors(grads, skipped, jgrads, jupdates)[1] > TOL_LOW
    wrong = _worst_step_errors({n: -g for n, g in grads.items()},
                               {n: (p.detach() - p0[n]).numpy()
                                for n, p in flipped.named_parameters()}, jgrads, jupdates)
    assert min(wrong) > TOL_LOW, wrong


def test_o1_casts_matmul_and_keeps_the_black_list_f32():
    # tests/test_amp.py's first two cases, in both packages
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((4, 8)).astype(np.float32), rng.standard_normal((8, 4))
    w = w.astype(np.float32)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jout = JF.linear(paddle.to_tensor(x), paddle.to_tensor(w))
        jsoft = JF.softmax(paddle.to_tensor(x).astype("bfloat16"))
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        tout = TF.linear(torch.from_numpy(x), torch.from_numpy(w))
        tsoft = TF.softmax(torch.from_numpy(x).to(torch.bfloat16))
    assert _name(tout.dtype) == _name(jout.dtype) == "bfloat16"
    assert _name(tsoft.dtype) == _name(jsoft.dtype) == "float32"
    assert TF.linear(torch.from_numpy(x), torch.from_numpy(w)).dtype == torch.float32
    np.testing.assert_allclose(tout.float().numpy(), jout.astype("float32").numpy(),
                               atol=TOL_LOW, rtol=TOL_LOW)
    assert not pt.amp.amp_active() and pt.amp.amp_dtype() == "bfloat16"
    with pt.amp.amp_guard(level="O2"):
        assert pt.amp.amp_active()
        # O2 casts nothing per op: decorate casts the model
        assert pt.amp.maybe_cast_inputs("linear", [torch.ones(1)])[0].dtype == torch.float32
    assert pt.amp.autocast is pt.amp.auto_cast
    assert pt.amp.is_bfloat16_supported() and pt.amp.is_float16_supported()


def _linear_models(seed=0):
    paddle.seed(seed)
    jm = jnn.Linear(4, 1)
    tm = pt.nn.Linear(4, 1, device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def test_o1_training_with_a_scaler_matches_the_jax_loop():
    # tests/test_amp.py's convergence cases: params stay f32 under O1, and
    # scaler.minimize trains the same as in the JAX package
    jm, tm = _linear_models()
    x = np.random.default_rng(1).standard_normal((16, 4)).astype(np.float32)
    y = x.sum(axis=1, keepdims=True)
    jopt = paddle.optimizer.SGD(learning_rate=0.05, parameters=jm.parameters())
    topt = pt.optimizer.SGD(learning_rate=0.05, parameters=tm.parameters())
    jsc, tsc = paddle.amp.GradScaler(), pt.amp.GradScaler()
    jx, jy, tx, ty = (paddle.to_tensor(x), paddle.to_tensor(y), torch.from_numpy(x),
                      torch.from_numpy(y))
    for _ in range(50):
        with paddle.amp.auto_cast(level="O1"):
            jloss = ((jm(jx) - jy) ** 2).mean()
        jsc.minimize(jopt, jsc.scale(jloss))
        jopt.clear_grad()
        with pt.amp.auto_cast(level="O1"):
            tloss = ((tm(tx) - ty) ** 2).mean()
        tsc.minimize(topt, tsc.scale(tloss))
        topt.clear_grad()
    assert tm.weight.dtype == torch.float32
    assert tloss.item() < 0.2 and abs(tloss.item() - float(jloss)) <= TOL_LOW
    assert tsc.state_dict() == jsc.state_dict()
    np.testing.assert_allclose(tm.weight.detach().numpy(), jm.weight.numpy(),
                               atol=TOL_LOW, rtol=0)


def _scalar_params():
    jp = jnn.Parameter(np.zeros(2, np.float32))
    tp = torch.nn.Parameter(torch.zeros(2))
    return jp, tp


def test_grad_scaler_scales_and_unscales():
    jp, tp = _scalar_params()
    jo = paddle.optimizer.SGD(learning_rate=1.0, parameters=[jp])
    to = pt.optimizer.SGD(learning_rate=1.0, parameters=[tp])
    jsc = paddle.amp.GradScaler(init_loss_scaling=128.0)
    tsc = pt.amp.GradScaler(init_loss_scaling=128.0)
    jsc.scale((jp * paddle.to_tensor([1.0, 2.0])).sum()).backward()
    tsc.scale((tp * torch.tensor([1.0, 2.0])).sum()).backward()
    np.testing.assert_array_equal(tp.grad.numpy(), jp.grad.numpy())
    np.testing.assert_array_equal(tp.grad.numpy(), [128.0, 256.0])
    jsc.step(jo)
    tsc.step(to)
    jsc.update()
    tsc.update()
    np.testing.assert_array_equal(tp.detach().numpy(), jp.numpy())
    np.testing.assert_array_equal(tp.detach().numpy(), [-1.0, -2.0])


# A run of steps with their gradients, some non-finite, under a scaler that
# backs off after 2 bad steps and grows after 3 good ones; an explicit
# unscale_ before some steps, as a clipping loop calls it
STEPS = [
    ([1.0, 2.0], False), ([np.inf, 1.0], False), ([3.0, -1.0], True), ([np.nan, 0.0], False),
    ([np.inf, np.inf], True), ([0.5, 0.5], False), ([1.0, 1.0], False), ([2.0, 1.0], True),
    ([-np.inf, 1.0], False), ([1.0, 1.0], False), ([1.0, 4.0], False), ([1.0, 1.0], False),
]


@pytest.mark.parametrize("enable,dynamic", [(True, True), (True, False), (False, True)])
def test_grad_scaler_state_machine_matches_the_jax_scaler(enable, dynamic):
    jp, tp = _scalar_params()
    jo = paddle.optimizer.SGD(learning_rate=0.5, parameters=[jp])
    to = pt.optimizer.SGD(learning_rate=0.5, parameters=[tp])
    kw = dict(enable=enable, init_loss_scaling=64.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=dynamic)
    jsc, tsc = paddle.amp.GradScaler(**kw), pt.amp.GradScaler(**kw)
    for grad, explicit_unscale in STEPS:
        g = np.asarray(grad, np.float32) * 64.0
        jp.grad = paddle.to_tensor(g)
        tp.grad = torch.from_numpy(g.copy())
        if explicit_unscale:
            jsc.unscale_(jo)
            tsc.unscale_(to)
            assert tsc._found_inf == jsc._found_inf
        jsc.step(jo)
        tsc.step(to)
        assert to._step_count == jo._step_count
        jsc.update()
        tsc.update()
        assert tsc.state_dict() == jsc.state_dict()
        np.testing.assert_array_equal(tp.detach().numpy(), jp.numpy())
    assert tsc.get_init_loss_scaling() == jsc.get_init_loss_scaling()
    assert tsc.is_enable() == enable and tsc.is_use_dynamic_loss_scaling() == dynamic
    fresh = pt.amp.GradScaler()
    fresh.load_state_dict(tsc.state_dict())
    assert fresh.state_dict()["scale"] == tsc.state_dict()["scale"]
    fresh.set_init_loss_scaling(8.0)
    assert fresh.get_init_loss_scaling() == 8.0


@pytest.mark.parametrize("fused", [False, True])
def test_a_rescued_step_marks_the_scaler(fused):
    """Under FLAGS_numeric_rescue the scaler skips its own check; the
    optimizer's sentinel skips the step and marks found_inf, so the scale
    backs off as the JAX scaler's does."""
    flags = {"FLAGS_numeric_rescue": "skip", "FLAGS_pallas_fused_update": fused}
    paddle.set_flags(flags)
    pt.set_flags(flags)
    pt.resilience.rescue.reset_counters()
    try:
        jp, tp = _scalar_params()
        jo = paddle.optimizer.Adam(learning_rate=0.01, parameters=[jp])
        to = pt.optimizer.Adam(learning_rate=0.01, parameters=[tp])
        kw = dict(init_loss_scaling=64.0, decr_every_n_nan_or_inf=1)
        jsc, tsc = paddle.amp.GradScaler(**kw), pt.amp.GradScaler(**kw)
        for grad in ([1.0, 2.0], [np.inf, 1.0], [1.0, -1.0]):
            g = np.asarray(grad, np.float32) * jsc.get_init_loss_scaling()
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g.copy())
            before = tp.detach().clone()
            m1 = [v.clone() for v in to._accumulators.get(id(tp), {}).values()]
            jsc.step(jo)
            tsc.step(to)
            assert to._rescue_scaler is None
            if np.isinf(grad).any():
                # the sentinel skipped the update: p and moments unchanged
                assert tsc._found_inf and jsc._found_inf
                assert torch.equal(tp.detach(), before)
                assert all(torch.equal(a, b) for a, b in
                           zip(m1, to._accumulators[id(tp)].values()))
            jsc.update()
            tsc.update()
            assert tsc.state_dict() == jsc.state_dict()
            # Adam's update differs by an ulp or so between the packages
            # (XLA:CPU contracts FMAs, tests/test_torch_fused_update.py): a
            # few 1e-9 at these magnitudes (~0.02)
            np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), atol=1e-7, rtol=0)
        assert tsc.get_init_loss_scaling() == 32.0
        assert pt.resilience.rescue.counters["numeric_rescues"] == 1
    finally:
        off = {"FLAGS_numeric_rescue": "", "FLAGS_pallas_fused_update": False}
        paddle.set_flags(off)
        pt.set_flags(off)
        pt.resilience.rescue.reset_counters()
