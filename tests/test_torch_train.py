"""The port's training step against the JAX package's, on the CPU.

The model is tests/test_torch_gpt.py's (2 layers, hidden 64, 4 heads, vocab
128, max_seq_len 64, dropout 0) at batch 2 x 64, with the flash path on on
both sides: the JAX package runs its Pallas kernels in interpret mode, the
port its kernels' plain versions. Weights go from the JAX model into the port
by ``convert.state_dict_from_numpy``; token ids and logits come from numpy
with a seed. Each tolerance is stated where it is used, with its reason.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.parallel.topology import use_mesh
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import nn_ops as tnn

SEED = 0
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
           dropout=0.0, attn_dropout=0.0)
BATCH = 2
LR = 1e-3
# f32 on the CPU: the two frameworks order matmul, softmax and reduction
# sums differently, about 1e-7 relative per op; losses of order 5 and
# logits of order 1 then agree to ~1e-6, and a summed loss to ~1e-6 of itself.
TOL_LOSS = dict(atol=1e-5, rtol=1e-6)


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
    """A JAX GPT from the seed and a port GPT on the CPU holding its weights."""
    paddle.seed(SEED)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**CFG), device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed=1):
    ids = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                               (BATCH, CFG["max_seq_len"] + 1))
    return ids[:, :-1], ids[:, 1:]


def _logits_labels(seed, ignore_index=None):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((2, 16, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 16))
    if ignore_index is not None:
        labels[rng.random((2, 16)) < 0.3] = ignore_index
    return logits, labels


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("soft_label", [False, True])
def test_softmax_with_cross_entropy_op(reduction, soft_label):
    logits, labels = _logits_labels(seed=2, ignore_index=3)
    if soft_label:
        labels = np.random.default_rng(3).dirichlet(np.ones(11), (2, 16)).astype(np.float32)
    else:
        labels = labels[..., None]  # the class axis kept, squeezed by the op
    ref = jnn.softmax_with_cross_entropy(
        np.asarray(logits), np.asarray(labels), soft_label=soft_label, ignore_index=3,
        reduction=reduction)
    out = tnn.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), soft_label=soft_label,
        ignore_index=3, reduction=reduction)
    assert tuple(out.shape) == np.shape(ref)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL_LOSS)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("ignore_index", [-100, 5])
def test_cross_entropy_and_its_gradient(reduction, ignore_index):
    logits, labels = _logits_labels(seed=4, ignore_index=ignore_index)
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jloss = JF.cross_entropy(jx, paddle.to_tensor(labels), ignore_index=ignore_index,
                             reduction=reduction)
    tx = torch.from_numpy(logits).requires_grad_()
    tloss = TF.cross_entropy(tx, torch.from_numpy(labels), ignore_index=ignore_index,
                             reduction=reduction)
    assert tuple(tloss.shape) == tuple(jloss.shape)
    np.testing.assert_allclose(tloss.detach().numpy(), jloss.numpy(), **TOL_LOSS)
    jloss.sum().backward()
    tloss.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL_LOSS)


# Labels at or past the class count C = 5: an ignore_index of C gives 0 in
# its row, and a label past the last class that is not ignored gives NaN in
# its row only (the JAX op's take_along_axis fill), with a zero gradient row.
@pytest.mark.parametrize("labels,ignore_index,nan_rows", [
    ([1, 5, 2], 5, [False, False, False]),
    ([1, 7, 2], 5, [False, True, False]),
    ([1, 5, 2], -100, [False, True, False]),
])
def test_softmax_with_cross_entropy_labels_past_the_class_count(labels, ignore_index, nan_rows):
    logits = np.random.default_rng(8).standard_normal((3, 5)).astype(np.float32)
    labels = np.asarray(labels)

    def jloss(x):
        return jnn.softmax_with_cross_entropy(x, labels, ignore_index=ignore_index)

    ref = np.asarray(jloss(logits))
    jgrad = np.asarray(jax.grad(lambda x: jloss(x).sum())(logits))
    tx = torch.from_numpy(logits).requires_grad_()
    out = tnn.softmax_with_cross_entropy(tx, torch.from_numpy(labels), ignore_index=ignore_index)
    out.sum().backward()
    assert np.isnan(ref[:, 0]).tolist() == nan_rows
    np.testing.assert_array_equal(np.isnan(out.detach().numpy()), np.isnan(ref))
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL_LOSS)
    assert np.isfinite(jgrad).all() and np.isfinite(tx.grad.numpy()).all()
    np.testing.assert_allclose(tx.grad.numpy(), jgrad, **TOL_LOSS)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_cross_entropy_with_an_ignore_index_at_the_class_count(reduction):
    logits, labels = _logits_labels(seed=9, ignore_index=11)  # C = 11
    assert (labels == 11).any()
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jl = JF.cross_entropy(jx, paddle.to_tensor(labels), ignore_index=11, reduction=reduction)
    tx = torch.from_numpy(logits).requires_grad_()
    tl = TF.cross_entropy(tx, torch.from_numpy(labels), ignore_index=11, reduction=reduction)
    assert np.isfinite(tl.detach().numpy()).all()
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), **TOL_LOSS)
    jl.sum().backward()
    tl.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL_LOSS)


def test_cross_entropy_unported_branches_raise():
    """The branches that raised before the nn slice (label smoothing, a class
    weight, ``use_softmax=False``, soft labels) now match the JAX function,
    loss and gradient."""
    logits, labels = _logits_labels(seed=5)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    soft = np.random.default_rng(6).dirichlet(np.ones(logits.shape[-1]), logits.shape[:-1])
    weight = np.random.default_rng(7).uniform(0.5, 2.0, logits.shape[-1]).astype(np.float32)
    for kw, x, lab in ((dict(label_smoothing=0.1), logits, labels),
                       (dict(weight=weight), logits, labels),
                       (dict(use_softmax=False), probs, labels),
                       (dict(soft_label=True), logits, soft.astype(np.float32))):
        jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        jx = paddle.to_tensor(x, stop_gradient=False)
        jl = JF.cross_entropy(jx, paddle.to_tensor(lab), **jkw)
        tx = torch.from_numpy(x).requires_grad_()
        tl = TF.cross_entropy(tx, torch.from_numpy(lab), **tkw)
        np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), **TOL_LOSS)
        jl.backward()
        tl.backward()
        np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL_LOSS)


@pytest.mark.parametrize("masked", [False, True])
def test_pretraining_criterion(masked):
    logits, labels = _logits_labels(seed=6)
    mask = (np.random.default_rng(7).random(labels.shape) < 0.6).astype(np.float32)
    jargs = [paddle.to_tensor(logits), paddle.to_tensor(labels)]
    targs = [torch.from_numpy(logits), torch.from_numpy(labels)]
    if masked:
        jargs.append(paddle.to_tensor(mask))
        targs.append(torch.from_numpy(mask))
    ref = jgpt.GPTPretrainingCriterion()(*jargs)
    out = tgpt.GPTPretrainingCriterion()(*targs)
    assert out.dim() == 0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL_LOSS)


def test_every_parameter_gradient_matches_the_jax_tape():
    jm, tm = _models()
    x, y = _batch()
    jloss = jgpt.GPTPretrainingCriterion()(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    jloss.backward()
    tloss = tgpt.GPTPretrainingCriterion()(tm(torch.as_tensor(x)), torch.as_tensor(y))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL_LOSS)
    jgrads = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    names = [n for n, _ in tm.named_parameters()]
    assert names == list(jgrads)
    # gradients are at most 0.13 here; f32 sum order differs between the
    # frameworks (and the flash backward's tiling between the Pallas kernel
    # and the dense plain version), ~1e-7 relative per op, through 2 layers:
    # 5.6e-8 apart at this seed, 1e-6 leaves margin
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], atol=1e-6, rtol=0, err_msg=n)


def _no_decay(model):
    """apply_decay_param_fun: weight decay on matrices only, by the model's
    own parameter names."""
    key = "param_name" if isinstance(model, torch.nn.Module) else "name"
    decayed = {getattr(p, key) for p in model.parameters() if len(p.shape) == 2}
    return lambda name: name in decayed


def test_three_adamw_steps_through_compile_train_step():
    jm, tm = _models()
    x, y = _batch()
    jcrit, tcrit = jgpt.GPTPretrainingCriterion(), tgpt.GPTPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                                  weight_decay=0.01, apply_decay_param_fun=_no_decay(jm))
    topt = pt.optimizer.AdamW(learning_rate=LR, parameters=tm.parameters(),
                              weight_decay=0.01, apply_decay_param_fun=_no_decay(tm))
    jstep = paddle.jit.compile_train_step(jm, lambda lo, lb: jcrit(lo, lb), jopt)
    tstep = pt.jit.compile_train_step(tm, lambda lo, lb: tcrit(lo, lb), topt)
    jlosses, tlosses = [], []
    for i in range(3):
        if i == 2:  # the lr is read on every call
            jopt.set_lr(LR / 2)
            topt.set_lr(LR / 2)
        jlosses.append(float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))))
        tlosses.append(float(tstep(torch.as_tensor(x), torch.as_tensor(y))))
    np.testing.assert_allclose(tlosses, jlosses, **TOL_LOSS)
    assert tlosses[2] < tlosses[0]
    assert topt._step_count == jopt._step_count == 3
    # Parameters: AdamW's first steps move every parameter by about lr·sign(g)
    # (m/√v is ±1 for |g| ≫ eps), and a gradient near 0 that differs by 1e-7
    # between the frameworks moves its update by up to lr_t·Δg/eps ~ 3e-6;
    # 5.6e-6 apart at this seed; 2e-5 leaves margin and is 50x below one
    # step's lr.
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        jp = jparams[n]
        np.testing.assert_allclose(p.detach().numpy(), jp.numpy(), atol=2e-5, rtol=0,
                                   err_msg=n)
        jst = jopt._accumulators[id(jp)]
        tst = topt._accumulators[id(p)]
        assert sorted(tst) == sorted(jst)
        # moments follow the gradients: 1.4e-7 apart on m and 4.4e-10 on v
        # at this seed
        np.testing.assert_allclose(tst["moment1"].numpy(), np.asarray(jst["moment1"]),
                                   atol=1e-6, rtol=0, err_msg=n)
        np.testing.assert_allclose(tst["moment2"].numpy(), np.asarray(jst["moment2"]),
                                   atol=1e-8, rtol=0, err_msg=n)
        for k in ("beta1_pow", "beta2_pow"):
            assert tst[k].dtype == torch.float32 and tst[k].dim() == 0
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), rtol=1e-7)


def test_eager_adam_step_with_l2_decay():
    """Adam's L2 decay folded into g, through the eager ``step()`` on both sides."""
    jm, tm = _models()
    x, y = _batch(seed=4)
    jopt = paddle.optimizer.Adam(learning_rate=LR, parameters=jm.parameters(),
                                 weight_decay=0.01)
    topt = pt.optimizer.Adam(learning_rate=LR, parameters=tm.parameters(), weight_decay=0.01)
    for _ in range(2):
        jgpt.GPTPretrainingCriterion()(jm(paddle.to_tensor(x)), paddle.to_tensor(y)).backward()
        jopt.step()
        jopt.clear_grad()
        tgpt.GPTPretrainingCriterion()(tm(torch.as_tensor(x)), torch.as_tensor(y)).backward()
        topt.step()
        topt.clear_grad()
    # the tolerances of the AdamW steps above, for the same reasons
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n].numpy(), atol=2e-5, rtol=0,
                                   err_msg=n)
        np.testing.assert_allclose(topt._accumulators[id(p)]["moment1"].numpy(),
                                   np.asarray(jopt._accumulators[id(jparams[n])]["moment1"]),
                                   atol=1e-6, rtol=0, err_msg=n)


def test_one_o2_bf16_step():
    jm, tm = _models()
    x, y = _batch(seed=2)
    jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    tm = pt.amp.decorate(tm, level="O2", dtype="bfloat16")
    jcrit, tcrit = jgpt.GPTPretrainingCriterion(), tgpt.GPTPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                                  weight_decay=0.01)
    topt = pt.optimizer.AdamW(learning_rate=LR, parameters=tm.parameters(), weight_decay=0.01)
    jstep = paddle.jit.compile_train_step(jm, lambda lo, lb: jcrit(lo.astype("float32"), lb),
                                          jopt)
    tstep = pt.jit.compile_train_step(tm, lambda lo, lb: tcrit(lo.float(), lb), topt)
    jloss = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
    tloss = float(tstep(torch.as_tensor(x), torch.as_tensor(y)))
    # bf16 weights and activations on both sides, rounded at different
    # places: torch rounds every op's result to bf16, XLA on the CPU may
    # keep f32 between fused elementwise ops. That moves logits by a few
    # bf16 ulps (~1e-2 at magnitude 1) and the loss (~4.9) by up to ~1e-2
    # (7.3e-5 at this seed); 3e-2 is the reference's bf16 tolerance.
    assert abs(tloss - jloss) <= 3e-2, (tloss, jloss)
    for p in tm.parameters():
        st = topt._accumulators[id(p)]
        assert p.dtype == st["moment1"].dtype == st["moment2"].dtype == torch.bfloat16
        assert st["beta1_pow"].dtype == torch.float32


def test_decorate_o2_parameter_dtypes():
    jm, tm = _models()
    ref = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    out = pt.amp.decorate(tm, level="O2", dtype="bfloat16")
    assert out is tm and ref is jm
    jdt = {n: str(p.dtype).split(".")[-1] for n, p in jm.named_parameters()}
    tdt = {n: str(p.dtype).split(".")[-1] for n, p in tm.named_parameters()}
    assert tdt == jdt and set(tdt.values()) == {"bfloat16"}
    # floating inputs are cast at the model's entry, integer ids are not
    seen = []
    inner = torch.nn.Identity()
    inner.register_forward_hook(lambda m, a, o: seen.append(a[0].dtype))
    wrapped = pt.amp.decorate(torch.nn.Sequential(inner), level="O2", dtype="bfloat16")
    wrapped(torch.zeros(2, 3))
    wrapped(torch.zeros(2, 3, dtype=torch.int64))
    assert seen == [torch.bfloat16, torch.int64]
    # O1 leaves the model as it is, as the JAX decorate does
    o1 = tgpt.GPTForPretraining(tgpt.GPTConfig(**CFG), device="cpu")
    pt.amp.decorate(o1, level="O1")
    assert {p.dtype for p in o1.parameters()} == {torch.float32}


def test_optimizer_state_dict_key_names():
    jm, tm = _models()
    x, y = _batch(seed=3)
    jopt = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters())
    topt = pt.optimizer.AdamW(learning_rate=LR, parameters=tm.parameters())
    jgpt.GPTPretrainingCriterion()(jm(paddle.to_tensor(x)), paddle.to_tensor(y)).backward()
    jopt.step()
    tgpt.GPTPretrainingCriterion()(tm(torch.as_tensor(x)), torch.as_tensor(y)).backward()
    topt.step()
    topt.clear_grad()
    assert all(p.grad is None for p in tm.parameters())

    def normalised(keys, names):
        index = {name: i for i, name in enumerate(names)}
        out = set()
        for k in keys:
            head, _, tail = k.partition(".")
            out.add(k if not tail else f"#{index[head]}.{tail}")
        return out

    jsd, tsd = jopt.state_dict(), topt.state_dict()
    jnames = [p.name for p in jm.parameters()]
    tnames = [p.param_name for p in tm.parameters()]
    assert all(n.startswith("param_") for n in tnames) and len(set(tnames)) == len(tnames)
    assert normalised(tsd, tnames) == normalised(jsd, jnames)
    assert tsd["_step_count"] == jsd["_step_count"] == 1

    # a state dict is a copy; loading one writes the live state in place
    m1 = topt._accumulators[id(next(tm.parameters()))]["moment1"]
    key = f"{tnames[0]}.moment1"
    saved = tsd[key].clone()
    m1.add_(1.0)
    assert torch.equal(tsd[key], saved)
    topt.set_state_dict(tsd)
    assert topt._accumulators[id(next(tm.parameters()))]["moment1"] is m1
    assert torch.equal(m1, saved) and topt._step_count == 1


class _JaxRows(paddle.nn.Layer):
    """Two GPT decoder layers and a head over float rows, as the
    parameter-server path feeds pulled embedding rows to a step."""

    def __init__(self):
        super().__init__()
        cfg = jgpt.GPTConfig(**CFG)
        self.layers = paddle.nn.LayerList([jgpt.GPTDecoderLayer(cfg) for _ in range(2)])
        self.head = paddle.nn.Linear(CFG["hidden_size"], CFG["vocab_size"])

    def forward(self, rows):
        for layer in self.layers:
            rows = layer(rows)
        return self.head(rows)


class _PortRows(torch.nn.Module):
    def __init__(self, **cfg):
        super().__init__()
        cfg = tgpt.GPTConfig(**dict(CFG, **cfg))
        self.layers = pt.nn.LayerList([tgpt.GPTDecoderLayer(cfg, device="cpu")
                                       for _ in range(2)])
        self.head = pt.nn.Linear(CFG["hidden_size"], CFG["vocab_size"], device="cpu")

    def forward(self, rows):
        for layer in self.layers:
            rows = layer(rows)
        return self.head(rows)


@pytest.mark.parametrize("recompute", [False, True])
def test_grad_input_idx_matches_the_jax_step(recompute):
    paddle.seed(SEED)
    jm = _JaxRows()
    tm = _PortRows(use_recompute=recompute)
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((BATCH, 16, CFG["hidden_size"])).astype(np.float32)
    labels = rng.integers(0, CFG["vocab_size"], (BATCH, 16))
    jcrit, tcrit = jgpt.GPTPretrainingCriterion(), tgpt.GPTPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters())
    topt = pt.optimizer.AdamW(learning_rate=LR, parameters=tm.parameters())
    jstep = paddle.jit.compile_train_step(jm, lambda lo, lb: jcrit(lo, lb), jopt,
                                          grad_input_idx=(0,))
    tstep = pt.jit.compile_train_step(tm, lambda lo, lb: tcrit(lo, lb), topt,
                                      grad_input_idx=(0,))
    for _ in range(3):
        jloss, (jgrad,) = jstep(paddle.to_tensor(rows), paddle.to_tensor(labels))
        tloss, (tgrad,) = tstep(torch.from_numpy(rows), torch.from_numpy(labels))
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL_LOSS)
        # the input rows' gradients, unscaled and in their dtype: at most
        # ~1.1e-2 here and 2.8e-9 apart at this seed (f32 sums ordered
        # differently); the parameter gradients' 1e-6 above
        assert tgrad.dtype == torch.float32 and tgrad.shape == rows.shape
        assert np.abs(tgrad.numpy()).max() > 1e-4
        np.testing.assert_allclose(tgrad.numpy(), jgrad.numpy(), atol=1e-6, rtol=0)
    # the AdamW steps' tolerance of test_three_adamw_steps_through_compile_train_step
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n].numpy(), atol=2e-5, rtol=0,
                                   err_msg=n)
