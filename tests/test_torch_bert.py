"""The port's BERT against the JAX package's, on the CPU.

The model is a tiny BERT (vocab 64, hidden 32, 2 layers, 2 heads, seq 16,
dropout 0) at batch 2 x 16, with the flash path on on both sides: the JAX
package runs its Pallas kernel in interpret mode, the port its kernels'
plain versions. Weights go from the JAX model into the port by
``convert.state_dict_from_numpy``; token ids, token types, padding masks and
labels come from numpy with a seed. Each tolerance is stated where it is
used, with its reason.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel.topology import use_mesh
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, max_seq_len=16,
           dropout=0.0, attn_dropout=0.0)
BATCH, SEQ = 2, 16
# f32 on the CPU: the frameworks order matmul, softmax and reduction sums
# differently, ~1e-7 relative per op; logits of order 1 through 2 layers and
# the tied head agree to ~2e-7 (2.2e-7 at this seed)
TOL_F32 = dict(atol=1e-5, rtol=0)


@pytest.fixture(autouse=True)
def one_device_flash_on():
    """The JAX reference on one device, whatever mesh an earlier test left
    installed, and the flash path on in both packages."""
    paddle.set_flags({"FLAGS_use_flash_attention": True})
    pt.set_flags({"FLAGS_use_flash_attention": True})
    with use_mesh(None):
        yield


def _models(**cfg):
    """A JAX BERT from the seed and a port BERT on the CPU holding its weights."""
    paddle.seed(0)
    jm = jbert.BertForPretraining(jbert.BertConfig(**dict(CFG, **cfg)))
    tm = tbert.BertForPretraining(tbert.BertConfig(**dict(CFG, **cfg)), device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _inputs(seed=1):
    """ids, token types, and a padding mask whose rows keep 16 and 9 tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (BATCH, SEQ))
    types = rng.integers(0, 2, (BATCH, SEQ))
    mask = np.ones((BATCH, SEQ), np.int64)
    mask[1, 9:] = 0
    return ids, types, mask


def _packed(ids, seed=2):
    """bench.py bench_bert's label: MLM labels then the NSP label per row."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, CFG["vocab_size"], ids.shape),
                           rng.integers(0, 2, (ids.shape[0], 1))], axis=1)


def test_state_dict_names_and_layouts_are_the_jax_models():
    jm, tm = _models()
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(tsd) == list(jsd) and len(tsd) == 38
    assert list(tsd)[0] == "mlm_bias"
    for name, t in tsd.items():
        assert tuple(t.shape) == tuple(jsd[name].shape), name
    assert all(hasattr(p, "param_name") for p in tm.parameters())


@pytest.mark.parametrize("inputs", ["ids", "token_types", "padded_mask"])
def test_mlm_and_nsp_logits_match_jax_in_f32(inputs):
    jm, tm = _models()
    ids, types, mask = _inputs()
    args = {"ids": (ids,), "token_types": (ids, types), "padded_mask": (ids, types, mask)}[inputs]
    jmlm, jnsp = jm(*[paddle.to_tensor(a) for a in args])
    with torch.no_grad():
        tmlm, tnsp = tm(*[torch.as_tensor(a) for a in args])
    assert tmlm.dtype == tnsp.dtype == torch.float32
    assert tuple(tmlm.shape) == (BATCH, SEQ, CFG["vocab_size"]) and tuple(tnsp.shape) == (BATCH, 2)
    np.testing.assert_allclose(tmlm.numpy(), jmlm.numpy(), **TOL_F32)
    np.testing.assert_allclose(tnsp.numpy(), jnsp.numpy(), **TOL_F32)


@pytest.mark.parametrize("masked", [False, True])
def test_criterion_with_ignored_labels_and_mlm_mask(masked):
    rng = np.random.default_rng(3)
    mlm = rng.standard_normal((BATCH, SEQ, 11)).astype(np.float32) * 3
    nsp = rng.standard_normal((BATCH, 2)).astype(np.float32)
    labels = rng.integers(0, 11, (BATCH, SEQ))
    keep = rng.random((BATCH, SEQ)) < 0.15
    keep[0, 0] = True
    labels[~keep] = -100  # MLM labels only at the masked 15% of positions
    nsp_labels = rng.integers(0, 2, (BATCH,))
    args = [mlm, nsp, labels, nsp_labels] + ([keep.astype(np.float32)] if masked else [])
    ref = jbert.BertPretrainingCriterion()(*[paddle.to_tensor(a) for a in args])
    out = tbert.BertPretrainingCriterion()(*[torch.as_tensor(a) for a in args])
    assert out.dim() == 0 and np.isfinite(out.item())
    # one softmax cross-entropy per position and a sum of at most 32 terms
    # of order 3: equal to ~1e-7 relative
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=0)


def _loss_fns(jcrit, tcrit):
    """bench.py bench_bert's loss: f32 logits, labels sliced from ``packed``."""

    def jloss(out, packed):
        mlm, nsp = out
        return jcrit(mlm.astype("float32"), nsp.astype("float32"), packed[:, :-1], packed[:, -1])

    def tloss(out, packed):
        mlm, nsp = out
        return tcrit(mlm.float(), nsp.float(), packed[:, :-1], packed[:, -1])

    return jloss, tloss


def _optimizers(kind, jm, tm, lr):
    if kind == "AdamW":
        return (paddle.optimizer.AdamW(learning_rate=lr, parameters=jm.parameters()),
                pt.optimizer.AdamW(learning_rate=lr, parameters=tm.parameters()))
    return (paddle.optimizer.Lamb(learning_rate=lr, parameters=jm.parameters()),
            pt.optimizer.Lamb(learning_rate=lr, parameters=tm.parameters()))


@pytest.mark.parametrize("kind,batch", [("AdamW", "bench"), ("Lamb", "bench"),
                                        ("AdamW", "token_types_and_mask")])
def test_o2_bf16_compiled_steps_match_jax(kind, batch):
    """bench.py bench_bert's step at the tiny config: O2 bf16, the int64
    ``packed`` label, three steps through compile_train_step; with token
    types and a padding mask as int batch arguments O2 leaves uncast."""
    jm, tm = _models()
    jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    tm = pt.amp.decorate(tm, level="O2", dtype="bfloat16")
    jopt, topt = _optimizers(kind, jm, tm, lr=1e-3)
    jloss, tloss = _loss_fns(jbert.BertPretrainingCriterion(), tbert.BertPretrainingCriterion())
    jstep = paddle.jit.compile_train_step(jm, jloss, jopt)
    tstep = pt.jit.compile_train_step(tm, tloss, topt)
    ids, types, mask = _inputs(seed=4)
    batch_args = [ids] if batch == "bench" else [ids, types, mask]
    batch_args.append(_packed(ids))
    jl = [float(jstep(*[paddle.to_tensor(a) for a in batch_args])) for _ in range(3)]
    tl = [float(tstep(*[torch.as_tensor(a) for a in batch_args])) for _ in range(3)]
    # bf16 weights and activations rounded at different places (torch
    # rounds every op's result, XLA may keep f32 between fused ops, and JAX
    # rounds a Python scalar to bf16 first): the losses (~4.4-5.4) are
    # 1.4e-4-1.7e-3 apart at this seed; 3e-2 is the reference's bf16
    # tolerance (ROADMAP's O2 tolerance)
    np.testing.assert_allclose(tl, jl, atol=3e-2, rtol=0)
    assert tl[2] < tl[0] and topt._step_count == 3
    # AdamW keeps every tensor bf16 (the beta pows f32); Lamb's f32 bias
    # corrections turn the parameters f32 at the first update and the
    # moments at the second, in both packages
    want = torch.bfloat16 if kind == "AdamW" else torch.float32
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        jst = jopt._accumulators[id(jparams[n])]
        st = topt._accumulators[id(p)]
        assert str(jparams[n].dtype).endswith(str(want).split(".")[1]), n
        assert p.dtype == st["moment1"].dtype == st["moment2"].dtype == want, n
        assert {str(v.dtype) for v in jst.values()} == {str(v.dtype).split(".")[1]
                                                        for v in st.values()}, n
        assert st["beta1_pow"].dtype == torch.float32


def test_masked_o2_forward_promotes_to_f32_as_jax_does():
    """An f32 additive mask promotes the bf16 logits; P·V, the projections
    and every later layer then run in f32 in both packages."""
    jm, tm = _models()
    jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    tm = pt.amp.decorate(tm, level="O2", dtype="bfloat16")
    ids, types, mask = _inputs(seed=5)
    for args in ((ids, types, mask), (ids,)):
        jmlm, jnsp = jm(*[paddle.to_tensor(a) for a in args])
        with torch.no_grad():
            tmlm, tnsp = tm(*[torch.as_tensor(a) for a in args])
        want = "float32" if len(args) == 3 else "bfloat16"
        assert str(jmlm.dtype).endswith(want) and str(jnsp.dtype).endswith(want)
        assert tmlm.dtype == tnsp.dtype == getattr(torch, want)
        # bf16 weights and the first layer's bf16 activations, rounded at
        # other places than XLA's: a few bf16 ulps on logits of order 1
        np.testing.assert_allclose(tmlm.float().numpy(), np.asarray(jmlm.numpy(), np.float32),
                                   atol=3e-2, rtol=0)
        np.testing.assert_allclose(tnsp.float().numpy(), np.asarray(jnsp.numpy(), np.float32),
                                   atol=3e-2, rtol=0)


def test_f32_compiled_step_updates_parameters_as_jax_does():
    jm, tm = _models()
    jopt, topt = _optimizers("AdamW", jm, tm, lr=1e-4)
    jloss, tloss = _loss_fns(jbert.BertPretrainingCriterion(), tbert.BertPretrainingCriterion())
    jstep = paddle.jit.compile_train_step(jm, jloss, jopt)
    tstep = pt.jit.compile_train_step(tm, tloss, topt)
    ids, _, _ = _inputs(seed=6)
    packed = _packed(ids, seed=7)
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(packed))) for _ in range(3)]
    tl = [float(tstep(torch.as_tensor(ids), torch.as_tensor(packed))) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    # AdamW's first steps move each parameter by ~lr·sign(g); a gradient
    # near 0 that differs by ~1e-7 between the frameworks moves its update
    # by up to lr_t·Δg/eps: 2.4e-7 apart at lr 1e-4 and this seed
    # (tests/test_torch_train.py saw 5.6e-6 at lr 1e-3)
    jparams = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[n].numpy(), atol=1e-5, rtol=0,
                                   err_msg=n)


def test_unmasked_forward_takes_the_flash_route_and_masked_the_dense(monkeypatch):
    """The JAX selector: flash with no mask and no attention dropout, dense
    with a mask or attention dropout in training. On the CPU the flash route
    runs the kernels' plain version and counts no launch."""
    seen = []
    flash = tnn.flash_scaled_dot_product_attention
    monkeypatch.setattr(tnn, "flash_scaled_dot_product_attention",
                        lambda *a, **kw: seen.append(kw["is_causal"]) or flash(*a, **kw))
    before = dict(tfa.flash_attention_fwd.launches_by_route)
    ids, types, mask = _inputs()
    _, tm = _models()
    with torch.no_grad():
        tm(torch.as_tensor(ids), torch.as_tensor(types))
        assert seen == [False] * CFG["num_layers"]  # non-causal, once per layer
        tm(torch.as_tensor(ids), torch.as_tensor(types), torch.as_tensor(mask))
        assert len(seen) == CFG["num_layers"]
    _, dropped = _models(attn_dropout=0.1)
    dropped.train()
    dropped(torch.as_tensor(ids))
    assert len(seen) == CFG["num_layers"]
    dropped.eval()
    with torch.no_grad():
        dropped(torch.as_tensor(ids))
    assert len(seen) == 2 * CFG["num_layers"]
    assert tfa.flash_attention_fwd.launches_by_route == before


@pytest.mark.parametrize("dtype,eligible", [(torch.bfloat16, "sm90_eligible"),
                                            (torch.float32, "tf32x3_eligible")])
def test_bert_qkv_views_reach_the_tensor_core_routes_uncopied(dtype, eligible):
    """BERT-base's [b, s, 3, H, hd] projection, unbound on axis 2: views with
    a sequence stride of 3·768 elements, k and v 768 and 1536 elements in.
    The eligibility functions read only metadata, so CPU views answer for
    the card's."""
    b, s, heads, hd = 2, 512, 12, 64
    qkv = torch.zeros((b, s, 3 * heads * hd), dtype=dtype).reshape(b, s, 3, heads, hd)
    q, k, v = qkv.unbind(dim=2)
    assert q.stride() == (s * 3 * heads * hd, 3 * heads * hd, hd, 1)
    assert not q.is_contiguous()
    base = qkv.data_ptr()
    assert [t.data_ptr() - base for t in (q, k, v)] == [
        i * heads * hd * dtype.itemsize for i in range(3)]
    do = torch.zeros((b, s, heads, hd), dtype=dtype)
    fn = getattr(tfa, eligible)
    assert fn((q, k, v)) and fn((q, k, v, do))
