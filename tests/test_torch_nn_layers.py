"""Every layer class of ``paddle.nn`` (activation, common, conv, norm, pooling,
loss and transformer layers) in the port against the JAX package's, on the
CPU, in training and in eval mode.

Each case builds the JAX layer from a seed, carries its parameters and
buffers into the port's with ``state_dict_from_numpy``, feeds both the same
inputs made from a seed with numpy, and compares the outputs and the
gradients of ``sum(out * w)`` (``w`` from a seed) with respect to the float
inputs and every parameter, and the buffers after the call. Tolerances
(rtol and atol): elementwise layers, activations and losses 1e-5;
convolutions, pooling, norms and the transformer layers 1e-4, because
XLA:CPU and oneDNN sum in different orders. Layers that draw random masks
in training are compared at p = 0 there and held to their masking rule at
p > 0 (``test_dropout_layers_mask_by_their_rule``).
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import state_dict_from_numpy

ELEM = 1e-5
NORM = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    previous = pt.get_device()
    pt.set_device("cpu")
    paddle.set_flags({"FLAGS_use_flash_attention": True})
    pt.set_flags({"FLAGS_use_flash_attention": True})
    yield
    pt.set_device(previous)


def _inputs(specs, seed):
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    def logp(*s):
        z = f(*s)
        return (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(np.float32)

    make = {
        "x2": lambda: f(3, 8), "x3": lambda: f(2, 4, 6), "x4": lambda: f(2, 4, 6, 6),
        "x5": lambda: f(2, 2, 4, 4, 4), "nhwc": lambda: f(2, 6, 6, 4),
        "x7": lambda: f(2, 4, 7, 7), "x1d": lambda: f(2, 4, 9), "img8": lambda: f(1, 8, 3, 3),
        "seq": lambda: f(2, 5, 8), "mem": lambda: f(2, 3, 8), "w46": lambda: f(4, 6),
        "a34": lambda: f(3, 4), "b35": lambda: f(3, 5), "cols": lambda: f(1, 8, 4),
        "ids": lambda: rng.integers(0, 10, (2, 5)).astype(np.int64),
        "logits": lambda: f(6, 5), "cls": lambda: rng.integers(0, 5, (6,)).astype(np.int64),
        "cls_ign": lambda: np.where(rng.random(6) < 0.3, 2, rng.integers(0, 5, 6)).astype(
            np.int64),
        "soft": lambda: rng.dirichlet(np.ones(5), 6).astype(np.float32),
        "prob": lambda: rng.uniform(0.05, 0.95, (6, 5)).astype(np.float32),
        "bin": lambda: (rng.random((6, 5)) > 0.5).astype(np.float32),
        "logp": lambda: logp(6, 5), "pm1": lambda: np.where(rng.random((6, 5)) > 0.5, 1.0,
                                                            -1.0).astype(np.float32),
        "r6": lambda: f(6), "sgn6": lambda: np.sign(f(6)).astype(np.float32),
        "ctc_lp": lambda: f(6, 2, 4), "ctc_lab": lambda: rng.integers(1, 4, (2, 3)),
        "ctc_in": lambda: np.array([6, 5]), "ctc_len": lambda: np.array([3, 2]),
        "feat": lambda: f(4, 5), "leaf": lambda: rng.integers(0, 6, (4,)).astype(np.int64),
        "logits_c1": lambda: f(3, 5, 4), "cls_c1": lambda: rng.integers(0, 5, (3, 4)),
    }
    return [make[s]() for s in specs]


def _unpool_inputs(nd):
    """Pooled values and their argmax positions (one per 2-wide window) for
    the unpool layers, NC + ``nd`` spatial axes of 2."""
    rng = np.random.default_rng(5)
    shape = (2, 3) + (2,) * nd
    vals = rng.standard_normal(shape).astype(np.float32)
    full = [4] * nd
    idx = np.zeros(shape, np.int64)
    for pos in np.ndindex(*shape[2:]):
        coord = [2 * p + rng.integers(0, 2) for p in pos]
        flat = 0
        for c, n in zip(coord, full):
            flat = flat * n + c
        idx[(slice(None), slice(None)) + pos] = flat
    return [vals, idx]


# (case id, constructor of (module) -> layer, input specs, tolerance)
ACT = [
    ("ReLU", lambda m: m.nn.ReLU()), ("ReLU6", lambda m: m.nn.ReLU6()),
    ("LeakyReLU", lambda m: m.nn.LeakyReLU(0.2)), ("ELU", lambda m: m.nn.ELU(0.7)),
    ("SELU", lambda m: m.nn.SELU()), ("CELU", lambda m: m.nn.CELU(1.3)),
    ("GELU", lambda m: m.nn.GELU()), ("GELU_tanh", lambda m: m.nn.GELU(approximate=True)),
    ("Sigmoid", lambda m: m.nn.Sigmoid()), ("LogSigmoid", lambda m: m.nn.LogSigmoid()),
    ("Tanh", lambda m: m.nn.Tanh()), ("Tanhshrink", lambda m: m.nn.Tanhshrink()),
    ("Silu", lambda m: m.nn.Silu()), ("Swish", lambda m: m.nn.Swish()),
    ("Mish", lambda m: m.nn.Mish()), ("Hardshrink", lambda m: m.nn.Hardshrink(0.4)),
    ("Hardsigmoid", lambda m: m.nn.Hardsigmoid()), ("Hardswish", lambda m: m.nn.Hardswish()),
    ("Hardtanh", lambda m: m.nn.Hardtanh(-0.5, 0.7)),
    ("Softplus", lambda m: m.nn.Softplus(2.0, 1.5)), ("Softshrink", lambda m: m.nn.Softshrink(0.3)),
    ("Softsign", lambda m: m.nn.Softsign()), ("ThresholdedReLU", lambda m: m.nn.ThresholdedReLU(0.3)),
    ("Softmax", lambda m: m.nn.Softmax(axis=1)), ("LogSoftmax", lambda m: m.nn.LogSoftmax()),
    ("Maxout", lambda m: m.nn.Maxout(2, axis=1)), ("GLU", lambda m: m.nn.GLU(axis=1)),
    ("PReLU", lambda m: m.nn.PReLU()), ("PReLU_channels", lambda m: m.nn.PReLU(4, 0.1)),
]
CASES = [(n, c, ["x4"], ELEM) for n, c in ACT] + [
    # common
    ("Linear", lambda m: m.nn.Linear(8, 5), ["x2"], ELEM),
    ("Linear_attr", lambda m: m.nn.Linear(
        8, 5, weight_attr=m.nn.ParamAttr(initializer=m.nn.initializer.Constant(0.5)),
        bias_attr=False), ["x2"], ELEM),
    ("Embedding", lambda m: m.nn.Embedding(10, 4), ["ids"], ELEM),
    ("Flatten", lambda m: m.nn.Flatten(1, 2), ["x4"], ELEM),
    ("Identity", lambda m: m.nn.Identity(), ["x3"], ELEM),
    ("Sequential", lambda m: m.nn.Sequential(m.nn.Linear(8, 6), m.nn.ReLU(), m.nn.Linear(6, 3)),
     ["x2"], ELEM),
    ("Sequential_named", lambda m: m.nn.Sequential(
        collections.OrderedDict([("fc", m.nn.Linear(8, 4)), ("act", m.nn.Tanh())])), ["x2"], ELEM),
    ("Pad1D", lambda m: m.nn.Pad1D([1, 2], mode="reflect"), ["x3"], ELEM),
    ("Pad2D", lambda m: m.nn.Pad2D([1, 0, 2, 1], mode="replicate"), ["x4"], ELEM),
    ("Pad2D_const", lambda m: m.nn.Pad2D(1, value=0.5), ["x4"], ELEM),
    ("Pad3D", lambda m: m.nn.Pad3D([1, 1, 0, 2, 1, 0], mode="circular"), ["x5"], ELEM),
    ("ZeroPad2D", lambda m: m.nn.ZeroPad2D([1, 2, 0, 1]), ["x4"], ELEM),
    ("Upsample_nearest", lambda m: m.nn.Upsample(scale_factor=2), ["x4"], ELEM),
    ("Upsample_bilinear", lambda m: m.nn.Upsample(size=[9, 5], mode="bilinear"), ["x4"], ELEM),
    ("Upsample_bicubic", lambda m: m.nn.Upsample(size=[11, 8], mode="bicubic"), ["x4"], ELEM),
    ("Upsample_align", lambda m: m.nn.Upsample(size=[9, 9], mode="bilinear",
                                               align_corners=True), ["x4"], ELEM),
    ("UpsamplingBilinear2D", lambda m: m.nn.UpsamplingBilinear2D(scale_factor=2), ["x4"], ELEM),
    ("UpsamplingNearest2D", lambda m: m.nn.UpsamplingNearest2D(size=[3, 4]), ["x4"], ELEM),
    ("PixelShuffle", lambda m: m.nn.PixelShuffle(2), ["img8"], ELEM),
    ("PixelUnshuffle", lambda m: m.nn.PixelUnshuffle(2), ["x4"], ELEM),
    ("PixelUnshuffle_nhwc", lambda m: m.nn.PixelUnshuffle(2, data_format="NHWC"), ["nhwc"], ELEM),
    ("Fold", lambda m: m.nn.Fold([4, 4], 2, strides=2), ["cols"], ELEM),
    ("Unfold", lambda m: m.nn.Unfold(3, paddings=1), ["x4"], ELEM),
    ("Bilinear", lambda m: m.nn.Bilinear(4, 5, 3), ["a34", "b35"], ELEM),
    ("CosineSimilarity", lambda m: m.nn.CosineSimilarity(axis=1), ["x2", "x2"], ELEM),
    ("PairwiseDistance", lambda m: m.nn.PairwiseDistance(), ["x2", "x2"], ELEM),
    ("Dropout", lambda m: m.nn.Dropout(0.0), ["x3"], ELEM),
    ("Dropout2D", lambda m: m.nn.Dropout2D(0.0), ["x4"], ELEM),
    ("Dropout3D", lambda m: m.nn.Dropout3D(0.0), ["x5"], ELEM),
    ("AlphaDropout", lambda m: m.nn.AlphaDropout(0.0), ["x3"], ELEM),
    # conv
    ("Conv1D", lambda m: m.nn.Conv1D(4, 3, 3, padding=1), ["x1d"], NORM),
    ("Conv1D_same_s2", lambda m: m.nn.Conv1D(4, 3, 4, stride=2, padding="SAME"), ["x1d"], NORM),
    ("Conv2D", lambda m: m.nn.Conv2D(4, 5, 3, padding=1), ["x4"], NORM),
    ("Conv2D_same_s2", lambda m: m.nn.Conv2D(4, 5, 3, stride=2, padding="SAME"), ["x7"], NORM),
    ("Conv2D_same_dilated", lambda m: m.nn.Conv2D(4, 2, 3, padding="same", dilation=2),
     ["x4"], NORM),
    ("Conv2D_valid", lambda m: m.nn.Conv2D(4, 2, 3, padding="VALID", bias_attr=False), ["x4"], NORM),
    ("Conv2D_asym", lambda m: m.nn.Conv2D(4, 3, 3, padding=[1, 0, 2, 1], stride=2), ["x7"], NORM),
    ("Conv2D_pairs", lambda m: m.nn.Conv2D(4, 3, (3, 2), padding=[2, 0]), ["x4"], NORM),
    ("Conv2D_groups", lambda m: m.nn.Conv2D(4, 6, 3, padding=1, groups=2), ["x4"], NORM),
    ("Conv2D_nhwc", lambda m: m.nn.Conv2D(4, 3, 3, padding=1, data_format="NHWC"), ["nhwc"], NORM),
    ("Conv2D_nhwc_same", lambda m: m.nn.Conv2D(4, 3, 3, stride=2, padding="SAME",
                                               data_format="NHWC"), ["nhwc"], NORM),
    ("Conv3D", lambda m: m.nn.Conv3D(2, 3, 3, padding=1, stride=2), ["x5"], NORM),
    ("Conv1DTranspose", lambda m: m.nn.Conv1DTranspose(4, 3, 3, stride=2, padding=1,
                                                       output_padding=1), ["x1d"], NORM),
    ("Conv2DTranspose", lambda m: m.nn.Conv2DTranspose(4, 3, 3, stride=2, padding=1), ["x4"], NORM),
    ("Conv2DTranspose_op", lambda m: m.nn.Conv2DTranspose(4, 2, 4, stride=2, padding=[1, 2],
                                                          output_padding=1, groups=2), ["x4"], NORM),
    ("Conv2DTranspose_asym", lambda m: m.nn.Conv2DTranspose(4, 2, 3, stride=2,
                                                            padding=[0, 1, 2, 0]), ["x4"], NORM),
    ("Conv3DTranspose", lambda m: m.nn.Conv3DTranspose(2, 2, 2, stride=2), ["x5"], NORM),
    # norm
    ("BatchNorm1D", lambda m: m.nn.BatchNorm1D(8), ["x2"], NORM),
    ("BatchNorm1D_3d", lambda m: m.nn.BatchNorm1D(4, momentum=0.5), ["x3"], NORM),
    ("BatchNorm2D", lambda m: m.nn.BatchNorm2D(4), ["x4"], NORM),
    ("BatchNorm2D_nhwc", lambda m: m.nn.BatchNorm2D(4, data_format="NHWC"), ["nhwc"], NORM),
    ("BatchNorm3D", lambda m: m.nn.BatchNorm3D(2, epsilon=1e-3), ["x5"], NORM),
    ("BatchNorm_act", lambda m: m.nn.BatchNorm(4, act="relu"), ["x4"], NORM),
    ("BatchNorm2D_global", lambda m: m.nn.BatchNorm2D(4, use_global_stats=True), ["x4"], NORM),
    ("SyncBatchNorm", lambda m: m.nn.SyncBatchNorm(4), ["x4"], NORM),
    ("LayerNorm", lambda m: m.nn.LayerNorm([6, 6]), ["x4"], NORM),
    ("GroupNorm", lambda m: m.nn.GroupNorm(2, 4), ["x4"], NORM),
    ("InstanceNorm1D", lambda m: m.nn.InstanceNorm1D(4), ["x3"], NORM),
    ("InstanceNorm2D", lambda m: m.nn.InstanceNorm2D(4), ["x4"], NORM),
    ("InstanceNorm3D", lambda m: m.nn.InstanceNorm3D(2), ["x5"], NORM),
    ("LocalResponseNorm", lambda m: m.nn.LocalResponseNorm(3), ["x4"], NORM),
    ("SpectralNorm", lambda m: m.nn.SpectralNorm([4, 6], power_iters=2), ["w46"], NORM),
    # pooling
    ("MaxPool1D", lambda m: m.nn.MaxPool1D(2), ["x1d"], NORM),
    ("MaxPool2D", lambda m: m.nn.MaxPool2D(3, stride=2, padding=1), ["x7"], NORM),
    ("MaxPool2D_ceil", lambda m: m.nn.MaxPool2D(2, ceil_mode=True), ["x7"], NORM),
    ("MaxPool2D_same", lambda m: m.nn.MaxPool2D(3, stride=2, padding="SAME"), ["x4"], NORM),
    ("MaxPool2D_nhwc", lambda m: m.nn.MaxPool2D(2, data_format="NHWC"), ["nhwc"], NORM),
    ("MaxPool2D_mask", lambda m: m.nn.MaxPool2D(3, stride=2, padding=1, return_mask=True),
     ["x7"], NORM),
    ("MaxPool3D", lambda m: m.nn.MaxPool3D(2, stride=2, padding=1, ceil_mode=True), ["x5"], NORM),
    ("AvgPool1D", lambda m: m.nn.AvgPool1D(3, stride=2, padding=1), ["x1d"], NORM),
    ("AvgPool1D_incl", lambda m: m.nn.AvgPool1D(3, stride=2, padding=1, exclusive=False,
                                                ceil_mode=True), ["x1d"], NORM),
    ("AvgPool2D", lambda m: m.nn.AvgPool2D(2), ["x4"], NORM),
    ("AvgPool2D_excl_pad", lambda m: m.nn.AvgPool2D(3, stride=2, padding=1), ["x7"], NORM),
    ("AvgPool2D_incl_pad", lambda m: m.nn.AvgPool2D(3, stride=2, padding=1, exclusive=False),
     ["x7"], NORM),
    ("AvgPool2D_ceil_excl", lambda m: m.nn.AvgPool2D(2, ceil_mode=True), ["x7"], NORM),
    ("AvgPool2D_ceil_incl", lambda m: m.nn.AvgPool2D(3, stride=2, padding=1, ceil_mode=True,
                                                     exclusive=False), ["x4"], NORM),
    ("AvgPool2D_same", lambda m: m.nn.AvgPool2D(3, stride=2, padding="SAME"), ["x4"], NORM),
    ("AvgPool2D_divisor", lambda m: m.nn.AvgPool2D(2, divisor_override=3), ["x4"], NORM),
    ("AvgPool2D_nhwc", lambda m: m.nn.AvgPool2D(3, stride=1, padding=1, data_format="NHWC"),
     ["nhwc"], NORM),
    ("AvgPool3D", lambda m: m.nn.AvgPool3D(3, stride=2, padding=1), ["x5"], NORM),
    ("AvgPool3D_ceil_incl", lambda m: m.nn.AvgPool3D(2, stride=2, padding=1, ceil_mode=True,
                                                     exclusive=False), ["x5"], NORM),
    ("AdaptiveAvgPool1D", lambda m: m.nn.AdaptiveAvgPool1D(4), ["x1d"], NORM),
    ("AdaptiveAvgPool2D", lambda m: m.nn.AdaptiveAvgPool2D((1, 1)), ["x7"], NORM),
    ("AdaptiveAvgPool2D_uneven", lambda m: m.nn.AdaptiveAvgPool2D((3, 4)), ["x7"], NORM),
    ("AdaptiveAvgPool3D", lambda m: m.nn.AdaptiveAvgPool3D(3), ["x5"], NORM),
    ("AdaptiveMaxPool1D", lambda m: m.nn.AdaptiveMaxPool1D(4), ["x1d"], NORM),
    ("AdaptiveMaxPool2D", lambda m: m.nn.AdaptiveMaxPool2D((3, 2)), ["x7"], NORM),
    ("AdaptiveMaxPool3D", lambda m: m.nn.AdaptiveMaxPool3D(3), ["x5"], NORM),
    ("MaxUnPool1D", lambda m: m.nn.MaxUnPool1D(2), ["unpool1"], NORM),
    ("MaxUnPool2D", lambda m: m.nn.MaxUnPool2D(2), ["unpool2"], NORM),
    ("MaxUnPool3D", lambda m: m.nn.MaxUnPool3D(2), ["unpool3"], NORM),
    # losses
    ("CrossEntropyLoss", lambda m: m.nn.CrossEntropyLoss(), ["logits", "cls"], ELEM),
    ("CrossEntropyLoss_sum_ignore", lambda m: m.nn.CrossEntropyLoss(ignore_index=2,
                                                                    reduction="sum"),
     ["logits", "cls_ign"], ELEM),
    ("CrossEntropyLoss_mean_ignore", lambda m: m.nn.CrossEntropyLoss(ignore_index=2),
     ["logits", "cls_ign"], ELEM),
    ("CrossEntropyLoss_none", lambda m: m.nn.CrossEntropyLoss(reduction="none"),
     ["logits", "cls"], ELEM),
    ("CrossEntropyLoss_smooth", lambda m: m.nn.CrossEntropyLoss(label_smoothing=0.1),
     ["logits", "cls"], ELEM),
    ("CrossEntropyLoss_weight", lambda m: m.nn.CrossEntropyLoss(
        weight=m.to_tensor(np.linspace(0.5, 2.0, 5).astype(np.float32)), ignore_index=2),
     ["logits", "cls_ign"], ELEM),
    ("CrossEntropyLoss_soft", lambda m: m.nn.CrossEntropyLoss(soft_label=True),
     ["logits", "soft"], ELEM),
    ("CrossEntropyLoss_probs", lambda m: m.nn.CrossEntropyLoss(use_softmax=False),
     ["prob", "cls"], ELEM),
    ("CrossEntropyLoss_axis1", lambda m: m.nn.CrossEntropyLoss(axis=1),
     ["logits_c1", "cls_c1"], ELEM),
    ("MSELoss", lambda m: m.nn.MSELoss(), ["logits", "prob"], ELEM),
    ("L1Loss", lambda m: m.nn.L1Loss(reduction="sum"), ["logits", "prob"], ELEM),
    ("SmoothL1Loss", lambda m: m.nn.SmoothL1Loss(delta=0.5), ["logits", "prob"], ELEM),
    ("BCELoss", lambda m: m.nn.BCELoss(), ["prob", "bin"], ELEM),
    ("BCEWithLogitsLoss", lambda m: m.nn.BCEWithLogitsLoss(
        pos_weight=m.to_tensor(np.linspace(0.5, 2.0, 5).astype(np.float32))),
     ["logits", "bin"], ELEM),
    ("NLLLoss", lambda m: m.nn.NLLLoss(ignore_index=2), ["logp", "cls_ign"], ELEM),
    ("NLLLoss_weight", lambda m: m.nn.NLLLoss(
        weight=m.to_tensor(np.linspace(0.5, 2.0, 5).astype(np.float32)), reduction="sum"),
     ["logp", "cls"], ELEM),
    ("KLDivLoss", lambda m: m.nn.KLDivLoss(reduction="batchmean"), ["logp", "prob"], ELEM),
    ("MarginRankingLoss", lambda m: m.nn.MarginRankingLoss(0.3), ["r6", "r6", "sgn6"], ELEM),
    ("HingeEmbeddingLoss", lambda m: m.nn.HingeEmbeddingLoss(0.5), ["logits", "pm1"], ELEM),
    ("CTCLoss", lambda m: m.nn.CTCLoss(blank=0), ["ctc_lp", "ctc_lab", "ctc_in", "ctc_len"],
     ELEM),
    ("HSigmoidLoss", lambda m: m.nn.HSigmoidLoss(5, 6), ["feat", "leaf"], ELEM),
    # transformer
    ("MultiHeadAttention", lambda m: m.nn.MultiHeadAttention(8, 2), ["seq"], NORM),
    ("MultiHeadAttention_cross", lambda m: m.nn.MultiHeadAttention(8, 2, kdim=8, vdim=8),
     ["seq", "mem", "mem"], NORM),
    ("TransformerEncoderLayer", lambda m: m.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0),
     ["seq"], NORM),
    ("TransformerEncoderLayer_pre", lambda m: m.nn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0, activation="gelu", normalize_before=True), ["seq"], NORM),
    ("TransformerEncoder", lambda m: m.nn.TransformerEncoder(
        m.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0), 2, m.nn.LayerNorm(8)),
     ["seq"], NORM),
    ("TransformerDecoderLayer", lambda m: m.nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0),
     ["seq", "mem"], NORM),
    ("TransformerDecoder", lambda m: m.nn.TransformerDecoder(
        m.nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0), 2), ["seq", "mem"], NORM),
    ("Transformer", lambda m: m.nn.Transformer(8, 2, 1, 1, 16, dropout=0.0), ["mem", "seq"],
     NORM),
]
_BY_ID = {c[0]: c for c in CASES}
assert len(_BY_ID) == len(CASES), "duplicate case ids"


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _numpy(t):
    """A copy: a torch tensor's ``numpy()`` shares its storage, which a later
    in-place op would change."""
    return np.array(t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy())


def _run(mod, layer, arrays, train):
    """Outputs, input gradients, parameter gradients by name and the
    state after the call, of ``layer`` in ``mod`` on ``arrays``."""
    layer.train() if train else layer.eval()
    is_jax = mod is paddle
    xs = []
    for a in arrays:
        float_in = a.dtype == np.float32
        if is_jax:
            xs.append(paddle.to_tensor(a, stop_gradient=not float_in))
        else:
            xs.append(torch.from_numpy(a.copy()).requires_grad_(float_in))
    outs = _flat(layer(*xs))
    rng = np.random.default_rng(11)
    loss = None
    for o in outs:
        if _numpy(o).dtype != np.float32:
            continue
        w = rng.standard_normal(tuple(o.shape)).astype(np.float32)
        term = (o * (paddle.to_tensor(w) if is_jax else torch.from_numpy(w))).sum()
        loss = term if loss is None else loss + term
    if loss is not None and (not is_jax or not loss.stop_gradient):
        loss.backward()
    grads = [None if x.grad is None else _numpy(x.grad) for x in xs]
    pgrads = {n: None if p.grad is None else _numpy(p.grad) for n, p in layer.named_parameters()}
    state = {k: _numpy(v) for k, v in layer.state_dict().items()}
    return [_numpy(o) for o in outs], grads, pgrads, state


def _close(got, want, tol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _pair(ctor):
    paddle.seed(0)
    jl = ctor(paddle)
    tl = ctor(pt)
    state_dict_from_numpy(tl, {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()})
    return jl, tl


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(_BY_ID))
def test_layer_matches_jax(case, train):
    _, ctor, specs, tol = _BY_ID[case]
    jl, tl = _pair(ctor)
    if specs[0].startswith("unpool"):
        arrays = _unpool_inputs(int(specs[0][-1]))
    else:
        arrays = _inputs(specs, 3)
    jo, jg, jp, js = _run(paddle, jl, arrays, train)
    to, tg, tp_, ts = _run(pt, tl, arrays, train)
    assert len(to) == len(jo), case
    for i, (a, b) in enumerate(zip(to, jo)):
        _close(a, b, tol, f"{case} output {i}")
    for i, (a, b) in enumerate(zip(tg, jg)):
        if a is None or b is None:
            assert not np.any(a if b is None else b), f"{case} input grad {i}"
        else:
            _close(a, b, tol, f"{case} input grad {i}")
    assert sorted(tp_) == sorted(jp), case
    for name, b in jp.items():
        a = tp_[name]
        if a is None or b is None:
            assert not np.any(a if b is None else b), f"{case} grad {name}"
        else:
            _close(a, b, tol, f"{case} grad {name}")
    assert list(ts) == list(js), case
    for name in js:
        _close(ts[name], js[name], tol, f"{case} state {name}")


@pytest.mark.parametrize("momentum", [0.9, 0.1])
def test_batch_norm_running_statistics_after_three_calls(momentum):
    """``running = momentum * running + (1 - momentum) * batch`` with the
    biased batch variance, written into the same buffers (in place), against
    the JAX layer's buffers and the formula."""
    jl, tl = _pair(lambda m: m.nn.BatchNorm2D(4, momentum=momentum))
    ptrs = (tl._mean.data_ptr(), tl._variance.data_ptr())
    mean, var = np.zeros(4), np.ones(4)
    for i in range(3):
        x = _inputs(["x4"], 20 + i)[0] * (i + 1) + i
        jl(paddle.to_tensor(x))
        tl(torch.from_numpy(x))
        mean = momentum * mean + (1 - momentum) * x.mean(axis=(0, 2, 3))
        var = momentum * var + (1 - momentum) * x.var(axis=(0, 2, 3))  # ddof 0
    assert (tl._mean.data_ptr(), tl._variance.data_ptr()) == ptrs
    for name, want in (("_mean", mean), ("_variance", var)):
        got = tl.state_dict()[name].numpy()
        np.testing.assert_allclose(got, jl.state_dict()[name].numpy(), rtol=NORM, atol=NORM)
        np.testing.assert_allclose(got, want, rtol=NORM, atol=NORM)
    # eval mode normalises by the running statistics
    x = _inputs(["x4"], 30)[0]
    tl.eval()
    jl.eval()
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), rtol=NORM, atol=NORM)


@pytest.mark.parametrize("layer", ["Dropout", "Dropout_axis", "Dropout2D", "Dropout3D",
                                   "AlphaDropout"])
def test_dropout_layers_mask_by_their_rule(layer):
    """In training the masks come from different generators, so each
    package's output is held to the layer's rule: kept entries x / (1 - p)
    and the rest 0, constant along the axes the mask does not vary on;
    AlphaDropout's dropped entries all equal a + b, its kept ones a x + b."""
    p = 0.4
    x = np.abs(_inputs(["x4" if layer == "Dropout2D" else "x5"], 4)[0]) + 1.0
    for mod in (paddle, pt):
        make = {"Dropout": lambda: mod.nn.Dropout(p),
                "Dropout_axis": lambda: mod.nn.Dropout(p, axis=[0, 1]),
                "Dropout2D": lambda: mod.nn.Dropout2D(p),
                "Dropout3D": lambda: mod.nn.Dropout3D(p),
                "AlphaDropout": lambda: mod.nn.AlphaDropout(p)}[layer]
        out = _numpy(make()(mod.to_tensor(x)))
        if layer == "AlphaDropout":
            alpha, scale = 1.6732632423543772, 1.0507009873554805
            a = 1.0 / (scale * ((1 - p) * (1 + p * alpha ** 2)) ** 0.5)
            b = -a * (-alpha * scale) * p
            kept = np.isclose(out, a * x + b, rtol=1e-5)
            dropped = np.isclose(out, a * (-alpha * scale) + b, rtol=1e-5)
            assert np.all(kept | dropped) and kept.any() and dropped.any()
            continue
        kept = out != 0
        np.testing.assert_allclose(out[kept], (x / (1 - p))[kept], rtol=1e-6)
        assert kept.any() and (~kept).any()
        if layer != "Dropout":  # one draw per (sample, channel), or per (0, 1) index
            flat = kept.reshape(kept.shape[0], kept.shape[1], -1)
            assert np.all(flat == flat[..., :1])


def test_multi_head_attention_caches_and_mask():
    """An incremental ``Cache`` (two steps, the cache growing), a
    ``StaticCache`` of memory projections, and a bool mask (the dense
    route), against the JAX layer."""
    jl, tl = _pair(lambda m: m.nn.MultiHeadAttention(8, 2))
    q1, q2, mem = _inputs(["seq", "seq", "mem"], 8)
    q1, q2 = q1[:, :2], q2[:, :1]
    mask = np.tril(np.ones((3, 3), bool))[None, None, 2:]  # the step's row of a causal mask

    def run(mod, layer):
        t = mod.to_tensor
        cache = layer.gen_cache(t(q1))
        out1, cache = layer(t(q1), cache=cache)
        out2, cache = layer(t(q2), attn_mask=t(mask), cache=cache)
        static = layer.gen_cache(t(mem), t(mem), type=layer.StaticCache)
        out3 = layer(t(q2), t(mem), t(mem), cache=static)
        return [_numpy(o) for o in (out1, out2, cache.k, cache.v, out3)]

    for i, (a, b) in enumerate(zip(run(pt, tl), run(paddle, jl))):
        _close(a, b, NORM, f"cache output {i}")


def test_transformer_encoder_bool_mask_takes_the_dense_route():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    jl, tl = _pair(lambda m: m.nn.TransformerEncoder(
        m.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0), 2))
    x = _inputs(["seq"], 9)[0]
    mask = np.random.default_rng(9).random((2, 1, 5, 5)) > 0.3
    mask[..., 0] = True
    before = fa.flash_attention_fwd.launches
    got = _numpy(tl(pt.to_tensor(x), pt.to_tensor(mask)))
    assert fa.flash_attention_fwd.launches == before  # no kernel on the CPU either way
    want = _numpy(jl(paddle.to_tensor(x), paddle.to_tensor(mask)))
    _close(got, want, NORM, "masked encoder")
    sq = _numpy(pt.nn.Transformer.generate_square_subsequent_mask(4))
    np.testing.assert_array_equal(sq, _numpy(paddle.nn.Transformer.generate_square_subsequent_mask(4)))


def test_containers_match_jax():
    """``LayerList``'s Paddle methods (append, insert, extend), ``LayerDict``
    and ``ParameterList``: the same sublayer order and ``state_dict`` names
    as the JAX containers."""
    names = {}
    for mod in (paddle, pt):
        paddle.seed(0)
        ll = mod.nn.LayerList([mod.nn.Linear(2, 2)])
        ll.append(layer=mod.nn.Linear(2, 3))
        ll.insert(0, mod.nn.Linear(3, 2))
        ll.extend(layers=[mod.nn.Tanh(), mod.nn.Linear(3, 1)])
        ld = mod.nn.LayerDict({"a": mod.nn.Linear(2, 2)})
        ld["b"] = mod.nn.Linear(2, 1)
        pl = mod.nn.ParameterList([mod.create_parameter([2], "float32"),
                                   mod.create_parameter([3], "float32")])
        seq = mod.nn.Sequential(("first", mod.nn.Linear(2, 2)), ("second", mod.nn.ReLU()))
        names[mod] = ([type(layer).__name__ for layer in ll], list(ll.state_dict()),
                      list(ld.keys()), list(ld.state_dict()), list(pl.state_dict()),
                      len(pl), list(seq.state_dict()), type(seq[1]).__name__, len(seq[0:1]))
    assert names[pt] == names[paddle]


def test_param_attr_and_global_initializer():
    """``ParamAttr`` (initializer, trainable, name) through a layer's
    weight_attr, and ``set_global_initializer`` under an attribute without
    an initializer, against the JAX layers."""
    for mod in (paddle, pt):
        mod.nn.initializer.set_global_initializer(mod.nn.initializer.Constant(0.3),
                                                  mod.nn.initializer.Constant(-0.2))
    try:
        got = []
        for mod in (paddle, pt):
            lin = mod.nn.Linear(3, 2, weight_attr=mod.nn.ParamAttr(trainable=False, name="fc_w"))
            conv = mod.nn.Conv2D(2, 2, 1, weight_attr=mod.nn.ParamAttr(
                initializer=mod.nn.initializer.Assign(np.arange(4.0).reshape(2, 2, 1, 1))))
            got.append([_numpy(lin.weight), _numpy(lin.bias), _numpy(conv.weight),
                        _numpy(conv.bias)])
            trainable = getattr(lin.weight, "trainable", None)
            trainable = lin.weight.requires_grad if trainable is None else trainable
            name = getattr(lin.weight, "param_name", None) or lin.weight.name
            got[-1] += [np.array(trainable), np.array(name)]
        for a, b in zip(*got):
            np.testing.assert_array_equal(a, b)
    finally:
        for mod in (paddle, pt):
            mod.nn.initializer.set_global_initializer(None, None)


def test_nn_utils_match_jax():
    """``nn.utils``: weight norm (forward, the gradients of g and v, folded
    back), spectral norm from the same u, the gradient clips and the
    parameter-vector round trip, against the JAX functions."""
    x = _inputs(["x2"], 12)[0]
    outs = {paddle: [], pt: []}
    jl, tl = _pair(lambda m: m.nn.Linear(8, 3))
    sn_j, sn_t = _pair(lambda m: m.nn.Linear(8, 5))
    for mod, lin, sn in ((paddle, jl, sn_j), (pt, tl, sn_t)):
        mod.nn.utils.weight_norm(lin, dim=1)
        mod.nn.utils.spectral_norm(sn)
    with torch.no_grad():  # spectral norm's random start vector, carried across
        sn_t.weight_u.copy_(torch.from_numpy(np.array(sn_j.weight_u.numpy())))
    for mod, lin, sn in ((paddle, jl, sn_j), (pt, tl, sn_t)):
        xin = mod.to_tensor(x)
        out = lin(xin)
        out.sum().backward()
        outs[mod] += [_numpy(out), _numpy(lin.weight_g.grad), _numpy(lin.weight_v.grad),
                      _numpy(sn(xin))]
        total = mod.nn.utils.clip_grad_norm_([lin.weight_g, lin.weight_v], 0.5)
        mod.nn.utils.clip_grad_value_([lin.bias], 0.1)
        outs[mod] += [_numpy(total), _numpy(lin.weight_v.grad), _numpy(lin.bias.grad)]
        mod.nn.utils.remove_weight_norm(lin)
        vec = mod.nn.utils.parameters_to_vector(list(lin.parameters()))
        mod.nn.utils.vector_to_parameters(vec * 2, list(lin.parameters()))
        outs[mod] += [_numpy(vec), _numpy(lin.weight)]
    for i, (a, b) in enumerate(zip(outs[pt], outs[paddle])):
        _close(a, b, NORM, f"nn.utils output {i}")
