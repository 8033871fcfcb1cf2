"""``paddle.vision.models`` of the port against the JAX package's, on the CPU.

Weights and batch-norm statistics are carried across with
``state_dict_from_numpy``; inputs are made from a seed with numpy.
Tolerances: model outputs, gradients, parameters and statistics 1e-4 in
f32 (XLA:CPU and oneDNN sum the convolutions in different orders); 3e-2
under AMP O2 bf16, as ``test_torch_train.py``, of each tensor's largest
magnitude: the two round to bf16 at different places (torch after every
op, XLA between fused ones), a few bf16 ulps per op, and a batch norm
divides those by a small standard deviation, so a near-zero entry can
move by ~2e-2 of the tensor's scale.

ResNet-18 in training runs at 2 x 3 x 64 x 64. At 32 x 32 its last stage
sees a 1 x 1 map, so each channel's batch statistics rest on the batch's
two values and the normalised output is about +-1, switching sign where
the two nearly tie: there the packages' summation-order differences
(~1e-5) grow to ~1e-2 in the logits, whoever computes it. 64 x 64 leaves
the last stage 2 x 2 (8 values a channel); the 32 x 32 forward is held in
eval mode, where the running statistics normalise.

Every constructor of the zoo is held against the JAX one by the
arguments it hands its model class, which saves building ResNet-152 or a
VGG's 100M-parameter classifier on the CPU twice; the classes themselves
are held by forward, gradient and training-step parity at small sizes
(AlexNet and MobileNetV2 whole, in eval mode).
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.models as JM
import paddle_tpu_torch as pt
import paddle_tpu_torch.vision.models as TM
from paddle_tpu_torch.convert import state_dict_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
TOL_O2 = dict(rtol=3e-2, atol=3e-2, of_scale=True)


@pytest.fixture(autouse=True)
def _cpu():
    previous = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(previous)


def _pair(make_j, make_t):
    paddle.seed(0)
    jm = make_j()
    tm = make_t()
    state_dict_from_numpy(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if isinstance(t, paddle.Tensor):
        return np.asarray(t.astype("float32").numpy())
    return np.asarray(t, np.float32)  # a jax array (optimizer state)


def _close(got, want, what="", of_scale=False, **tol):
    if of_scale:
        tol["atol"] *= max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _same_state(jm, tm, tol):
    """Parameters and buffers by name (the JAX dict lists every parameter
    before the buffers, torch's each layer's in turn)."""
    js, ts = jm.state_dict(), tm.state_dict()
    assert sorted(ts) == sorted(js)
    for name, jv in js.items():
        _close(_np(ts[name]), _np(jv), name, **tol)


def test_resnet18_eval_forward_at_32():
    jm, tm = _pair(lambda: JM.resnet18(num_classes=10), lambda: TM.resnet18(num_classes=10))
    jm.eval()
    tm.eval()
    x = _x((2, 3, 32, 32))
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))), _np(jm(paddle.to_tensor(x))),
                               **TOL)


def test_resnet18_train_forward_and_compiled_momentum_step():
    """Training-mode forward (batch statistics, running statistics updated in
    place), then one ``compile_train_step`` with Momentum on Paddle Tensors:
    the loss, every updated parameter, velocity and BN buffer."""
    jm, tm = _pair(lambda: JM.resnet18(num_classes=10), lambda: TM.resnet18(num_classes=10))
    x = _x((2, 3, 64, 64))
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))), _np(jm(paddle.to_tensor(x))), **TOL)
    _same_state(jm, tm, TOL)
    y = np.array([3, 7], np.int64)
    steps = []
    for mod, model in ((paddle, jm), (pt, tm)):
        opt = mod.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=model.parameters())
        crit = mod.nn.CrossEntropyLoss()
        steps.append((mod.jit.compile_train_step(
            model, lambda out, lab, crit=crit: crit(out.astype("float32"), lab), opt), opt))
    ptrs = [b.data_ptr() for b in tm.buffers()]
    losses = [float(step(mod.to_tensor(x), mod.to_tensor(y)))
              for (step, _), mod in zip(steps, (paddle, pt))]
    np.testing.assert_allclose(losses[1], losses[0], **TOL)
    _same_state(jm, tm, TOL)
    assert [b.data_ptr() for b in tm.buffers()] == ptrs
    jopt, topt = steps[0][1], steps[1][1]
    for (name, jp_), tp_ in zip(jm.named_parameters(), tm.parameters()):
        jv = jopt._accumulators[id(jp_)]["velocity"]
        np.testing.assert_allclose(_np(topt._state_of(tp_)["velocity"]), _np(jv), err_msg=name,
                                   **TOL)


def _stage(mod):
    """A ResNet stage at narrow widths: a strided BottleneckBlock with its
    downsample, then a plain one."""
    nn = mod.nn
    down = nn.Sequential(nn.Conv2D(8, 16, 1, stride=2, bias_attr=False), nn.BatchNorm2D(16))
    models = mod.vision.models
    return nn.Sequential(models.BottleneckBlock(8, 4, stride=2, downsample=down),
                         models.BottleneckBlock(16, 4))


@pytest.mark.parametrize("o2", [False, True], ids=["f32", "o2_bf16"])
def test_bottleneck_stage_forward_and_gradients(o2):
    """Output, batch-norm statistics and the weighted sum of the output in
    f32 and under O2; the gradients in f32. Under O2 at this size both
    packages' bf16 backward passes stray 10-30% of each gradient's scale
    from the f32 gradient on the same weights (a batch norm over 64 values
    a channel divides bf16 rounding by a small deviation, and the two round
    at different places), so no bf16 gradient is the other's reference."""
    jm, tm = _pair(lambda: _stage(paddle), lambda: _stage(pt))
    if o2:
        jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        tm = pt.amp.decorate(tm, level="O2", dtype="bfloat16")
    tol = TOL_O2 if o2 else TOL
    x = _x((4, 8, 8, 8), seed=1)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    jo, to = jm(jx), tm(tx)
    _close(_np(to), _np(jo), "output", **tol)
    _same_state(jm, tm, tol)
    w = _x(tuple(to.shape), seed=2)
    jl = (jo.astype("float32") * paddle.to_tensor(w)).sum()
    tl = (to.float() * torch.from_numpy(w)).sum()
    _close(_np(tl), _np(jl), "weighted sum", rtol=tol["rtol"],
           atol=tol["atol"] * float(np.abs(_np(jo)).sum()) if o2 else tol["atol"])
    if o2:
        return
    jl.backward()
    tl.backward()
    _close(tx.grad.numpy(), _np(jx.grad), "input grad", **tol)
    for (name, jp_), tp_ in zip(jm.named_parameters(), tm.parameters()):
        _close(_np(tp_.grad), _np(jp_.grad), name, **tol)


def test_lenet_forward_and_gradients():
    jm, tm = _pair(JM.LeNet, TM.LeNet)
    x = _x((3, 1, 28, 28))
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    jo, to = jm(jx), tm(tx)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    jo.sum().backward()
    to.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), **TOL)
    for (name, jp_), tp_ in zip(jm.named_parameters(), tm.parameters()):
        np.testing.assert_allclose(_np(tp_.grad), _np(jp_.grad), err_msg=name, **TOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_small_vgg_and_mobilenet_blocks(train):
    """VGG over a narrow feature stack with batch norm (the 7 x 7 pool, no
    classifier) and MobileNetV2's inverted residual blocks: forward and
    state."""
    cfg = [8, "M", 16, 16, "M"]
    cases = [
        (lambda: JM.VGG(JM._make_vgg_layers(cfg, True), num_classes=0),
         lambda: TM.VGG(TM._make_vgg_layers(cfg, True), num_classes=0), (2, 3, 16, 16)),
        (lambda: paddle.nn.Sequential(JM._InvertedResidual(8, 8, 1, 6),
                                      JM._InvertedResidual(8, 16, 2, 6)),
         lambda: pt.nn.Sequential(TM._InvertedResidual(8, 8, 1, 6),
                                  TM._InvertedResidual(8, 16, 2, 6)), (2, 8, 8, 8)),
    ]
    for make_j, make_t, shape in cases:
        jm, tm = _pair(make_j, make_t)
        jm.train() if train else jm.eval()
        tm.train() if train else tm.eval()
        x = _x(shape, seed=3)
        np.testing.assert_allclose(_np(tm(torch.from_numpy(x))), _np(jm(paddle.to_tensor(x))),
                                   **TOL)
        _same_state(jm, tm, TOL)


@pytest.mark.parametrize("name,shape", [("alexnet", (1, 3, 67, 67)),
                                        ("mobilenet_v2", (2, 3, 32, 32))])
def test_alexnet_and_mobilenet_v2_eval_forward(name, shape):
    """The two whole models no other test builds, in eval mode (their
    classifiers hold dropout), at the smallest input each takes."""
    jm, tm = _pair(lambda: getattr(JM, name)(num_classes=10),
                   lambda: getattr(TM, name)(num_classes=10))
    jm.eval()
    tm.eval()
    x = _x(shape, seed=4)
    _close(_np(tm(torch.from_numpy(x))), _np(jm(paddle.to_tensor(x))), name, **TOL)


# every constructor of the zoo and the arguments it hands its class
CONSTRUCTORS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
                "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d", "resnext50_64x4d",
                "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
                "vgg11", "vgg13", "vgg16", "vgg19", "mobilenet_v2", "alexnet"]


def _recorded(module, name, monkeypatch):
    calls = []

    def recorder(cls_name):
        def make(*args, **kwargs):
            calls.append((cls_name, tuple(getattr(a, "__name__", a) for a in args),
                          sorted(kwargs.items())))
        return make

    for cls_name in ("ResNet", "ResNeXt", "VGG", "MobileNetV2", "AlexNet"):
        monkeypatch.setattr(module, cls_name, recorder(cls_name))
    monkeypatch.setattr(module, "_make_vgg_layers", lambda cfg, bn=False: ("layers", tuple(cfg), bn))
    getattr(module, name)(num_classes=7)
    getattr(module, name)(num_classes=0, with_pool=False) if name != "alexnet" else None
    return calls


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_matches_jax(name, monkeypatch):
    assert callable(getattr(pt.vision.models, name))
    assert _recorded(TM, name, monkeypatch) == _recorded(JM, name, monkeypatch)


def test_top_level_aliases():
    for name in ("LeNet", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "vgg16"):
        assert getattr(pt.vision, name) is getattr(TM, name)


def test_resnet_depths_and_widths_match_jax_structure():
    """The class at every depth it takes, by sublayer kinds and shapes of
    the small ResNet-18/34 only (the deeper ones share the block code the
    stage test holds)."""
    for depth, block in ((18, "BasicBlock"), (34, "BasicBlock")):
        jm = JM.ResNet(getattr(JM, block), depth, num_classes=5)
        tm = TM.ResNet(getattr(TM, block), depth, num_classes=5)
        assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    tm = TM.resnet50()
    assert sum(1 for _ in tm.parameters()) == 161
    assert sum(p.numel() for p in tm.parameters()) == 25557032
    deep = copy.deepcopy(tm.layer1)
    assert sum(1 for _ in deep.parameters()) == 30
