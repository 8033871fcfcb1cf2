"""Paddle autograd on torch's tape, against the JAX package's engine, on the
CPU: the cases of ``tests/test_autograd.py`` and
``tests/test_higher_order_grad.py`` (``backward``, ``paddle.grad``,
``retain_graph``, ``create_graph``, ``allow_unused``, hooks, ``PyLayer``)
run through both packages on the same seeded numpy inputs, the grad-mode
switches, and layers and ``nn.functional`` taking Tensors.

Tolerances as in ``tests/test_torch_op_sweep.py``: float32 rtol 1e-5 /
atol 1e-6 (XLA:CPU and ATen differ by ulps in transcendental functions and
in the order of sums).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from tests.test_torch_op_sweep import assert_same


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


def both(fn):
    """``fn(module)`` for both packages; each output compared (Tensors by
    values, dtype, shape and stop_gradient, the rest by ==)."""
    outs = {mod: fn(mod) for mod in (jp, tp)}
    j, t = outs[jp], outs[tp]
    for a, b in zip(j if isinstance(j, (list, tuple)) else [j],
                    t if isinstance(t, (list, tuple)) else [t]):
        if isinstance(a, jp.Tensor):
            assert_same(a, b, "output")
        else:
            assert a == b, (a, b)
    return outs


def leaf(p, a):
    return p.to_tensor(np.asarray(a, np.float32), stop_gradient=False)


# -- the cases of tests/test_autograd.py --------------------------------------
def test_simple_backward():
    def run(p):
        x = leaf(p, [2.0, 3.0])
        (x * x).sum().backward()
        return x.grad

    both(run)


def test_chain():
    def run(p):
        x = leaf(p, [0.5])
        p.tanh(p.exp(x)).backward()
        return x.grad

    both(run)


def test_grad_accumulation_across_backwards():
    def run(p):
        x = leaf(p, [1.0])
        (x * 2).backward()
        (x * 3).backward()
        g = x.grad
        x.clear_grad()
        return [g, x.grad is None, x.gradient is None]

    both(run)


def test_branching_and_diamond_graphs():
    def run(p):
        x = leaf(p, [2.0])
        (x * 3 + x * 4).backward()
        y = leaf(p, [2.0])
        z = (y * y) * (y * y) + y * y
        z.backward()
        return [x.grad, y.grad]

    both(run)


def test_matmul_and_broadcast_grads():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((3, 4)), rng.standard_normal((4, 2))

    def run(p):
        x, w = leaf(p, a), leaf(p, b)
        bias = leaf(p, np.ones(2))
        (p.matmul(x, w) + bias).sum().backward()
        return [x.grad, w.grad, bias.grad]

    both(run)


def test_stop_gradient_blocks_and_detach_cuts():
    def run(p):
        x = leaf(p, [1.0])
        y = p.to_tensor([2.0])
        (x * y).backward()
        u = leaf(p, [3.0])
        ((u * u).detach() * u).backward()
        return [x.grad, y.grad is None, u.grad]

    both(run)


def test_no_grad_context_and_decorator():
    def run(p):
        x = leaf(p, [1.0])
        with p.no_grad():
            y = x * 2
        inner = p.no_grad()(lambda v: v * 3)(x)
        bare = p.no_grad(lambda v: v * 4)(x)
        with p.no_grad():
            with p.enable_grad():
                z = x * 5
        return [y, y._grad_node is None, inner, bare, z, p.is_grad_enabled()]

    both(run)


def test_set_grad_enabled_sets_and_restores():
    for mod in (jp, tp):
        x = leaf(mod, [1.0])
        mod.set_grad_enabled(False)
        try:
            assert (x * 2).stop_gradient and not mod.is_grad_enabled()
        finally:
            mod.set_grad_enabled(True)
    with tp.set_grad_enabled(False):
        assert not tp.is_grad_enabled()
    assert tp.is_grad_enabled()


def test_backward_nonscalar_requires_grad_tensor():
    def run(p):
        x = leaf(p, [1.0, 2.0])
        with pytest.raises(RuntimeError):
            (x * 2).backward()
        (x * 2).backward(p.to_tensor([1.0, 0.5]))
        return x.grad

    both(run)


def test_double_backward_raises_without_retain():
    def run(p):
        x = leaf(p, [1.0])
        y = x * x
        y.backward(retain_graph=True)
        y.backward()
        z = x * x
        z.backward()
        with pytest.raises(RuntimeError):
            z.backward()
        return x.grad

    both(run)


def test_backward_of_a_tensor_that_stops_gradient_is_a_no_op():
    def run(p):
        x = p.to_tensor([1.0, 2.0])
        x.sum().backward()
        return x.grad is None

    both(run)


def test_multi_output_op_grad():
    def run(p):
        x = leaf(p, np.arange(6).reshape(2, 3))
        parts = p.split(x, 3, axis=1)
        (parts[0].sum() + 2 * parts[2].sum()).backward()
        return x.grad

    both(run)


def test_register_hook():
    def run(p):
        x = leaf(p, [1.0])
        seen = []

        def hook(g):
            seen.append(float(g))
            return g * 2

        x.register_hook(hook)
        (x * 3).backward()
        return [x.grad, seen]

    both(run)


def test_hook_on_an_intermediate_and_handle_remove():
    def run(p):
        x = leaf(p, [1.0, 2.0])
        y = x * 3
        handle = y.register_hook(lambda g: g * 10)
        y.sum().backward()
        first = x.grad.numpy().copy()
        handle.remove()
        x.clear_grad()
        (x * 3).sum().backward()
        return [p.to_tensor(first), x.grad]

    both(run)


def test_hook_survives_an_inplace_rebind():
    x = leaf(tp, [1.0, 2.0])
    y = x * 1.0
    y.register_hook(lambda g: g * 10)
    y.add_(tp.ones([2]))
    y.sum().backward()
    assert x.grad.tolist() == [10.0, 10.0]


def test_paddle_grad_api():
    def run(p):
        x, y = leaf(p, [2.0]), leaf(p, [3.0])
        gx, gy = p.grad([x * x * y], [x, y])
        return [gx, gy, x.grad is None]

    both(run)


def test_reduction_grads():
    a = np.random.default_rng(1).standard_normal((4, 5))

    def run(p):
        x, x2 = leaf(p, a), leaf(p, a)
        x.mean().backward()
        x2.max().backward()
        return [x.grad, x2.grad]

    both(run)


def test_softmax_cross_entropy_grad():
    logits = np.random.default_rng(2).standard_normal((4, 10))
    labels = np.array([1, 3, 5, 7])

    def run(p):
        x = leaf(p, logits)
        loss = p.nn.functional.cross_entropy(x, p.to_tensor(labels))
        loss.backward()
        return [loss, x.grad]

    both(run)


def test_getitem_grad():
    def run(p):
        x = leaf(p, np.ones((3, 3)))
        x[1].sum().backward()
        return x.grad

    both(run)


def test_setitem_is_recorded_on_the_tape():
    # a deliberate difference: the JAX cell rebinds outside its tape, so
    # there no gradient reaches the value set; here __setitem__ is an op
    x = leaf(tp, np.ones((2, 3)))
    v = leaf(tp, [5.0, 6.0, 7.0])
    y = x * 2
    y[0] = v
    (y * y).sum().backward()
    assert x.grad.tolist() == [[0.0, 0.0, 0.0], [8.0, 8.0, 8.0]]
    assert v.grad.tolist() == [10.0, 12.0, 14.0]
    assert y._inplace_version == 1 and not y.stop_gradient


def test_inplace_on_a_trainable_leaf_keeps_its_grad():
    def run(p):
        x = leaf(p, [1.0, 2.0])
        x.add_(p.ones([2]))
        (x * 3).sum().backward()
        return [x, x.grad, x.stop_gradient]

    both(run)


def test_inplace_under_no_grad_keeps_a_leaf_trainable():
    def run(p):
        x = leaf(p, [1.0, 2.0])
        (x * x).sum().backward()
        with p.no_grad():
            x.scale_(0.5)
        return [x, x.stop_gradient, x.is_leaf, x.grad]

    both(run)


def test_stop_gradient_setter():
    def run(p):
        x = p.to_tensor([1.0, 2.0])
        x.stop_gradient = False
        y = x * 2
        y.stop_gradient = True
        z = x * 3
        z.sum().backward()
        i = p.to_tensor([1, 2])
        i.stop_gradient = False
        return [x.grad, y.stop_gradient, i.stop_gradient, (i * 2).stop_gradient]

    both(run)
    y = leaf(tp, [1.0]) * 2
    y.stop_gradient = True  # on a non-leaf: detached
    assert y.is_leaf and y._value.grad_fn is None


# -- paddle.grad options --------------------------------------------------------
def test_allow_unused():
    def run(p):
        x, y = leaf(p, [1.0]), leaf(p, [2.0])
        with pytest.raises(RuntimeError, match="no gradient"):
            p.grad([x * 2], [x, y])
        gx, gy = p.grad([x * 2], [x, y], allow_unused=True)
        return [gx, gy is None]

    both(run)


def test_grad_outputs_and_retain_graph():
    def run(p):
        x = leaf(p, [1.0, 2.0])
        y = x * x
        (g1,) = p.grad([y], [x], grad_outputs=[p.to_tensor([1.0, 0.5])], retain_graph=True)
        (g2,) = p.grad([y.sum()], [x])
        with pytest.raises(RuntimeError):
            p.grad([y.sum()], [x])
        return [g1, g2]

    both(run)


def test_grad_wrt_an_intermediate():
    def run(p):
        x = leaf(p, [1.0, 2.0])
        h = x * 3
        return p.grad([(h * h).sum()], [h])

    both(run)


def test_no_grad_vars_block_the_flow_through_them():
    x = leaf(tp, [1.0, 2.0])
    h = x * 3
    out = (h * x).sum()
    (g,) = tp.grad([out], [x], no_grad_vars=[h])
    assert g.tolist() == [3.0, 6.0]  # only the direct path of x


def test_autograd_backward():
    def run(p):
        x = leaf(p, [1.0, 2.0])
        p.autograd.backward([(x * x).sum(), (x * 3).sum()])
        return x.grad

    both(run)


# -- the cases of tests/test_higher_order_grad.py -------------------------------
def test_double_grad_cubic():
    def run(p):
        x = leaf(p, [1.0, 2.0, 3.0])
        (g,) = p.grad([(x * x * x).sum()], [x], create_graph=True)
        (gg,) = p.grad([g.sum()], [x])
        return [g, gg]

    out = both(run)
    assert not out[tp][0].stop_gradient and out[tp][1].stop_gradient


def test_triple_grad():
    def run(p):
        x = leaf(p, [2.0])
        (g1,) = p.grad([(x ** 4).sum()], [x], create_graph=True)
        (g2,) = p.grad([g1.sum()], [x], create_graph=True)
        (g3,) = p.grad([g2.sum()], [x])
        return [g1, g2, g3]

    both(run)


def test_double_grad_matmul_chain():
    rng = np.random.default_rng(0)
    xv, wv = rng.standard_normal((3, 4)), rng.standard_normal((4, 2))

    def run(p):
        x, w = leaf(p, xv), leaf(p, wv)
        y = p.matmul(x, w)
        (gx,) = p.grad([(y * y).sum()], [x], create_graph=True)
        (gw,) = p.grad([gx.sum()], [w])
        return [gx, gw]

    both(run)


def test_backward_after_create_graph_accumulates_leaf():
    def run(p):
        x = leaf(p, [3.0])
        (g,) = p.grad([(x * x).sum()], [x], create_graph=True)
        (g * g).sum().backward()
        return x.grad

    both(run)


def test_first_order_unchanged_by_create_graph():
    def run(p):
        x = leaf(p, [0.3, -1.2])
        y = (p.tanh(x) * p.exp(x)).sum()
        (a,) = p.grad([y], [x], create_graph=True)
        (b,) = p.grad([(p.tanh(x) * p.exp(x)).sum()], [x])
        return [a, b]

    both(run)


# -- PyLayer ----------------------------------------------------------------------
def _cube_layer(p):
    class Cube(p.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k=1.0):
            ctx.save_for_backward(x)
            return x * x * x * k

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            return dy * 3 * x * x

    return Cube


def test_pylayer():
    def run(p):
        x = leaf(p, [1.0, 2.0])
        y = _cube_layer(p).apply(x, k=1.0)
        y.sum().backward()
        return [y, x.grad]

    both(run)


def test_pylayer_multiple_outputs_and_inputs():
    def build(p):
        class Split(p.autograd.PyLayer):
            @staticmethod
            def forward(ctx, a, b, scale):
                ctx.scale = scale
                return a * scale, a + b

            @staticmethod
            def backward(ctx, da, dsum):
                return da * ctx.scale + dsum, dsum

        return Split

    def run(p):
        a, b = leaf(p, [1.0, 2.0]), leaf(p, [3.0, 4.0])
        u, v = build(p).apply(a, b, 2.0)
        (u * 2 + v * 3).sum().backward()
        return [u, v, a.grad, b.grad]

    both(run)


def test_pylayer_without_trainable_inputs_stops_gradient():
    def run(p):
        return _cube_layer(p).apply(p.to_tensor([2.0]))

    both(run)


def test_pylayer_wrong_number_of_grads_raises():
    class Bad(tp.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y):
            return x + y

        @staticmethod
        def backward(ctx, dy):
            return dy

    with pytest.raises(RuntimeError, match="returned 1 grads for 2 tensor inputs"):
        Bad.apply(leaf(tp, [1.0]), leaf(tp, [2.0])).sum().backward()


def test_pylayer_mark_non_differentiable():
    class ArgAndValue(tp.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            m = x.max()
            ctx.mark_non_differentiable(m)
            return x * 2, m

        @staticmethod
        def backward(ctx, dx, dm):
            return dx * 2

    x = leaf(tp, [1.0, 3.0])
    y, m = ArgAndValue.apply(x)
    assert m.stop_gradient and not y.stop_gradient
    y.sum().backward()
    assert x.grad.tolist() == [2.0, 2.0]


# -- layers and nn.functional take Tensors ---------------------------------------
def test_layer_takes_tensors_and_returns_tensors():
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining, GPTPretrainingCriterion

    tp.seed(1)
    cfg = GPTConfig(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2, max_seq_len=16,
                    dropout=0.0, attn_dropout=0.0)
    model = GPTForPretraining(cfg)
    crit = GPTPretrainingCriterion()
    ids = np.random.default_rng(0).integers(0, 32, (2, 9))
    x, y = tp.to_tensor(ids[:, :-1]), tp.to_tensor(ids[:, 1:])
    logits = model(x)
    assert isinstance(logits, tp.Tensor) and not logits.stop_gradient
    loss = crit(logits, y)
    assert isinstance(loss, tp.Tensor) and loss.shape == []
    loss.backward()
    grads = [p.grad.clone() for p in model.parameters()]
    model.clear_gradients()
    # the same step with torch tensors: the same bits
    crit(model(torch.as_tensor(ids[:, :-1])), torch.as_tensor(ids[:, 1:])).backward()
    assert all(torch.equal(a, p.grad) for a, p in zip(grads, model.parameters()))


def test_grad_of_the_loss_by_the_logits_equals_torch():
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining, GPTPretrainingCriterion

    tp.seed(2)
    model = GPTForPretraining(GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                                        num_heads=2, max_seq_len=16))
    ids = tp.to_tensor(np.random.default_rng(1).integers(0, 32, (2, 8)))
    logits = model(ids)
    loss = GPTPretrainingCriterion()(logits, ids)
    (g,) = tp.grad(loss, [logits], retain_graph=True)
    (want,) = torch.autograd.grad(loss._value, logits._value)
    assert torch.equal(g._value, want) and g.stop_gradient
    with tp.no_grad():
        ev = model(ids)
    assert ev.stop_gradient and ev._value.grad_fn is None
    acc = (tp.argmax(ev, axis=-1) == ids).astype("float32").mean()
    assert float(acc) == float((ev._value.argmax(-1) == ids._value).float().mean())


def test_functional_takes_tensors():
    F = tp.nn.functional
    x = leaf(tp, np.random.default_rng(3).standard_normal((2, 4)))
    w = tp.to_tensor(np.ones((4, 3), np.float32))
    out = F.linear(x, w)
    assert isinstance(out, tp.Tensor) and out.shape == [2, 3]
    assert isinstance(F.gelu(out), tp.Tensor) and isinstance(F.softmax(out), tp.Tensor)
    # a torch tensor call returns a torch tensor, as before
    assert isinstance(F.gelu(torch.ones(2)), torch.Tensor)
    lin = tp.nn.Linear(4, 3)
    assert isinstance(lin(x), tp.Tensor) and isinstance(lin(torch.ones(1, 4)), torch.Tensor)


def test_layer_unwraps_tensors_inside_containers():
    class Pair(tp.nn.Layer):
        def forward(self, xs, scale=None):
            assert all(isinstance(x, torch.Tensor) for x in xs)
            assert isinstance(scale["s"], torch.Tensor)
            return {"sum": xs[0] + xs[1], "scaled": [xs[0] * scale["s"]]}

    a = leaf(tp, np.ones((2, 3)))
    b = tp.to_tensor(np.full((2, 3), 2.0, np.float32))
    out = Pair()([a, b], scale={"s": tp.to_tensor(3.0)})
    assert isinstance(out["sum"], tp.Tensor) and isinstance(out["scaled"][0], tp.Tensor)
    np.testing.assert_array_equal(out["sum"].numpy(), np.full((2, 3), 3.0, np.float32))
    out["scaled"][0].sum().backward()
    np.testing.assert_array_equal(a.grad.numpy(), np.full((2, 3), 3.0, np.float32))
    # torch tensors in the same containers come back as torch tensors
    raw = Pair()([torch.ones(1), torch.ones(1)], scale={"s": torch.ones(1)})
    assert isinstance(raw["sum"], torch.Tensor)
