"""``paddle.autograd``'s functional API of the port (``vjp``, ``jvp``,
``Jacobian``, ``Hessian``, ``jacobian``, ``hessian``) against the JAX
package's, on the CPU: the cases of ``tests/test_higher_order_grad.py:68-97``
on both packages, then several inputs, batched Jacobians, the 2-layer MLP
loss whose Jacobian and Hessian ``chip_smoke.py`` takes on the card, and the
error cases.

Tolerance: float32 rtol 1e-5 / atol 1e-6 (``tests/test_torch_op_sweep.py``'s:
sums in another order), 1e-4 relative to the largest entry for the MLP's
Hessian (second derivatives through tanh, summed in other orders).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


def _both(run):
    return {p: run(p) for p in (jp, tp)}


def _close(outs, rtol=RTOL, atol=ATOL):
    a, b = outs[jp], outs[tp]
    a = a if isinstance(a, (list, tuple)) else [a]
    b = b if isinstance(b, (list, tuple)) else [b]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = np.asarray(x.numpy() if hasattr(x, "numpy") else x)
        y = np.asarray(y.numpy() if hasattr(y, "numpy") else y)
        assert x.shape == y.shape, (x.shape, y.shape)
        np.testing.assert_allclose(y, x, rtol=rtol, atol=atol)


A = np.array([[2.0, 1.0], [0.0, 3.0]], np.float32)
W = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)


def test_hessian_quadratic():
    def run(p):
        def f(x):
            return p.matmul(p.matmul(x.reshape([1, 2]), p.to_tensor(A)), x.reshape([2, 1])).sum()

        x = p.to_tensor(np.array([1.0, -1.0], np.float32), stop_gradient=False)
        h = p.autograd.Hessian(f, x)
        assert h.shape == (2, 2)
        return h[:]

    outs = _both(run)
    _close(outs)
    np.testing.assert_allclose(outs[tp].numpy(), A + A.T, rtol=1e-5)


def test_jacobian():
    def run(p):
        def f(x):
            return p.matmul(x, p.to_tensor(W))

        x = p.to_tensor(np.array([[1.0, 0.0]], np.float32), stop_gradient=False)
        j = p.autograd.Jacobian(f, x)
        assert j.shape == (2, 2)
        return j[:], j[0], j.numpy()

    outs = _both(run)
    _close(outs)
    np.testing.assert_allclose(outs[tp][0].numpy(), W.T)


def test_vjp_jvp():
    def run(p):
        def f(x):
            return (x * x).sum()

        x = p.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
        out, g = p.autograd.vjp(f, x)
        out2, jv = p.autograd.jvp(f, x)
        assert out.stop_gradient and g.stop_gradient and jv.stop_gradient
        return [out, g, out2, jv]

    outs = _both(run)
    _close(outs)
    np.testing.assert_allclose(outs[tp][3].numpy(), 6.0)


def test_vjp_jvp_several_inputs_and_outputs_with_vectors():
    rng = np.random.default_rng(3)
    def draw(*shapes):
        return [rng.standard_normal(s).astype(np.float32) for s in shapes]

    x0, y0 = draw((3, 2), 2)
    v_out, v_in = draw((3, 2), 3), draw((3, 2), 2)

    def run(p):
        def f(x, y):
            return p.tanh(x * y), (x ** 2).sum(axis=1)

        xs = [p.to_tensor(x0), p.to_tensor(y0)]
        out, grads = p.autograd.vjp(f, xs, [p.to_tensor(v) for v in v_out])
        out2, jv = p.autograd.jvp(f, xs, [p.to_tensor(v) for v in v_in])
        return [*out, *grads, *out2, *jv]

    _close(_both(run))


def test_vjp_of_an_unused_input_is_zeros():
    def run(p):
        xs = [p.to_tensor(np.ones(2, np.float32)), p.to_tensor(np.ones(3, np.float32))]
        return p.autograd.vjp(lambda a, b: (a * 3).sum(), xs)[1]

    outs = _both(run)
    _close(outs)
    np.testing.assert_array_equal(outs[tp][1].numpy(), np.zeros(3))


def test_jacobian_of_several_inputs_and_batched():
    rng = np.random.default_rng(5)
    x0, y0 = (rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2))

    def run(p):
        def f(x, y):
            return p.sin(x) * y

        multi = p.autograd.Jacobian(f, [p.to_tensor(x0), p.to_tensor(y0)])
        batched = p.autograd.Jacobian(lambda x: p.exp(x) * 2.0, p.to_tensor(x0), is_batched=True)
        assert multi.shape == (12, 24) and batched.shape == (4, 3, 3)
        return [multi[:], batched[:], multi[2:5, 7]]

    _close(_both(run))


def _mlp_loss(p, x, y):
    """A 2-layer MLP's mean squared error as a function of its four weights."""
    def loss(w1, b1, w2, b2):
        h = p.tanh(p.matmul(p.to_tensor(x), w1) + b1)
        return ((p.matmul(h, w2) + b2 - p.to_tensor(y)) ** 2).mean()

    return loss


def test_mlp_loss_jacobian_and_hessian_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 2)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.5 for s in [(4, 5), (5,), (5, 2), (2,)]]

    def run(p):
        f = _mlp_loss(p, x, y)
        args = [p.to_tensor(w) for w in ws]
        jac = p.autograd.jacobian(f, args)
        hes = p.autograd.hessian(f, args)
        assert tuple(jac.shape) == (1, 37) and tuple(hes.shape) == (37, 37)
        return [jac, hes]

    outs = _both(run)
    _close({p: o[0] for p, o in outs.items()})
    scale = float(np.abs(outs[jp][1].numpy()).max())
    _close({p: o[1] for p, o in outs.items()}, rtol=1e-4, atol=1e-4 * scale)
    h = outs[tp][1].numpy()
    np.testing.assert_allclose(h, h.T, atol=1e-6 * scale)


def test_errors_as_in_jax():
    x = np.ones(2, np.float32)
    for p in (jp, tp):
        with pytest.raises(NotImplementedError):
            p.autograd.Hessian(lambda v: v.sum(), p.to_tensor(x), is_batched=True)
        with pytest.raises(NotImplementedError):
            p.autograd.jacobian(lambda v: v * 2, p.to_tensor(x), create_graph=True)
        with pytest.raises(NotImplementedError):
            p.autograd.hessian(lambda v: v.sum(), p.to_tensor(x), create_graph=True)
        with pytest.raises(NotImplementedError):
            p.autograd.Jacobian(lambda v: (v, v), p.to_tensor(x))[:]


def test_exported_from_paddle_autograd():
    names = ["vjp", "jvp", "Jacobian", "Hessian", "jacobian", "hessian"]
    from paddle_tpu_torch.autograd import functional

    for n in names:
        assert getattr(tp.autograd, n) is getattr(functional, n)
        assert n in tp.autograd.__all__
