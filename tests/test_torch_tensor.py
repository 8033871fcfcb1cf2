"""The port's ``paddle.Tensor``, ``to_tensor``, dtypes and places against the
JAX package's, on the CPU: the cases of ``tests/test_tensor.py`` run through
both packages on the same seeded numpy inputs, and the cell's own surface
(meta, conversion, copies, indexing, in-place rebinding against views).

Tolerances as in ``tests/test_torch_op_sweep.py``: exact for integers, bools
and indices, float32 rtol 1e-5 / atol 1e-6 (XLA:CPU and ATen differ by ulps
in transcendental functions and in the order of sums), float64 1e-12.
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
    """``fn(module)`` for the JAX package and the port, compared output by output."""
    outs = {mod: fn(mod) for mod in (jp, tp)}
    j, t = outs[jp], outs[tp]
    if isinstance(j, (list, tuple)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _same(a, b)
    else:
        _same(j, t)
    return outs


def _same(a, b):
    if isinstance(a, jp.Tensor):
        assert_same(a, b, "output")
    else:
        assert a == b, (a, b)


A = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)


# -- the cases of tests/test_tensor.py -----------------------------------------
def test_to_tensor_roundtrip():
    out = both(lambda p: p.to_tensor([[1.0, 2.0], [3.0, 4.0]]))
    assert out[tp].shape == [2, 2] and out[tp].dtype == tp.float32


@pytest.mark.parametrize("data", [[1, 2], [1.0], np.zeros(3, np.float64), [True], 3, 2.5,
                                  True, np.int32(4), np.float32(1.5), [[1, 2.5]],
                                  np.arange(6, dtype=np.int16).reshape(2, 3)],
                         ids=lambda d: type(d).__name__ + str(np.asarray(d).dtype))
def test_to_tensor_dtype_defaults(data):
    out = both(lambda p: p.to_tensor(data))
    assert out[tp].stop_gradient and out[tp].place == tp.CPUPlace()


def test_to_tensor_keeps_a_tensor_and_copies_numpy():
    a = np.ones(3, np.float32)
    t = tp.to_tensor(a)
    a[0] = 5.0
    assert t.tolist() == [1.0, 1.0, 1.0]
    both(lambda p: p.to_tensor(p.to_tensor(A), dtype="float64", stop_gradient=False))
    src = torch.ones(2)
    t = tp.to_tensor(src)
    src.add_(1.0)
    assert t.tolist() == [1.0, 1.0]


def test_creation_ops():
    both(lambda p: [p.zeros([2, 3]), p.ones([4]), p.full([2], 7.5), p.arange(5),
                    p.linspace(0, 1, 5), p.eye(3)])


def test_binary_math():
    both(lambda p: (lambda x, y: [x + y, x - y, x * y, x / y, p.maximum(x, y), x ** 2,
                                  2.0 - x])(p.to_tensor(A), p.to_tensor(A[::-1].copy())))


def test_matmul():
    b = np.random.default_rng(1).standard_normal((4, 7)).astype(np.float32)
    both(lambda p: [p.matmul(p.to_tensor(A), p.to_tensor(b)),
                    p.matmul(p.to_tensor(A), p.to_tensor(b.T.copy()), transpose_y=True)])


def test_reductions():
    both(lambda p: (lambda x: [x.sum(), x.mean(axis=1), x.max(axis=0, keepdim=True),
                               x.std()])(p.to_tensor(A)))


def test_manipulation():
    a = np.arange(24).reshape(2, 3, 4).astype(np.float32)

    def run(p):
        x = p.to_tensor(a)
        cat = p.concat([x, x], axis=1)
        return [x.reshape([4, 6]), x.reshape([0, -1]), x.transpose([2, 0, 1]),
                p.unsqueeze(x, 0), p.squeeze(p.unsqueeze(x, 0), 0), cat,
                *p.split(cat, 2, axis=1), p.stack([x, x], axis=0), p.flatten(x, 1),
                p.flip(x, [0])]

    out = both(run)
    assert out[tp][1].shape == [2, 12]


def test_split_sections():
    out = both(lambda p: p.split(p.arange(10).astype("float32"), [3, 3, -1], axis=0))
    assert [t.shape[0] for t in out[tp]] == [3, 3, 4]


@pytest.mark.parametrize("index", [
    1, -1, (1, 2), (slice(1, 3), slice(None, None, 2)), (slice(None), -1), [0, 2],
    (Ellipsis, 1), (None, 1), slice(None, None, -1), (slice(3, 0, -2), slice(None, None, -3)),
    (slice(None), [3, 0]),
], ids=repr)
def test_getitem(index):
    a = np.arange(20).reshape(4, 5).astype(np.float32)
    both(lambda p: p.to_tensor(a)[index])


def test_getitem_tensor_and_mask():
    a = np.arange(20).reshape(4, 5).astype(np.float32)
    both(lambda p: (lambda x: [x[p.to_tensor([0, 2])], x[x > 10]])(p.to_tensor(a)))


def test_getitem_out_of_bounds_raises():
    with pytest.raises(IndexError):
        tp.to_tensor(A)[3]
    assert len(list(tp.to_tensor(A))) == 3


@pytest.mark.parametrize("index,value", [
    (1, 5.0), ((0, 0), -1), (slice(None, None, -2), 3.0), ((slice(None), 1), [1.0, 2.0, 3.0]),
], ids=repr)
def test_setitem(index, value):
    def run(p):
        x = p.to_tensor(np.zeros((3, 3), np.float32))
        x[index] = value
        x[2, 2] = p.to_tensor(7.0)
        return x, x._inplace_version

    both(run)


def test_inplace_ops_rebind_and_leave_views():
    def run(p):
        x = p.ones([3])
        y = x
        view = x.reshape([3, 1])
        x.add_(p.ones([3]))
        after_add = y.numpy().tolist()
        x.scale_(scale=0.5)
        return [x, view, p.to_tensor(after_add)]

    out = both(run)
    assert out[tp][1].tolist() == [[1.0], [1.0], [1.0]]


def test_inplace_on_a_reshaped_result_leaves_its_source():
    def run(p):
        x = p.to_tensor(A)
        r = x.reshape([4, 3])
        r.fill_(2.0)
        r[0] = 9.0
        r.zero_()
        s = x.flatten()
        s.set_value(np.ones(12, np.float32))
        return [x, r, s]

    both(run)


def test_cast_astype():
    both(lambda p: (lambda x: [x.astype("int32"), x.astype(p.float64), x.astype("bfloat16"),
                               x.cast("bool")])(p.to_tensor([1.7, -2.3, 0.0])))


def test_comparison_and_logic():
    def run(p):
        x, y = p.to_tensor([1.0, 2.0, 3.0]), p.to_tensor([3.0, 2.0, 1.0])
        return [x == y, x < y, p.logical_and(x > 1, y > 1), p.allclose(x, x)]

    both(run)


def test_search_sort():
    a = np.array([[3.0, 1.0, 2.0], [9.0, 7.0, 8.0]], np.float32)
    both(lambda p: (lambda x: [p.argmax(x, axis=1), p.sort(x, axis=1), *p.topk(x, 2, axis=1)])(
        p.to_tensor(a)))


def test_where_gather_scatter():
    a = np.arange(12).reshape(3, 4).astype(np.float32)

    def run(p):
        x = p.to_tensor(a)
        return [p.where(x > 5, x, p.zeros_like(x)), p.gather(x, p.to_tensor([2, 0]), axis=0),
                p.scatter(x, p.to_tensor([0]), p.to_tensor(np.ones((1, 4), np.float32)))]

    both(run)


def test_item_and_scalar_conversions():
    for mod in (jp, tp):
        x = mod.to_tensor(3.5)
        assert x.item() == pytest.approx(3.5) and float(x) == pytest.approx(3.5)
        assert int(x) == 3 and bool(x) and mod.to_tensor([7]).item() == 7
        assert [0, 1, 2][mod.to_tensor(2)] == 2
        assert mod.to_tensor(A).tolist() == A.tolist()
        assert len(mod.to_tensor(A)) == 3
        with pytest.raises(ValueError):
            bool(mod.to_tensor(A))
        with pytest.raises(TypeError):
            len(mod.to_tensor(1.0))
        assert mod.to_tensor(A).item(1, 2) == pytest.approx(float(A[1, 2]))
        np.testing.assert_array_equal(np.asarray(mod.to_tensor(A)), A)


def test_meta():
    for mod in (jp, tp):
        x = mod.to_tensor(np.zeros((2, 3, 4), np.float32))
        assert x.shape == [2, 3, 4] and x.ndim == 3 and x.dim == 3 and x.size == 24
        assert x.dtype == mod.float32 and x.dtype == "float32" and x.dtype.name == "float32"
        assert x.element_size() == 4 and x.ndimension() == 3 and x.is_leaf
        assert x.place.device_type == "cpu" and x.is_contiguous() and x.contiguous() is x
        assert x.pin_memory() is x and x.T.shape == [4, 3, 2] and x.mT.shape == [2, 4, 3]
        assert int(x.rank) == 3


def test_repr_names_shape_dtype_place_and_stop_gradient():
    text = repr(tp.to_tensor([[1.0, 2.0]], stop_gradient=False))
    assert text.startswith("Tensor(shape=[1, 2], dtype=float32, place=cpu, "
                           "stop_gradient=False,\n")
    jtext = repr(jp.to_tensor([[1.0, 2.0]], stop_gradient=False))
    assert text.split("\n", 1)[1] == jtext.split("\n", 1)[1]


def test_random_reproducible():
    tp.seed(42)
    a = tp.rand([4]).numpy()
    tp.seed(42)
    np.testing.assert_array_equal(tp.rand([4]).numpy(), a)
    c = tp.randn([1000]).numpy()
    assert abs(c.mean()) < 0.2 and abs(c.std() - 1) < 0.2
    r = tp.randint(0, 10, [100]).numpy()
    assert r.min() >= 0 and r.max() < 10


def test_generator():
    # paddle.seed returns the Generator the random ops draw from, in both packages
    for p in (jp, tp):
        g = p.seed(5)
        assert isinstance(g, p.Generator) and g.initial_seed() == 5
        first = p.rand([3]).numpy()
        g.manual_seed(5)
        np.testing.assert_array_equal(p.rand([3]).numpy(), first)
        state = g.get_state()
        a = p.randn([2]).numpy()
        g.set_state(state)
        np.testing.assert_array_equal(p.randn([2]).numpy(), a)
    # the port's is the current device's default Generator, and reseeding it
    # through paddle.seed reaches the ops of nn.functional too
    assert tp.seed(3) is tp.core.random.default_generator("cpu")
    x = tp.ones([64])
    mask = tp.nn.functional.dropout(x, p=0.5).numpy()
    tp.seed(3)
    np.testing.assert_array_equal(tp.nn.functional.dropout(x, p=0.5).numpy(), mask)
    # a Generator of one's own leaves the default one alone
    tp.seed(4)
    before = tp.rand([3]).numpy()
    own = tp.Generator(4)
    torch.rand(3, generator=own.generator)
    tp.seed(4)
    np.testing.assert_array_equal(tp.rand([3]).numpy(), before)
    # a Generator of a card CUDA cannot reach raises when it is drawn from
    if not torch.cuda.is_available():
        card = tp.Generator(0, device="gpu")
        with pytest.raises(RuntimeError):
            card.get_state()


def test_clone_detach():
    def run(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        d = x.detach()
        c = x.clone()
        c.add_(p.ones([1]))
        return [x, d, c]

    out = both(run)
    assert out[tp][1].stop_gradient and not out[tp][2].stop_gradient


def test_detach_inplace():
    for mod in (jp, tp):
        x = mod.to_tensor([1.0], stop_gradient=False)
        y = x * 2
        assert not y.stop_gradient
        y.detach_()
        assert y.stop_gradient and y.is_leaf


def test_default_dtype():
    for mod in (jp, tp):
        mod.set_default_dtype("float64")
        try:
            assert mod.ones([1]).dtype == mod.float64 and mod.to_tensor(1.5).dtype == mod.float64
            assert mod.get_default_dtype() == "float64"
        finally:
            mod.set_default_dtype("float32")
        with pytest.raises(TypeError):
            mod.set_default_dtype("int32")


def test_check_nan_inf_flag():
    for mod in (jp, tp):
        assert "FLAGS_check_nan_inf" in mod.get_flags("FLAGS_check_nan_inf")
        mod.set_flags({"FLAGS_check_nan_inf": True})
        try:
            x = mod.to_tensor([1.0], stop_gradient=False)
            with pytest.raises(FloatingPointError, match="NaN/Inf"):
                (x / mod.zeros([1])).backward()
        finally:
            mod.set_flags({"FLAGS_check_nan_inf": False})


def test_tensor_compat_methods():
    t = tp.ones([2, 3])
    assert t.element_size() == 4 and t.ndimension() == 2
    assert t.cpu().tolist() == t.tolist()
    assert t.to("float64").dtype == tp.float64 and t.to("cpu", "int32").dtype == tp.int32
    assert t.to(dtype=tp.float16).dtype == tp.float16


@pytest.mark.parametrize("name", ["bool", "uint8", "int8", "int16", "int32", "int64",
                                  "float16", "bfloat16", "float32", "float64", "complex64",
                                  "complex128"])
def test_every_dtype(name):
    jd, td = getattr(jp, name), getattr(tp, name)
    assert td.name == jd.name and td == name and td == getattr(torch, name)
    assert np.dtype(tp.to_np_dtype(name)) == np.dtype(jd.np_dtype)
    assert (td.is_floating_point, td.is_complex, td.is_integer) == (
        jd.is_floating_point, jd.is_complex, jd.is_integer)
    both(lambda p: p.zeros([2], dtype=name).astype("float32").astype(name))


def test_bf16_numpy_is_ml_dtypes():
    import ml_dtypes

    x = tp.to_tensor([1.5, 2.25]).astype("bfloat16")
    assert x.numpy().dtype == np.dtype(ml_dtypes.bfloat16)
    assert tp.to_tensor(x.numpy()).dtype == tp.bfloat16
    np.testing.assert_array_equal(tp.to_tensor(x.numpy()).astype("float32").numpy(),
                                  [1.5, 2.25])


def test_places():
    assert tp.CPUPlace() == tp.CPUPlace(0) and tp.CUDAPlace(0) != tp.CPUPlace()
    assert isinstance(tp.CUDAPinnedPlace(), tp.CPUPlace)
    assert tp.device_count() == 1 and tp.is_compiled_with_tpu() is False
    assert tp.is_compiled_with_cuda() == (torch.version.cuda is not None)
    for place in (tp.TPUPlace(0), tp.XPUPlace(0), tp.NPUPlace(0), tp.MLUPlace(0),
                  tp.IPUPlace(0), tp.CustomPlace("npu", 0)):
        with pytest.raises(RuntimeError, match="no"):
            tp.to_tensor([1.0], place=place)
    assert tp.to_tensor([1.0], place=tp.CPUPlace()).place == tp.CPUPlace()


def test_to_tensor_on_the_card_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp.set_device("gpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.zeros([2])


def test_paddle_functions_take_torch_tensors():
    w = torch.ones(4, 2, requires_grad=True)
    x = tp.to_tensor(np.ones((3, 4), np.float32))
    out = tp.matmul(x, w)
    assert isinstance(out, tp.Tensor) and not out.stop_gradient
    out.sum().backward()
    assert w.grad.tolist() == [[3.0, 3.0]] * 4
    assert tp.add(torch.ones(2), torch.ones(2)).stop_gradient
