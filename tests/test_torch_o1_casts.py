"""AMP O1 casts of the ``paddle.*`` tensor functions, against the JAX package,
on the CPU: inside ``auto_cast(level="O1", dtype=...)`` every ``apply``
casts its inputs by the op's name (``amp.maybe_cast_inputs``), so the
white-listed products (``matmul``, ``x @ w``, ``mm``, ``bmm``, ``einsum``)
on float32 inputs give the low dtype and the black-listed ops (``exp``,
``log``, ``mean``, ``sum``, ``Tensor.sum``, ``pow``, ``cumsum``, ``square``,
``norm``) on low-precision inputs give float32, as
``tests/test_amp.py:10-17`` holds the JAX package; outside the block
nothing is cast; and lazy dispatch falls back under AMP (``fallback_amp``)
so the cast runs on the per-op path.

Tolerance: the dtypes must be equal; values within 3e-2 relative in
bfloat16 / float16 (``tests/test_flash_attention.py``'s low-precision
bound: a product of low-precision operands summed in another order) and
1e-5 for the float32 results of low-precision inputs (the same inputs,
summed in another order).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import lazy

LOW_RTOL, F32_RTOL = 3e-2, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((4, 8)).astype(np.float32),
        "w": rng.standard_normal((8, 4)).astype(np.float32),
        "bx": rng.standard_normal((2, 4, 8)).astype(np.float32),
        "bw": rng.standard_normal((2, 8, 3)).astype(np.float32),
        "pos": (rng.random((4, 8)) + 0.5).astype(np.float32),
    }


PRODUCTS = {
    "matmul": lambda p, t: p.matmul(t["x"], t["w"]),
    "at": lambda p, t: t["x"] @ t["w"],
    "mm": lambda p, t: p.mm(t["x"], t["w"]),
    "bmm": lambda p, t: p.bmm(t["bx"], t["bw"]),
    "einsum": lambda p, t: p.einsum("ij,jk->ik", t["x"], t["w"]),
}

REDUCTIONS = {
    "exp": lambda p, t: p.exp(t["x"]),
    "log": lambda p, t: p.log(t["pos"]),
    "mean": lambda p, t: p.mean(t["x"], axis=1),
    "sum": lambda p, t: p.sum(t["x"]),
    "Tensor.sum": lambda p, t: t["x"].sum(axis=0),
    "pow": lambda p, t: p.pow(t["pos"], 2.0),
    "cumsum": lambda p, t: p.cumsum(t["x"], axis=1),
    "square": lambda p, t: p.square(t["x"]),
    "norm": lambda p, t: p.norm(t["x"]),
}


def _run(p, fn, dtype, cast_inputs_to, amp=True):
    t = {k: p.to_tensor(v).astype(cast_inputs_to) for k, v in _inputs().items()}
    if not amp:
        return fn(p, t)
    with p.amp.auto_cast(level="O1", dtype=dtype):
        return fn(p, t)


def _name(dtype):
    return str(dtype).rsplit(".", 1)[-1]


def _same(j, t, rtol):
    assert _name(t.dtype) == _name(j.dtype), (t.dtype, j.dtype)
    np.testing.assert_allclose(np.asarray(t.astype("float32").numpy()),
                               np.asarray(j.astype("float32").numpy()), rtol=rtol, atol=rtol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", list(PRODUCTS))
def test_o1_white_list_products_give_the_low_dtype(name, dtype):
    j = _run(jp, PRODUCTS[name], dtype, "float32")
    t = _run(tp, PRODUCTS[name], dtype, "float32")
    assert t.dtype == getattr(tp, dtype)
    _same(j, t, LOW_RTOL)


@pytest.mark.parametrize("name", list(REDUCTIONS))
def test_o1_black_list_ops_give_float32(name):
    j = _run(jp, REDUCTIONS[name], "bfloat16", "bfloat16")
    t = _run(tp, REDUCTIONS[name], "bfloat16", "bfloat16")
    assert t.dtype == tp.float32
    _same(j, t, F32_RTOL)


@pytest.mark.parametrize("name", ["matmul", "at", "einsum"])
def test_no_cast_outside_the_block_or_at_o2(name):
    t = _run(tp, PRODUCTS[name], "bfloat16", "float32", amp=False)
    assert t.dtype == tp.float32
    for p in (jp, tp):
        ins = {k: p.to_tensor(v) for k, v in _inputs().items()}
        with p.amp.auto_cast(level="O2", dtype="bfloat16"):
            out = PRODUCTS[name](p, ins)
        # O2 casts parameters (decorate), not the operands of each op
        assert _name(out.dtype) == _name(t.dtype)


def test_the_reference_case_and_custom_lists():
    """``tests/test_amp.py::test_o1_casts_matmul_to_bf16`` on both packages,
    then ``custom_black_list`` keeping a product in float32."""
    for p in (jp, tp):
        x, w = p.randn([4, 8]), p.randn([8, 4])
        with p.amp.auto_cast(level="O1", dtype="bfloat16"):
            assert p.matmul(x, w).dtype == p.bfloat16
        assert p.matmul(x, w).dtype == p.float32
        with p.amp.auto_cast(level="O1", dtype="bfloat16", custom_black_list={"matmul"}):
            assert p.matmul(x, w).dtype == p.float32
        with p.amp.auto_cast(level="O1", dtype="bfloat16", custom_white_list={"tanh"}):
            assert p.tanh(x).dtype == p.bfloat16


def test_o1_gradients_flow_through_the_casts():
    grads = {}
    for p in (jp, tp):
        ins = _inputs(1)
        x = p.to_tensor(ins["x"], stop_gradient=False)
        w = p.to_tensor(ins["w"], stop_gradient=False)
        with p.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = p.sum(p.exp(p.matmul(x, w)))
        assert loss.dtype == p.float32
        loss.backward()
        assert x.grad.dtype == p.float32 and w.grad.dtype == p.float32
        grads[p] = (x.grad.numpy(), w.grad.numpy())
    for a, b in zip(grads[jp], grads[tp]):
        np.testing.assert_allclose(b, a, rtol=LOW_RTOL, atol=LOW_RTOL * np.abs(a).max())


def test_lazy_dispatch_falls_back_under_amp_and_casts_per_op():
    flags = tp.get_flags(["FLAGS_eager_lazy_dispatch", "FLAGS_eager_step_capture"])
    tp.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_step_capture": False})
    try:
        lazy.reset_lazy_state()
        tp.profiler.reset_dispatch_counters()
        ins = _inputs(2)
        x, w = tp.to_tensor(ins["x"]), tp.to_tensor(ins["w"])
        pending = x * 2.0  # deferred onto a segment
        assert lazy.pending_op_count() == 1
        with tp.amp.auto_cast(level="O1", dtype="bfloat16"):
            out = tp.matmul(pending, w)
        assert lazy.pending_op_count() == 0
        c = tp.profiler.dispatch_counters()
        assert c["flush_reasons"].get("fallback_amp", 0) == 1, dict(c["flush_reasons"])
        assert out.dtype == tp.bfloat16
        want = jp.matmul((jp.to_tensor(ins["x"]) * 2.0).astype("bfloat16"),
                         jp.to_tensor(ins["w"]).astype("bfloat16"))
        _same(want, out, LOW_RTOL)
    finally:
        tp.set_flags(flags)
        lazy.reset_lazy_state()
