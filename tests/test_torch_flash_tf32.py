"""Why the f32 flash kernels on the tensor cores split every product in three.

The tf32x3 route (``csrc/flash_attention_fwd_tf32.cu`` for O and lse,
``csrc/flash_attention_bwd_tf32.cu`` for dK, dV and dQ) computes with
``mma.sync`` on TF32 operands, which the tensor cores read from an f32
register by dropping its 13 low mantissa bits. A plain-torch emulation of
that arithmetic runs here on the CPU: each operand x is split as the kernels
split it (big = x read truncated, small = x − trunc(x) read truncated),
every product is small·big + big·small + big·big, and every sum is in f32.
The forward's emulation also takes the kernel's order: 32-key tiles, a
running max, alpha rescales of l and the accumulator, one division at the
end.

The backward's emulation is held within 2e-5 of ``bwd_plain`` (f32
products) at the 345M head dim 64 and at 128, and within the gradient
tolerance of the JAX Pallas kernel (interpret mode, as
tests/test_torch_flash_attention.py runs it); one truncated TF32 product per
product, what the tensor cores give without the split, misses that
tolerance. The forward's emulation is held within the forward tolerance
(2e-5) of ``fwd_plain`` and of the Pallas forward, on O and on lse, and one
TF32 product per product misses it. The card tests
(tests/test_torch_cuda_kernels.py) hold the kernels themselves to
``fwd_plain`` and ``bwd_plain``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

# 3xTF32 against f32 products: each split operand is exact to ~2^-20
# relative, so gradients of size ~5 summed over 1024 keys move by a few 1e-6
# (measured 2e-6 to 6e-6 here); 2e-5 leaves a margin, and one TF32 product
# per product misses it by far (6e-3 to 9e-3 here).
TOL_EMULATION = 2e-5
GRAD_TOL = 2e-3  # tests/test_flash_attention.py:48, f32 gradients
# tests/test_flash_attention.py's f32 forward tolerance, on O and lse: the
# forward's emulation is within 1e-6 to 2e-6 of fwd_plain here, one TF32
# product per product 1.5e-3 to 2.6e-3 off
FWD_TOL = 2e-5
KEY_TILE = 32  # keys per streamed tile of the forward kernel
_LOW_BITS = ~0x1FFF  # the 13 mantissa bits the tensor cores drop


def _tf32(x):
    """x as the tensor cores read it: its 13 low mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & _LOW_BITS).view(torch.float32)


def _matmul_3xtf32(a, b):
    """a @ b as the kernel computes it: small·big + big·small + big·big."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _matmul_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _bwd_emulated(q, k, v, do, lse, delta, scale, causal, matmul):
    """``bwd_plain``'s arithmetic, every product through ``matmul``."""
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    s = matmul(qh, kh.transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), tfa.NEG_INF)
    p = torch.exp(s - lse.unsqueeze(-1))
    dv = matmul(p.transpose(-1, -2), doh)
    dp = matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    dk = matmul(ds.transpose(-1, -2), qh)
    dq = matmul(ds, kh)
    return [x.transpose(1, 2) for x in (dq, dk, dv)]


def _inputs(shape, seed):
    """q, k, v, dO from a numpy seed, and lse and delta from the forward."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = tfa.fwd_plain(q, k, v, scale, True)
    return q, k, v, do, lse, tfa.bwd_delta(o, do), scale


def _max_errs(got, want):
    return [(a - b).abs().max().item() for a, b in zip(got, want)]


@pytest.mark.parametrize("shape", [(1, 1024, 2, 64), (1, 1024, 2, 128)])
def test_3xtf32_matches_the_f32_plain_backward(shape):
    q, k, v, do, lse, delta, scale = _inputs(shape, seed=0)
    want = tfa.bwd_plain(q, k, v, do, lse, delta, scale, True)
    got = _bwd_emulated(q, k, v, do, lse, delta, scale, True, _matmul_3xtf32)
    assert max(_max_errs(got, want)) <= TOL_EMULATION


@pytest.mark.parametrize("shape", [(1, 1024, 4, 64), (1, 1024, 2, 128)])
def test_one_tf32_product_misses_the_gradient_tolerance(shape):
    q, k, v, do, lse, delta, scale = _inputs(shape, seed=0)
    want = tfa.bwd_plain(q, k, v, do, lse, delta, scale, True)
    one = _bwd_emulated(q, k, v, do, lse, delta, scale, True, _matmul_1xtf32)
    three = _bwd_emulated(q, k, v, do, lse, delta, scale, True, _matmul_3xtf32)
    assert max(_max_errs(one, want)) > GRAD_TOL
    assert max(_max_errs(three, want)) < GRAD_TOL / 100


def test_the_split_is_exact_in_f32():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    big = _tf32(x)
    small = x - big
    assert torch.equal(big + small, x)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    # what the small half loses when read truncated: under 2^-20 of x
    assert ((small - _tf32(small)).abs() <= x.abs() * 2.0 ** -20).all()


@pytest.mark.parametrize("shape,causal", [((1, 128, 2, 32), True), ((2, 64, 2, 64), False)])
def test_3xtf32_matches_the_pallas_gradient(shape, causal):
    """The emulation against jax.vjp through the Pallas ``_flash`` in
    interpret mode, for one random cotangent."""
    rng = np.random.default_rng(2)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, causal=causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    scale = shape[-1] ** -0.5
    o, lse = tfa.fwd_plain(tq, tk, tv, scale, causal)
    got = _bwd_emulated(tq, tk, tv, tg, lse, tfa.bwd_delta(o, tg), scale, causal,
                        _matmul_3xtf32)
    for a, want in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=GRAD_TOL, rtol=0)


def _fwd_emulated(q, k, v, scale, causal, matmul):
    """The tf32x3 forward's arithmetic: KEY_TILE-key tiles in order, a running
    max, alpha rescales of l and the accumulator, one division at the end,
    every product through ``matmul``. Returns ``(o [b, s, h, d], lse [b, h, s])``."""
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # [b, h, s, d]
    n = qh.shape[2]
    rows = torch.arange(n).unsqueeze(-1)
    m = torch.full(qh.shape[:3] + (1,), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(qh.shape)
    for k0 in range(0, n, KEY_TILE):
        kt, vt = kh[:, :, k0:k0 + KEY_TILE], vh[:, :, k0:k0 + KEY_TILE]
        s = matmul(qh, kt.transpose(-1, -2)) * scale
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kt.shape[2]) > rows, tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + matmul(p, vt)
        m = m_new
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe_l).transpose(1, 2), (m + torch.log(safe_l)).squeeze(-1)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(3)]


def _fwd_errs(got, want):
    """max |d O| and max |d lse|."""
    return [(a - b).abs().max().item() for a, b in zip(got, want)]


@pytest.mark.parametrize("shape,causal", [
    ((1, 1024, 2, 64), True),  # the 345M head dim
    ((1, 1024, 2, 128), True),
    ((1, 600, 2, 24), False),  # ragged S: a last tile of 24 keys
])
def test_3xtf32_forward_matches_the_f32_plain_forward(shape, causal):
    q, k, v = _qkv(shape, seed=3)
    scale = shape[-1] ** -0.5
    want = tfa.fwd_plain(q, k, v, scale, causal)
    got = _fwd_emulated(q, k, v, scale, causal, _matmul_3xtf32)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert max(_fwd_errs(got, want)) <= FWD_TOL


@pytest.mark.parametrize("shape", [(1, 1024, 4, 64), (1, 1024, 2, 128)])
def test_one_tf32_product_misses_the_forward_tolerance(shape):
    q, k, v = _qkv(shape, seed=3)
    scale = shape[-1] ** -0.5
    want = tfa.fwd_plain(q, k, v, scale, True)
    one = _fwd_emulated(q, k, v, scale, True, _matmul_1xtf32)
    three = _fwd_emulated(q, k, v, scale, True, _matmul_3xtf32)
    assert max(_fwd_errs(one, want)) > 10 * FWD_TOL
    assert max(_fwd_errs(three, want)) < FWD_TOL / 2


@pytest.mark.parametrize("shape,causal", [((1, 128, 2, 32), True), ((2, 64, 2, 64), False)])
def test_3xtf32_forward_matches_the_pallas_forward(shape, causal):
    """O and lse of the emulation against the Pallas ``_fwd`` in interpret
    mode, with one block over the whole sequence."""
    b, s, h, d = shape
    q, k, v = _qkv(shape, seed=4)
    scale = d ** -0.5

    def to_bh(x):
        return jnp.swapaxes(jnp.asarray(x.numpy()), 1, 2).reshape(b * h, s, d)

    o_ref, lse_ref = jfa._fwd(to_bh(q), to_bh(k), to_bh(v), np.float32(scale), causal, s, s)
    o, lse = _fwd_emulated(q, k, v, scale, causal, _matmul_3xtf32)
    np.testing.assert_allclose(o.transpose(1, 2).reshape(b * h, s, d).numpy(),
                               np.asarray(o_ref), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(lse.reshape(b * h, s).numpy(), np.asarray(lse_ref)[:, 0, :],
                               atol=FWD_TOL, rtol=0)
