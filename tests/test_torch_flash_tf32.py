"""Why the f32 flash backward on the tensor cores splits every product in three.

The tf32x3 route (``csrc/flash_attention_bwd_tf32.cu``) computes dK, dV and
dQ with ``mma.sync`` on TF32 operands, which the tensor cores read from an
f32 register by dropping its 13 low mantissa bits. A plain-torch emulation of
that arithmetic runs here on the CPU: each operand x is split as the kernel
splits it (big = x read truncated, small = x − trunc(x) read truncated),
every product is small·big + big·small + big·big, and every sum is in f32.

The emulation is held within 2e-5 of ``bwd_plain`` (f32 products) at the
345M head dim 64 and at 128, and within the gradient tolerance of the JAX
Pallas kernel (interpret mode, as tests/test_torch_flash_attention.py runs
it); one truncated TF32 product per product, what the tensor cores give
without the split, misses that tolerance. The card tests
(tests/test_torch_cuda_kernels.py) hold the kernel itself to ``bwd_plain``.
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
