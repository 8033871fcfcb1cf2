"""The port's nn ops against the JAX functions in paddle_tpu/ops/nn_ops.py.

Inputs are made with numpy from a seed and fed to both. Tolerances, all in
f32 on the CPU: 1e-6 for elementwise ops and gathers (the same formula in
the same order; only libm's tanh/rsqrt may differ by an ulp) and 1e-5 for
ops with a matmul or softmax (XLA and torch sum in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu_torch.ops import nn_ops as tnn

ELEMENTWISE = 1e-6
REDUCING = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("with_bias", [True, False])
def test_linear(with_bias):
    r = _rng(0)
    x = r.standard_normal((2, 5, 16)).astype(np.float32)
    w = r.standard_normal((16, 24)).astype(np.float32)  # paddle [in, out]
    b = r.standard_normal((24,)).astype(np.float32) if with_bias else None
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    _close(tnn.linear(torch.from_numpy(x), torch.from_numpy(w), tb),
           jnn.linear(jnp.asarray(x), jnp.asarray(w), jb), REDUCING)


def test_layer_norm():
    r = _rng(1)
    x = (3.0 + 2.0 * r.standard_normal((2, 7, 32))).astype(np.float32)
    w = r.standard_normal((32,)).astype(np.float32)
    b = r.standard_normal((32,)).astype(np.float32)
    _close(tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                          epsilon=1e-5),
           jnn.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), epsilon=1e-5),
           REDUCING)


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu(approximate):
    x = (3.0 * _rng(2).standard_normal((4, 64))).astype(np.float32)
    _close(tnn.gelu(torch.from_numpy(x), approximate=approximate),
           jnn.gelu(jnp.asarray(x), approximate=approximate), ELEMENTWISE)


def test_softmax():
    x = _rng(3).standard_normal((3, 40)).astype(np.float32)
    _close(tnn.softmax(torch.from_numpy(x), axis=-1), jnn.softmax(jnp.asarray(x), axis=-1),
           ELEMENTWISE)


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_embedding(padding_idx):
    r = _rng(4)
    w = r.standard_normal((10, 8)).astype(np.float32)
    ids = r.integers(0, 10, (2, 6))
    ids[0, 0] = 3
    _close(tnn.embedding(torch.from_numpy(ids), torch.from_numpy(w), padding_idx=padding_idx),
           jnn.embedding(jnp.asarray(ids), jnp.asarray(w), padding_idx=padding_idx), 0.0)


@pytest.mark.parametrize("ql,kl", [(16, 16), (4, 12)])
@pytest.mark.parametrize("is_causal", [True, False])
def test_dense_sdpa(ql, kl, is_causal):
    r = _rng(5)
    q = r.standard_normal((2, ql, 3, 8)).astype(np.float32)
    k = r.standard_normal((2, kl, 3, 8)).astype(np.float32)
    v = r.standard_normal((2, kl, 3, 8)).astype(np.float32)
    mask = r.standard_normal((2, 3, ql, kl)).astype(np.float32)
    for m in (None, mask):
        _close(tnn.scaled_dot_product_attention(
                   torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                   None if m is None else torch.from_numpy(m), is_causal=is_causal),
               jnn.scaled_dot_product_attention(
                   jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   None if m is None else jnp.asarray(m), is_causal=is_causal),
               REDUCING)


@pytest.mark.parametrize("cur,s_new", [(0, 5), (5, 1), (9, 3)])
def test_cached_attention(cur, s_new):
    r = _rng(6)
    b, L, h, d = 2, 16, 2, 8
    q = r.standard_normal((b, s_new, h, d)).astype(np.float32)
    kc = r.standard_normal((b, L, h, d)).astype(np.float32)
    vc = r.standard_normal((b, L, h, d)).astype(np.float32)
    kn = r.standard_normal((b, s_new, h, d)).astype(np.float32)
    vn = r.standard_normal((b, s_new, h, d)).astype(np.float32)
    j_out, j_k, j_v = jnn.cached_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(np.int32(cur)), scale=d ** -0.5)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    t_out, t_k, t_v = tnn.cached_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), cur,
        scale=d ** -0.5)
    assert t_k is tk and t_v is tv  # written in place
    _close(t_k, j_k, 0.0)
    _close(t_v, j_v, 0.0)
    _close(t_out, j_out, REDUCING)


def test_cached_attention_casts_output_to_q_dtype():
    r = _rng(7)
    q = torch.from_numpy(r.standard_normal((1, 1, 2, 8)).astype(np.float32)).bfloat16()
    kc = torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16)
    vc = torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16)
    out, _, _ = tnn.cached_attention(q, kc, vc, q, q, 2, scale=0.5)
    assert out.dtype == torch.bfloat16
