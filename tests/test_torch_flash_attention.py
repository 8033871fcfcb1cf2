"""The port's flash attention forward against the JAX Pallas kernel.

Inputs are made with numpy from a seed and fed to both packages. On the CPU
the JAX kernel runs in interpret mode and the port runs its plain version
(the CUDA kernel has no CPU mode; tests/test_torch_cuda_kernels.py holds it
against the same plain version on the card). Tolerances are
tests/test_flash_attention.py's: 2e-5 in f32 and 3e-2 in bf16 on the forward,
2e-3 in f32 and 3e-2 in bf16 on the gradients.
"""
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

# the pallas package re-exports the function under the module's name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = {"float32": 2e-3, "bfloat16": 3e-2}  # tests/test_flash_attention.py:48
CASES = [
    ((2, 128, 4, 64), True, "float32"),
    ((1, 128, 2, 32), False, "float32"),
    ((1, 600, 2, 24), True, "float32"),
    ((2, 128, 4, 64), True, "bfloat16"),
]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape,causal,dtype", CASES)
def test_flash_path_matches_pallas_kernel(shape, causal, dtype):
    q, k, v = _inputs(shape)
    ref = jfa.flash_attention(*(_jax(x, dtype) for x in (q, k, v)), causal=causal)
    tflags.set_flags({"FLAGS_use_flash_attention": True})
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    assert tnn.flash_attention_eligible(tq.shape, tk.shape, tv.shape)
    with torch.no_grad():
        out = TF.scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
    assert out.dtype == tq.dtype and tuple(out.shape) == shape
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=TOL[dtype]
    )


@pytest.mark.parametrize("shape,causal,dtype", CASES)
def test_lse_matches_pallas_fwd(shape, causal, dtype):
    b, s, h, d = shape
    q, k, v = _inputs(shape, seed=1)
    scale = 1.0 / np.sqrt(d)

    def to_bh(x):
        return jnp.swapaxes(_jax(x, dtype), 1, 2).reshape(b * h, s, d)

    blk = min(jfa._default_block_q(s), s)
    o_ref, lse_ref = jfa._fwd(to_bh(q), to_bh(k), to_bh(v), np.float32(scale), causal, blk, blk)
    o, lse = tfa.flash_attention_fwd(*(_torch(x, dtype) for x in (q, k, v)), scale, causal)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, s)
    np.testing.assert_allclose(
        lse.reshape(b * h, s).numpy(), np.asarray(lse_ref)[:, 0, :], atol=TOL[dtype]
    )
    o_ref = np.asarray(o_ref, np.float32).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o.float().numpy(), o_ref, atol=TOL[dtype])


def test_supports_is_a_superset_of_jax():
    # every shape tests/test_flash_attention.py runs through the JAX kernel
    for s, d in [(256, 64), (128, 32), (384, 64), (600, 24), (128, 64)]:
        assert jfa.supports(s, d) and tfa.supports(s, d)
    # ragged sequences the JAX kernel refuses are accepted here
    assert not jfa.supports(3000, 24) and tfa.supports(3000, 24)
    for s, d in itertools.product(
        [1, 7, 8, 64, 65, 100, 600, 1024, 1500, 2048, 2560, 3000, 4096, 8192],
        [1, 8, 24, 32, 40, 64, 96, 128, 256, 512],
    ):
        if jfa.supports(s, d):
            assert tfa.supports(s, d), (s, d)


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 64, 2, 32), seed=2))
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, 0.25, True)
    o_p, lse_p = tfa.fwd_plain(q, k, v, 0.25, True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert tfa.flash_attention_fwd.launches == before
    with pytest.raises(RuntimeError, match="no kernel for device"):
        tfa.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"), 0.25, True)
    with pytest.raises(ValueError, match="share one"):
        tfa.flash_attention_fwd(q, k[:, :32], v, 0.25, True)


@pytest.mark.parametrize("shape,causal,dtype", CASES)
def test_backward_matches_pallas_kernel(shape, causal, dtype):
    """The gradients of the port's FlashAttention (plain backward on the CPU)
    against jax.vjp through the Pallas ``_flash`` (interpret mode), for one
    random cotangent."""
    q, k, v = _inputs(shape, seed=3)
    g = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, causal=causal),
                     *(_jax(x, dtype) for x in (q, k, v)))
    ref = vjp(_jax(g, dtype))
    tq, tk, tv = (_torch(x, dtype).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), _torch(g, dtype))
    for got, want in zip(grads, ref):
        assert got.dtype == tq.dtype and tuple(got.shape) == shape
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), atol=GRAD_TOL[dtype], rtol=0
        )


def test_selector_takes_dense_path_for_mask_dropout_and_flag():
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 32, 2, 16), seed=4))
    calls = []
    orig = tfa.flash_attention_fwd

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    tfa.flash_attention_fwd = spy
    try:
        with torch.no_grad():
            TF.scaled_dot_product_attention(q, k, v, is_causal=True)
            assert len(calls) == 1
            TF.scaled_dot_product_attention(q, k, v, attn_mask=torch.zeros(1, 2, 32, 32))
            TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5, training=True)
            tflags.set_flags({"FLAGS_use_flash_attention": False})
            TF.scaled_dot_product_attention(q, k, v, is_causal=True)
    finally:
        tflags.set_flags({"FLAGS_use_flash_attention": True})
        tfa.flash_attention_fwd = orig
    assert len(calls) == 1
