"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and nvcc: the kernels have no CPU mode. They
skip elsewhere. This file imports neither jax nor paddle_tpu, so it runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances are tests/test_flash_attention.py's: on O and on lse 2e-5 in f32
and 3e-2 in the 16-bit types; on the gradients 2e-3 in f32 and 3e-2 in the
16-bit types. The backward kernels sum without atomics, so a second backward
on the same input must give bitwise-equal gradients.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2, torch.float16: 3e-2}
GRAD_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2, torch.float16: 3e-2}
BWD_CASES = [
    ((2, 128, 4, 64), True, torch.float32, False),
    ((1, 128, 2, 32), False, torch.float32, False),
    ((1, 600, 2, 24), True, torch.float32, True),
    ((2, 128, 4, 64), True, torch.bfloat16, True),
    ((2, 128, 4, 64), True, torch.float16, False),
    ((8, 1024, 16, 64), True, torch.bfloat16, True),  # the 345M training step's shape
    ((1, 200, 2, 160), True, torch.float32, False),  # two 128-wide output slices
    ((1, 7, 1, 5), True, torch.float32, False),  # shorter than one tile
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _qkv(shape, dtype, fused, seed):
    """q, k, v on the card; ``fused`` makes them strided views of one
    [b, s, h, 3, d] tensor, the layout GPT's qkv projection gives."""
    rng = np.random.default_rng(seed)
    b, s, h, d = shape
    if fused:
        qkv = torch.from_numpy(rng.standard_normal((b, s, h, 3, d)).astype(np.float32))
        return qkv.to(_card(), dtype).unbind(dim=3)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(_card(), dtype)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype,fused", [
    ((2, 128, 4, 64), True, torch.float32, False),
    ((1, 128, 2, 32), False, torch.float32, False),
    ((1, 600, 2, 24), True, torch.float32, True),
    ((2, 128, 4, 64), True, torch.bfloat16, True),
    ((2, 128, 4, 64), True, torch.float16, False),
    ((4, 1024, 16, 64), True, torch.float32, True),
    ((1, 200, 2, 160), True, torch.float32, False),  # two 128-wide output slices
    ((1, 7, 1, 5), True, torch.float32, False),  # shorter than one tile
])
def test_flash_fwd_kernel_matches_plain(shape, causal, dtype, fused):
    q, k, v = _qkv(shape, dtype, fused, seed=0)
    scale = shape[-1] ** -0.5
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, scale, causal)
    o_p, lse_p = tfa.fwd_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and tuple(o.shape) == shape and tuple(lse.shape) == shape[:1] + (
        shape[2], shape[1])
    assert (o.float() - o_p.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_p).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_flash_fwd_kernel_refuses_float64():
    q = torch.zeros(1, 8, 1, 8, dtype=torch.float64, device=_card())
    with pytest.raises(TypeError, match="not supported on CUDA"):
        tfa.flash_attention_fwd(q, q, q, 1.0, True)


@pytest.mark.cuda
def test_gpt_forward_launches_the_kernel_once_per_layer():
    card = _card()
    pt.seed(0)
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                         max_seq_len=64)
    model = tgpt.GPTForPretraining(cfg, device=card).eval()
    ids = torch.randint(0, 128, (2, 48), device=card)
    with torch.no_grad():
        before = tfa.flash_attention_fwd.launches
        flash = model(ids)
        assert tfa.flash_attention_fwd.launches == before + cfg.num_layers
        pt.set_flags({"FLAGS_use_flash_attention": False})
        try:
            dense = model(ids)
        finally:
            pt.set_flags({"FLAGS_use_flash_attention": True})
    assert tfa.flash_attention_fwd.launches == before + cfg.num_layers
    assert (flash - dense).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype,fused", BWD_CASES)
def test_flash_bwd_kernels_match_plain_and_repeat_bitwise(shape, causal, dtype, fused):
    q, k, v = _qkv(shape, dtype, fused, seed=1)
    rng = np.random.default_rng(2)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(_card(), dtype)
    scale = shape[-1] ** -0.5
    o, lse = tfa.flash_attention_fwd(q, k, v, scale, causal)
    delta = tfa.bwd_delta(o, do)
    before = (tfa.flash_attention_bwd_dkv.launches, tfa.flash_attention_bwd_dq.launches)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk2, dv2 = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq2 = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    ref = tfa.bwd_plain(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dkv.launches, tfa.flash_attention_bwd_dq.launches) == (
        before[0] + 2, before[1] + 2)
    for got, again, want in zip((dq, dk, dv), (dq2, dk2, dv2), ref):
        assert got.dtype == dtype and tuple(got.shape) == shape
        assert torch.equal(got, again)
        assert (got.float() - want.float()).abs().max().item() <= GRAD_TOL[dtype]


@pytest.mark.cuda
def test_flash_attention_autograd_runs_the_backward_kernels():
    card = _card()
    q, k, v = (x.detach().requires_grad_() for x in _qkv((1, 96, 2, 32), torch.float32,
                                                             False, seed=3))
    before = (tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd_dkv.launches,
              tfa.flash_attention_bwd_dq.launches)
    out = tfa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad((out * out).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd_dkv.launches,
            tfa.flash_attention_bwd_dq.launches) == tuple(n + 1 for n in before)
    qc, kc, vc = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    out_c = tfa.flash_attention(qc, kc, vc, causal=True)
    ref = torch.autograd.grad((out_c * out_c).sum(), (qc, kc, vc))
    for g, r in zip(grads, ref):
        assert g.device == card
        assert (g.cpu() - r).abs().max().item() <= GRAD_TOL[torch.float32]
