"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and nvcc: the kernels have no CPU mode. They
skip elsewhere. This file imports neither jax nor paddle_tpu, so it runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances are tests/test_flash_attention.py's: 2e-5 in f32, 3e-2 in the
16-bit types, on O and on lse.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2, torch.float16: 3e-2}


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
