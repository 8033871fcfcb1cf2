"""Flash attention forward: the port of ``paddle_tpu/ops/pallas/flash_attention.py``.

``flash_attention_fwd`` computes O and the row logsumexp of (causal or full)
attention over ``[batch, seq, heads, head_dim]`` inputs. On a CUDA tensor it
launches the hand-written Hopper kernel in ``csrc/flash_attention_fwd.cu``
(built with nvcc at first use, see ``_build``) and counts the launch in
``flash_attention_fwd.launches``; on a CPU tensor it runs ``fwd_plain``,
the plain PyTorch version the kernel is held against. Any other device
raises. There is no fallback from the kernel to the plain version.

The backward kernels (``_bwd_dkv_kernel``, ``_bwd_dq_kernel``) come with the
training slice; until then ``FlashAttention.backward`` raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
KERNEL_NAME = "flash_attention_fwd"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def supports(seq_len: int, head_dim: int) -> bool:
    """Shapes the kernel accepts.

    The kernel masks a ragged tail of both the sequence (64-row query and
    key tiles) and the head dim (32-wide staging chunks, 128-wide output
    slices), so every ``seq_len >= 1`` and ``head_dim >= 1`` is accepted.
    That is a superset of the JAX ``supports()``, which needs an exact
    tiling of the sequence, ``seq_len >= 8`` and ``head_dim % 8 == 0``."""
    return seq_len >= 1 and head_dim >= 1


def fwd_plain(q, k, v, scale: float, causal: bool):
    """Plain PyTorch version: dense scores, then the kernel's softmax.

    Mirrors the kernel's arithmetic: scores in f32, masked to -1e30, p
    rounded to the input type before P·V, ``l == 0`` guarded. Returns
    ``(o [b, s, h, d] in q's dtype, lse [b, h, s] f32)``."""
    qf, kf, vf = (x.transpose(1, 2).float() for x in (q, k, v))  # [b, h, s, d]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = torch.matmul(p.to(q.dtype).float(), vf)
    o = (acc / safe_l).to(q.dtype).transpose(1, 2)
    lse = (m + torch.log(safe_l)).squeeze(-1)
    return o, lse


def _strides(x):
    return [ctypes.c_longlong(s) for s in x.stride()]


def _kernel():
    fn = _build.load(KERNEL_NAME).paddle_flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 16
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
    return fn


def _fwd_cuda(q, k, v, scale: float, causal: bool):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"flash_attention_fwd: dtype {q.dtype} is not supported on CUDA "
            "(float32, bfloat16, float16)"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention_fwd: q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q, k and v must be on one device")
    b, s, h, d = q.shape
    if not supports(s, d):
        raise ValueError(f"flash_attention_fwd: unsupported shape {tuple(q.shape)}")
    fn = _kernel()
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, s, d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            ctypes.c_float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd: kernel launch failed with cudaError_t {err} "
            f"at shape {tuple(q.shape)} {q.dtype}"
        )
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, scale: float, causal: bool):
    """O and lse of attention over ``[b, s, h, d]`` q, k, v of one shape.

    CUDA tensors launch the kernel; CPU tensors run ``fwd_plain``."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            "flash_attention_fwd: q, k, v must share one [b, s, h, d] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.device.type == "cuda":
        return _fwd_cuda(q, k, v, scale, causal)
    if q.device.type == "cpu":
        return fwd_plain(q, k, v, scale, causal)
    raise RuntimeError(f"flash_attention_fwd: no kernel for device {q.device}")


flash_attention_fwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """The autograd shell around the forward; the backward kernels are the
    training slice's work."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, _ = flash_attention_fwd(q, k, v, scale, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "flash attention backward (_bwd_dkv_kernel, _bwd_dq_kernel) is not "
            "ported yet: it comes with the training step; run the forward under "
            "torch.no_grad() or set FLAGS_use_flash_attention=False to train "
            "through the dense path"
        )


def flash_attention(q, k, v, *, scale=None, causal=True):
    """Streaming attention over [batch, seq, heads, head_dim] inputs."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, float(scale), bool(causal))
