"""Flash attention, forward and backward: the port of ``paddle_tpu/ops/pallas/flash_attention.py``.

Three kernels over ``[batch, seq, heads, head_dim]`` inputs, each behind a
wrapper that launches the hand-written Hopper kernel on a CUDA tensor (built
with nvcc at first use, see ``_build``) and counts the launch in its
``launches``, and runs the plain PyTorch version the kernel is held against
on a CPU tensor. Any other device raises. There is no fallback from a kernel
to its plain version. A FakeTensor (lazy dispatch's output-spec inference,
``core/lazy.py``) gets empty outputs of the right specs and launches
nothing.

  - ``flash_attention_fwd``: O and the row logsumexp; plain version
    ``fwd_plain``.
  - ``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq``: dK, dV and dQ
    from the saved lse and ``delta = rowsum(dO∘O)``; plain version
    ``bwd_plain``.

The kernels are picked per launch from the tensors alone, before anything
is built, by ``sm90_eligible`` and ``tf32x3_eligible`` (``_fwd_route`` and
``_bwd_route``):

  - route ``"sm90"`` (``csrc/flash_attention_fwd_sm90.cu``,
    ``csrc/flash_attention_bwd_dkv_sm90.cu``,
    ``csrc/flash_attention_bwd_dq_sm90.cu``): the tensor cores through
    ``wgmma``, fed by TMA, for bf16 and fp16 inputs that TMA can read;
  - route ``"tf32x3"`` (``csrc/flash_attention_fwd_tf32.cu``, O and lse;
    ``csrc/flash_attention_bwd_tf32.cu``, dK/dV and dQ; both over
    ``csrc/tf32x3.cuh``): the tensor cores through ``mma.sync`` in 3xTF32,
    as accurate as f32, fed by TMA, for f32 inputs that TMA can read;
  - route ``"simt"`` (``csrc/flash_attention_fwd.cu``,
    ``csrc/flash_attention_bwd.cu``): f32 FMAs on the CUDA cores, for every
    other input the kernels accept (a head dim the tensor-core routes have no
    tile for, odd strides or alignment, a stride-0 input).

The forward decides on ``(q, k, v)`` and the backward on ``(q, k, v, dO)``,
so dkv and dq of one call take one route, and GPT's fused-qkv views take
the tensor-core route of their type forward and backward. Each wrapper
counts its launches in ``launches`` and in ``launches_by_route``;
``_fwd_cuda``, ``_bwd_dkv_cuda`` and ``_bwd_dq_cuda`` take the route as an
argument, to launch one by name. A launch that fails raises, whatever its
route: no route falls back to another.

``FlashAttention`` is the autograd function over them, the port of the
``_flash`` custom_vjp: the forward saves ``(q, k, v, o, lse)``; the backward
computes delta in f32 with torch ops (the JAX package computes it outside any
Pallas kernel too), then launches the dkv kernel and the dq kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...analysis import kernel_region
from . import _build

NEG_INF = -1e30
KERNEL_NAME = "flash_attention_fwd"
BWD_KERNEL_NAME = "flash_attention_bwd"
SM90_FWD_KERNEL_NAME = "flash_attention_fwd_sm90"
SM90_DKV_KERNEL_NAME = "flash_attention_bwd_dkv_sm90"
SM90_DQ_KERNEL_NAME = "flash_attention_bwd_dq_sm90"
TF32_FWD_KERNEL_NAME = "flash_attention_fwd_tf32"
TF32_BWD_KERNEL_NAME = "flash_attention_bwd_tf32"
ROUTES = ("sm90", "tf32x3", "simt")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def supports(seq_len: int, head_dim: int) -> bool:
    """Shapes the kernels accept, forward and backward alike.

    The kernels mask a ragged tail of both the sequence (64-row query and
    key tiles) and the head dim (32-wide staging chunks, 128-wide output
    slices), so every ``seq_len >= 1`` and ``head_dim >= 1`` is accepted.
    That is a superset of the JAX ``supports()``, which needs an exact
    tiling of the sequence, ``seq_len >= 8`` and ``head_dim % 8 == 0``."""
    return seq_len >= 1 and head_dim >= 1


def _tma_tiles(tensors, dtypes, d_step) -> bool:
    """Whether ``[b, s, h, d]`` tensors of one dtype among ``dtypes`` have a
    head dim that is a multiple of ``d_step`` in [d_step, 128], and what TMA
    reads: head-dim stride 1, every other stride a positive multiple of 16
    bytes, every base pointer 16-byte aligned. The stride of a size-1 dim is
    never read, so it is not checked."""
    dtype = tensors[0].dtype
    if dtype not in dtypes:
        return False
    stride_step = 16 // dtype.itemsize
    for t in tensors:
        if t.dtype != dtype or t.dim() != 4:
            return False
        d = t.shape[-1]
        if d % d_step or not d_step <= d <= 128 or t.stride(-1) != 1 or t.data_ptr() % 16:
            return False
        if any(n > 1 and (st <= 0 or st % stride_step)
               for n, st in zip(t.shape[:3], t.stride()[:3])):
            return False
    return True


def sm90_eligible(tensors) -> bool:
    """Whether the sm90 (wgmma + TMA) kernels take these ``[b, s, h, d]``
    inputs (q, k, v, and dO for dkv and dq).

    They need bf16 or fp16, one dtype for all; a head dim that is a multiple
    of 16 in [16, 128]; and TMA's strides (multiples of 8 elements) and
    alignment. The fused-qkv views of ``models/gpt.py`` qualify. Pure Python
    on the tensors' metadata: it neither builds nor launches anything."""
    return _tma_tiles(tensors, (torch.bfloat16, torch.float16), 16)


def tf32x3_eligible(tensors) -> bool:
    """Whether the 3xTF32 kernels take these ``[b, s, h, d]`` inputs (q, k,
    v, and dO for dkv and dq); the SIMT kernels take what neither this nor
    ``sm90_eligible`` takes.

    They need f32 for all; a head dim that is a multiple of 8 in [8, 128];
    and TMA's strides (multiples of 4 elements) and alignment. The f32
    fused-qkv views of ``models/gpt.py`` qualify. Pure Python on the
    tensors' metadata."""
    return _tma_tiles(tensors, (torch.float32,), 8)


def _route(tensors) -> str:
    if sm90_eligible(tensors):
        return "sm90"
    return "tf32x3" if tf32x3_eligible(tensors) else "simt"


def _fwd_route(tensors) -> str:
    """The forward's route for ``(q, k, v)``."""
    return _route(tensors)


def _bwd_route(tensors) -> str:
    """The route of both backward kernels for ``(q, k, v, dO)``."""
    return _route(tensors)


def _scores(q, k, scale: float, causal: bool):
    """``[b, h, s, s]`` f32 scores, scaled, the causal mask filled with -1e30."""
    s = torch.matmul(q.transpose(1, 2).float(), k.transpose(1, 2).float().transpose(-1, -2))
    s = s * scale
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def fwd_plain(q, k, v, scale: float, causal: bool):
    """Plain PyTorch version: dense scores, then the kernel's softmax.

    Mirrors the kernel's arithmetic: scores in f32, masked to -1e30, p
    rounded to the input type before P·V, ``l == 0`` guarded. Returns
    ``(o [b, s, h, d] in q's dtype, lse [b, h, s] f32)``."""
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = torch.matmul(p.to(q.dtype).float(), v.transpose(1, 2).float())
    o = (acc / safe_l).to(q.dtype).transpose(1, 2)
    lse = (m + torch.log(safe_l)).squeeze(-1)
    return o, lse


def bwd_delta(o, do):
    """``delta = rowsum(dO∘O)`` in f32, ``[b, h, s]`` contiguous (``_bwd``:240)."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def bwd_plain(q, k, v, do, lse, delta, scale: float, causal: bool):
    """Plain PyTorch version of both backward kernels: dense scores
    recomputed from lse, with the kernels' roundings.

    p = exp(s − lse) in f32, rounded to dO's type before pᵀ·dO;
    dS = p∘(dP − delta)·scale, rounded to q's (k's) type before dSᵀ·Q (dS·K);
    every product summed in f32. Returns ``(dq, dk, dv)``, ``[b, s, h, d]``
    in q's, k's and v's dtypes."""
    p = torch.exp(_scores(q, k, scale, causal) - lse.unsqueeze(-1))  # [b, h, sq, sk]
    dof = do.transpose(1, 2).float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.transpose(1, 2).float().transpose(-1, -2))
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.transpose(1, 2).float())
    dq = torch.matmul(ds.to(k.dtype).float(), k.transpose(1, 2).float())
    return (dq.to(q.dtype).transpose(1, 2), dk.to(k.dtype).transpose(1, 2),
            dv.to(v.dtype).transpose(1, 2))


def _strides(x):
    return [ctypes.c_longlong(s) for s in x.stride()]


def _bind(lib_name: str, symbol: str, n_ptr: int, n_strided: int):
    """The C entry ``symbol`` of ``csrc/<lib_name>.cu`` with its argtypes set:
    ``n_ptr`` pointers, dtype, B, H, S, D, four strides for each of
    ``n_strided`` tensors, scale, causal, stream."""
    fn = getattr(_build.load(lib_name), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * (4 * n_strided)
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
    return fn


def _check_inputs(name, tensors):
    """One dtype the kernels take, one device, one [b, s, h, d] shape."""
    q = tensors[0]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"{name}: dtype {q.dtype} is not supported on CUDA (float32, bfloat16, float16)"
        )
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: q, k, v (and dO) must share one dtype")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device")
    b, s, h, d = q.shape
    if not supports(s, d):
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)}")


# What an sm90 C entry adds to the CUresult of a tensor map the driver
# refused (sm90::ENCODE_ERROR_BASE in csrc/sm90_common.cuh)
_ENCODE_ERROR_BASE = 100000


def _check_launch(name, err, q):
    if err >= _ENCODE_ERROR_BASE:
        raise RuntimeError(
            f"{name}: cuTensorMapEncodeTiled refused a TMA map (CUresult "
            f"{err - _ENCODE_ERROR_BASE}) at shape {tuple(q.shape)} {q.dtype}"
        )
    if err != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with cudaError_t {err} "
            f"at shape {tuple(q.shape)} {q.dtype}"
        )


def _check_shapes(name, tensors):
    q = tensors[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(
            f"{name}: q, k, v (and dO) must share one [b, s, h, d] shape, got "
            + ", ".join(str(tuple(t.shape)) for t in tensors)
        )


def _row_stats(name, lse, delta, q):
    b, s, h, _ = q.shape
    for t, what in ((lse, "lse"), (delta, "delta")):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, s)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name}: {what} must be a contiguous float32 [b, h, s] = "
                f"{(b, h, s)} tensor on {q.device}"
            )


# The C entry of each kernel by route: (source name, symbol).
_FWD_ENTRIES = {
    "sm90": (SM90_FWD_KERNEL_NAME, "paddle_flash_attention_fwd_sm90"),
    "tf32x3": (TF32_FWD_KERNEL_NAME, "paddle_flash_attention_fwd_tf32"),
    "simt": (KERNEL_NAME, "paddle_flash_attention_fwd"),
}
_DKV_ENTRIES = {
    "sm90": (SM90_DKV_KERNEL_NAME, "paddle_flash_attention_bwd_dkv_sm90"),
    "tf32x3": (TF32_BWD_KERNEL_NAME, "paddle_flash_attention_bwd_dkv_tf32"),
    "simt": (BWD_KERNEL_NAME, "paddle_flash_attention_bwd_dkv"),
}
_DQ_ENTRIES = {
    "sm90": (SM90_DQ_KERNEL_NAME, "paddle_flash_attention_bwd_dq_sm90"),
    "tf32x3": (TF32_BWD_KERNEL_NAME, "paddle_flash_attention_bwd_dq_tf32"),
    "simt": (BWD_KERNEL_NAME, "paddle_flash_attention_bwd_dq"),
}


def _entry(name, entries, route, n_ptr, n_strided):
    if route not in entries:
        raise ValueError(f"{name}: no kernel on route {route!r} (routes: {sorted(entries)})")
    return _bind(*entries[route], n_ptr, n_strided)


def _fwd_cuda(q, k, v, scale: float, causal: bool, route: str):
    _check_inputs("flash_attention_fwd", (q, k, v))
    b, s, h, d = q.shape
    fn = _entry("flash_attention_fwd", _FWD_ENTRIES, route, 5, 4)
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
    _check_launch("flash_attention_fwd", err, q)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[route] += 1
    return o, lse


def attention_flops(q, causal: bool, matmuls: int) -> int:
    """FLOPs of ``matmuls`` (s x s x d) products per head, the work of one
    flash kernel: the forward does 2 (S = QK^T, PV), dK/dV 4 (S, dV, dP,
    dK), dQ 3 (S, dP, dQ); a causal mask skips the blocks above the
    diagonal, so it needs (s + 1) / 2s of it. This is what the analysis IR
    charges a kernel launch (a ``ctypes`` launch is invisible to its
    recorder)."""
    b, s, h, d = q.shape
    full = 2 * matmuls * b * h * s * s * d
    return int(full * (s + 1) / (2 * s)) if causal else full


def _fake(t) -> bool:
    """A FakeTensor: lazy dispatch infers a deferred call's output specs by
    running it on fake tensors (``core/lazy.py``); a wrapper then gives
    outputs of the right specs and launches nothing."""
    return type(t).__name__ == "FakeTensor"


def flash_attention_fwd(q, k, v, scale: float, causal: bool):
    """O and lse of attention over ``[b, s, h, d]`` q, k, v of one shape.

    CUDA tensors launch the kernel of their route; CPU tensors run ``fwd_plain``;
    fake tensors (output-spec inference) give empty outputs."""
    _check_shapes("flash_attention_fwd", (q, k, v))
    if _fake(q):
        b, s, h, _ = q.shape
        return torch.empty_like(q), torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"flash_attention_fwd: no kernel for device {q.device}")
    with kernel_region() as region:
        if q.device.type == "cuda":
            out = _fwd_cuda(q, k, v, scale, causal, _fwd_route((q, k, v)))
        else:
            out = fwd_plain(q, k, v, scale, causal)
    region.note("flash_attention_fwd", (q, k, v), out, attention_flops(q, causal, 2))
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def _bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float, causal: bool, route: str):
    name = "flash_attention_bwd_dkv"
    _check_inputs(name, (q, k, v, do))
    _row_stats(name, lse, delta, q)
    b, s, h, d = q.shape
    fn = _entry(name, _DKV_ENTRIES, route, 8, 6)
    dk = torch.empty((b, s, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, s, h, d), dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], b, h, s, d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do), *_strides(dk),
            *_strides(dv), ctypes.c_float(scale), int(bool(causal)), stream,
        )
    _check_launch(name, err, q)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.launches_by_route[route] += 1
    return dk, dv


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool):
    """dK and dV of attention over ``[b, s, h, d]`` q, k, v, dO of one shape,
    from the forward's lse and ``bwd_delta``, both ``[b, h, s]`` f32.

    CUDA tensors launch the kernel of their route; CPU tensors run ``bwd_plain``."""
    _check_shapes("flash_attention_bwd_dkv", (q, k, v, do))
    if _fake(q):
        return torch.empty_like(k), torch.empty_like(v)
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"flash_attention_bwd_dkv: no kernel for device {q.device}")
    with kernel_region() as region:
        if q.device.type == "cuda":
            out = _bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal,
                                _bwd_route((q, k, v, do)))
        else:
            out = bwd_plain(q, k, v, do, lse, delta, scale, causal)[1:]
    region.note("flash_attention_bwd_dkv", (q, k, v, do, lse, delta), out,
                attention_flops(q, causal, 4))
    return out


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_by_route = dict.fromkeys(ROUTES, 0)


def _bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, causal: bool, route: str):
    name = "flash_attention_bwd_dq"
    _check_inputs(name, (q, k, v, do))
    _row_stats(name, lse, delta, q)
    b, s, h, d = q.shape
    fn = _entry(name, _DQ_ENTRIES, route, 7, 5)
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _DTYPE_CODE[q.dtype], b, h, s, d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do), *_strides(dq),
            ctypes.c_float(scale), int(bool(causal)), stream,
        )
    _check_launch(name, err, q)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.launches_by_route[route] += 1
    return dq


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool):
    """dQ of attention, with the inputs of ``flash_attention_bwd_dkv``.

    CUDA tensors launch the kernel of their route, which is dkv's for the
    same inputs; CPU tensors run ``bwd_plain``."""
    _check_shapes("flash_attention_bwd_dq", (q, k, v, do))
    if _fake(q):
        return torch.empty_like(q)
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"flash_attention_bwd_dq: no kernel for device {q.device}")
    with kernel_region() as region:
        if q.device.type == "cuda":
            out = _bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal,
                               _bwd_route((q, k, v, do)))
        else:
            out = bwd_plain(q, k, v, do, lse, delta, scale, causal)[0]
    region.note("flash_attention_bwd_dq", (q, k, v, do, lse, delta), out,
                attention_flops(q, causal, 3))
    return out


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_by_route = dict.fromkeys(ROUTES, 0)


class FlashAttention(torch.autograd.Function):
    """The ``_flash`` custom_vjp: the forward kernel, then delta and the two
    backward kernels. On CPU tensors the plain versions run instead."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_attention_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = bwd_delta(o, do)
        if q.device.type == "cpu":  # one dense pass for all three gradients
            with kernel_region() as region:
                dq, dk, dv = bwd_plain(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
            region.note("flash_attention_bwd", (q, k, v, do, lse, delta), (dq, dk, dv),
                        attention_flops(q, ctx.causal, 5))
        else:
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, scale=None, causal=True):
    """Streaming attention over [batch, seq, heads, head_dim] inputs."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, float(scale), bool(causal))
