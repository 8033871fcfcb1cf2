"""Neural-network ops on torch tensors: the port of ``paddle_tpu/ops/nn_ops.py``.

Each function keeps the JAX function's layout (weights ``[in, out]``,
convolution weights OIHW, attention over ``[batch, seq, heads, head_dim]``)
and its operation order, so the two packages compute the same thing step by
step. Where a JAX op promotes operands of two float types (``linear``'s
product, dense attention's P·V, a convolution's operands), the port casts
them to the common type first (``promoted``): torch refuses mixed types.

Convolution and pooling go to torch's library calls (cuDNN and ATen on the
card), as the JAX package leaves them to XLA (``lax.conv_general_dilated``,
``reduce_window``); the normalisations are the JAX ops' compositions of
reductions and elementwise ops. Torch's calls take only symmetric padding,
so the JAX padding forms (``"SAME"``, ``"VALID"``, per-side pairs, the
ceil-mode extension) are resolved to per-side pairs first (``_pads``) and
padded explicitly where the two sides differ.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .kernels import flash_attention as _flash


def promoted(*tensors):
    """``tensors`` cast to their common type, as jnp promotes the operands of
    a product (bf16 with f32 gives f32); as they are when their types agree."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return [t if t.dtype == dtype else t.to(dtype) for t in tensors]


def linear(x, weight, bias=None):
    """y = x @ W (+ b) with the Paddle weight layout ``[in, out]``."""
    x, weight = promoted(x, weight)
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def layer_norm(x, weight=None, bias=None, *, epsilon=1e-5, begin_norm_axis=-1):
    """Biased variance over the trailing axes from ``begin_norm_axis``."""
    if begin_norm_axis < 0:
        begin_norm_axis = x.dim() + begin_norm_axis
    axes = tuple(range(begin_norm_axis, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def gelu(x, *, approximate=False):
    """``approximate=True`` is the tanh form, written as ``jax.nn.gelu`` writes it."""
    if approximate:
        cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * (x ** 3))))
        return x * cdf
    return torch.nn.functional.gelu(x)


def softmax(x, *, axis=-1):
    return torch.softmax(x, dim=axis)


def embedding(x, weight, *, padding_idx=None):
    out = weight[x.long()]
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


def dropout(x, generator, *, p=0.5, mode="upscale_in_train", mask_shape=None):
    """``generator`` draws the keep mask (the JAX op takes a key);
    ``mask_shape``, broadcastable to ``x``, keeps the mask constant along
    the axes where it is 1 (Paddle's ``axis``)."""
    if p == 0.0:
        return x
    keep = torch.rand(mask_shape or x.shape, generator=generator, device=x.device) < (1.0 - p)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


def scaled_dot_product_attention(
    q, k, v, mask=None, dropout_generator=None, *, scale=None, is_causal=False,
    dropout_p=0.0,
):
    """Dense attention over ``[batch, seq, heads, head_dim]``.

    The causal mask fills with ``finfo(dtype).min`` over ``tril(k=kl-ql)``;
    an additive ``mask`` broadcasts over the ``[b, h, q, k]`` logits.
    Dropout applies to the probabilities when a generator is given."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    qf, kf, vf = (x.transpose(1, 2) for x in (q, k, v))  # [b, h, s, d]
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(ql, kl, dtype=torch.bool, device=logits.device).tril(kl - ql)
        logits = logits.masked_fill(~causal, torch.finfo(logits.dtype).min)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and dropout_generator is not None:
        probs = dropout(probs, dropout_generator, p=dropout_p)
    # a mask of another type than the logits (BERT's f32 mask under O2)
    # promotes them; jnp's einsum then promotes V
    out = torch.einsum("bhqk,bhkd->bhqd", *promoted(probs, vf))
    return out.transpose(1, 2)


def cached_attention(q, k_cache, v_cache, k_new, v_new, cur_len, *, scale):
    """One KV-cache attention step over a PREALLOCATED ``[b, max_len, h, d]`` cache.

    Unlike the JAX op, which returns updated copies, this writes ``k_new`` /
    ``v_new`` into the caches IN PLACE at ``cur_len`` (no copy of the whole
    cache per step) and returns the same cache tensors. Token i of the new
    chunk attends cache positions ``j <= cur_len + i`` (prefix + causal
    mask, filled with -1e30); the output is cast to q's dtype.

    Returns ``(out [b, s_new, h, d], k_cache, v_cache)``."""
    cur = int(cur_len)
    s_new = q.shape[1]
    k_cache[:, cur:cur + s_new] = k_new.to(k_cache.dtype)
    v_cache[:, cur:cur + s_new] = v_new.to(v_cache.dtype)
    L = k_cache.shape[1]
    # the JAX op scales by an f32 scalar, which promotes bf16 logits to f32:
    # the softmax and the P·V product run in f32 there, and so they do here
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float() * scale
    allowed = (
        torch.arange(L, device=q.device)[None, :]
        <= (cur + torch.arange(s_new, device=q.device))[:, None]
    )  # [s_new, L]
    logits = logits.masked_fill(~allowed[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_cache.float())
    return out.to(q.dtype), k_cache, v_cache


def paged_decode_attention(q, k_pool, v_pool, tables, lens, k_new, v_new, *,
                           scale, block_size, prefill=False):
    """Paged-KV variant of ``cached_attention``: each sequence's context is a
    chain of fixed-size blocks in one shared pool.

      q            [b, s, h, d]   query chunk (s == 1 for decode steps)
      k/v_pool     [n_blocks, block_size, h, d]  the shared block pool
      tables       [b, n_blk] int  physical block id per logical block
      lens         [b] int  tokens already cached per row (pre-append)
      k/v_new      [b, s, h, d]   this chunk's K/V, written at lens..lens+s-1

    Writes the new K/V into the pools IN PLACE and returns ``(out [b, s, h,
    d], k_pool, v_pool)``. ``lens`` and ``tables`` stay on the device: no
    value is read on the host, so the function can be captured in a CUDA
    graph. The attention math is ``cached_attention``'s (einsum, f32 logits,
    −1e30 mask, softmax, cast to q's dtype), so over the same context
    length the two are bitwise equal.

    ``prefill=True`` asserts the chunk starts at position 0 with ``s`` a
    block multiple and writes whole blocks in one indexed store; otherwise
    (decode: s == 1) each of the s positions is one store at (block,
    offset). Rows padded into a batch bucket must point their table at a
    PRIVATE scratch block (one per batch slot): a duplicate index in one
    store lands in an undefined order on the card.
    """
    b, s = q.shape[0], q.shape[1]
    tables = tables.long()
    if prefill:
        if s % block_size != 0:
            raise ValueError(
                f"paged prefill chunk length {s} is not a multiple of "
                f"block_size {block_size}"
            )
        nb = s // block_size
        shape = (b, nb, block_size) + tuple(k_new.shape[2:])
        k_pool[tables[:, :nb]] = k_new.to(k_pool.dtype).reshape(shape)
        v_pool[tables[:, :nb]] = v_new.to(v_pool.dtype).reshape(shape)
    else:
        for i in range(s):
            pos = lens.long() + i
            blk = torch.gather(tables, 1, (pos // block_size)[:, None])[:, 0]
            off = pos % block_size
            k_pool[blk, off] = k_new[:, i].to(k_pool.dtype)
            v_pool[blk, off] = v_new[:, i].to(v_pool.dtype)
    L = tables.shape[1] * block_size
    k_cache = k_pool[tables].reshape((b, L) + tuple(k_pool.shape[-2:]))
    v_cache = v_pool[tables].reshape((b, L) + tuple(v_pool.shape[-2:]))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_cache.to(q.dtype)).float() * scale
    # token i of the chunk may attend positions j <= lens + i: the
    # cached_attention mask with a per-row cur
    allowed = (
        torch.arange(L, device=q.device)[None, None, :]
        <= (lens.long()[:, None] + torch.arange(s, device=q.device)[None, :])[:, :, None]
    )  # [b, s, L]
    logits = logits.masked_fill(~allowed[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_cache.float())
    return out.to(q.dtype), k_pool, v_pool


def softmax_with_cross_entropy(
    logits, label, *, soft_label=False, ignore_index=-100, axis=-1, reduction="none",
):
    """Log-softmax cross-entropy, with the mean or sum folded in when asked.

    Hard labels are clipped below at 0 before the gather; a label past the
    last class gives NaN, as the JAX op's ``take_along_axis`` fill does, and
    positions whose label is ``ignore_index`` give 0 (also an ``ignore_index``
    past the last class). With ``reduction="none"`` the loss keeps the class
    axis with size 1, as the JAX op does."""
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lab = label
        if lab.dim() == logits.dim():
            lab = lab.squeeze(axis)
        n_classes = logp.shape[axis]
        picked = torch.gather(logp, axis, lab.clamp(0, n_classes - 1).long().unsqueeze(axis))
        loss = torch.where((lab >= n_classes).unsqueeze(axis),
                           torch.full_like(picked, math.nan), -picked)
        valid = (lab != ignore_index).unsqueeze(axis)
        loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def flash_scaled_dot_product_attention(q, k, v, *, scale=None, is_causal=False):
    """Flash path: the hand-written kernel on a CUDA tensor, its plain
    version on a CPU tensor. No mask or dropout: the functional selector
    takes the dense path for those."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    return _flash.flash_attention(q, k, v, scale=s, causal=is_causal)


def flash_attention_eligible(q_shape, k_shape, v_shape) -> bool:
    return (
        tuple(q_shape) == tuple(k_shape) == tuple(v_shape)
        and len(q_shape) == 4
        and _flash.supports(q_shape[1], q_shape[3])
    )


# ---------------------------------------------------------------------------
# padding forms (``paddle_tpu/ops/nn_ops.py:18-39``), resolved to pairs
# ---------------------------------------------------------------------------
def _pair(v, n=2):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,) * n


def _same_pads(spatial, window, stride):
    """``lax``'s "SAME": the output is ``ceil(in / stride)`` and the padding
    it needs is split with the odd element on the high side."""
    pads = []
    for n, w, s in zip(spatial, window, stride):
        out = -(-n // s)
        total = max((out - 1) * s + w - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pads(padding, spatial, kernel, stride, dilation):
    """Paddle's padding spec (an int, one per spatial axis, a (lo, hi) pair
    per axis, ``"SAME"`` or ``"VALID"``) as a (lo, hi) pair per axis, for a
    window of ``kernel`` dilated by ``dilation`` over ``spatial``."""
    nd = len(spatial)
    if isinstance(padding, str):
        p = padding.upper()
        if p == "SAME":
            window = [(k - 1) * d + 1 for k, d in zip(kernel, dilation)]
            return _same_pads(spatial, window, stride)
        if p == "VALID":
            return [(0, 0)] * nd
        raise ValueError(padding)
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd:
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    raise ValueError(f"bad padding {padding}")


def _torch_pad(pairs):
    """(lo, hi) pairs of the spatial axes, first to last, in ``F.pad``'s order."""
    out = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


def _channels_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _channels_back(x, channel_last):
    return x.movedim(1, -1) if channel_last else x


def _bias_shape(ndim, channel_last):
    shape = [1] * ndim
    shape[-1 if channel_last else 1] = -1
    return shape


# ---------------------------------------------------------------------------
# Convolution (``paddle_tpu/ops/nn_ops.py:44-146``, ``:1158-1222``)
# ---------------------------------------------------------------------------
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _conv(x, weight, bias, nd, stride, padding, dilation, groups, channel_last):
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    x, weight = promoted(x, weight)
    x = _channels_first(x, channel_last)
    pads = _pads(padding, x.shape[2:], weight.shape[2:], stride, dilation)
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, _torch_pad(pads))
        pads = [(0, 0)] * nd
    out = _CONV[nd](x, weight, None, stride, [lo for lo, _ in pads], dilation, groups)
    out = _channels_back(out, channel_last)
    if bias is not None:
        out = out + bias.reshape(_bias_shape(out.dim(), channel_last))
    return out


def conv1d(x, weight, bias=None, *, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv(x, weight, bias, 1, stride, padding, dilation, groups,
                 data_format not in ("NCL", "NCH"))


def conv2d(x, weight, bias=None, *, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv(x, weight, bias, 2, stride, padding, dilation, groups, data_format == "NHWC")


def conv3d(x, weight, bias=None, *, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv(x, weight, bias, 3, stride, padding, dilation, groups, data_format == "NDHWC")


def _conv_transpose(x, weight, bias, nd, stride, padding, output_padding, dilation, groups,
                    channel_last):
    """The transposed convolution with padding 0, then each spatial axis cut
    to ``[lo, full - hi + output_padding)`` (zeros past the full extent), as
    the JAX op's lhs-dilated convolution pads ``(d(k-1) - lo, d(k-1) - hi +
    output_padding)``; the weight is Paddle's (and torch's) ``[in, out /
    groups, *k]``."""
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv_transpose")
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    output_padding = _pair(output_padding, nd)
    x, weight = promoted(x, weight)
    x = _channels_first(x, channel_last)
    pads = _pads(padding, x.shape[2:], weight.shape[2:], stride, dilation)
    out = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
    grow = []
    for i, (lo, hi) in enumerate(pads):
        full = out.shape[2 + i]
        end = full - hi + output_padding[i]
        out = out.narrow(2 + i, lo, min(end, full) - lo)
        grow.append(max(end - full, 0))
    if any(grow):
        out = F.pad(out, [v for g in reversed(grow) for v in (0, g)])
    out = _channels_back(out, channel_last)
    if bias is not None:
        out = out + bias.reshape(_bias_shape(out.dim(), channel_last))
    return out


def conv2d_transpose(x, weight, bias=None, *, stride=1, padding=0, output_padding=0,
                     dilation=1, groups=1, data_format="NCHW"):
    return _conv_transpose(x, weight, bias, 2, stride, padding, output_padding, dilation,
                           groups, data_format == "NHWC")


def conv1d_transpose(x, weight, bias=None, *, stride=1, padding=0, output_padding=0,
                     dilation=1, groups=1, data_format="NCL"):
    """NCL whatever ``data_format`` says, as the JAX op lowers it through
    the NCHW 2-d transpose; a sequence argument gives its first entry."""
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv1d_transpose")

    def one(v):
        return v if isinstance(v, int) else v[0]

    return _conv_transpose(x, weight, bias, 1, one(stride), one(padding), one(output_padding),
                           one(dilation), groups, False)


def conv3d_transpose(x, weight, bias=None, *, stride=1, padding=0, output_padding=0,
                     dilation=1, groups=1, data_format="NCDHW"):
    return _conv_transpose(x, weight, bias, 3, _tuple3(stride), padding,
                           _tuple3(output_padding), _tuple3(dilation), groups,
                           data_format == "NDHWC")


# ---------------------------------------------------------------------------
# Pooling (``paddle_tpu/ops/nn_ops.py:153-390``, ``:966-1155``): a window
# reduction over explicit (lo, hi) pads, as ``lax.reduce_window`` takes them
# ---------------------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _ceil_extra(dim, k, s, p_lo, p_hi):
    """High-side padding extension so ceil_mode emits the tail window; a
    window starting at or beyond input + low pad is dropped."""
    out_ceil = -(-(dim + p_lo + p_hi - k) // s) + 1
    if (out_ceil - 1) * s >= dim + p_lo:
        out_ceil -= 1
    out_floor = (dim + p_lo + p_hi - k) // s + 1
    return (out_ceil - out_floor) * s


def _window_max(x, ks, st, pads):
    """Max over windows of a channels-first ``x`` padded by ``pads`` with
    -inf (torch's own padding where it is symmetric and at most half the
    window, which it treats the same)."""
    nd = len(ks)
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, ks)):
        return _MAX_POOL[nd](x, ks, st, [lo for lo, _ in pads])
    x = F.pad(x, _torch_pad(pads), value=-math.inf)
    return _MAX_POOL[nd](x, ks, st, 0)


def _window_sum(x, ks, st, pads):
    """Sum over windows of a channels-first ``x`` padded by ``pads`` with 0."""
    nd = len(ks)
    if nd == 1:
        return _window_sum(x.unsqueeze(-1), ks + (1,), st + (1,), pads + [(0, 0)])[..., 0]
    if any(lo or hi for lo, hi in pads):
        x = F.pad(x, _torch_pad(pads))
    return _AVG_POOL[nd](x, ks, st, 0, divisor_override=1)


def _window_counts(x, extent, ks, st, pads):
    """Elements of ``extent`` (no padding) in each window: the window sum of
    ones shaped ``[1, 1, *extent]``, which broadcasts over batch and channels."""
    ones = torch.ones((1, 1) + tuple(extent), dtype=x.dtype, device=x.device)
    return _window_sum(ones, ks, st, pads)


def _pool_pads(x, ks, st, padding, ceil_mode):
    """The spatial (lo, hi) pads of a pool and whether they came from a
    string ("SAME"/"VALID"; those take no ceil-mode extension)."""
    spatial = x.shape[2:]
    pads = _pads(padding, spatial, ks, st, (1,) * len(ks))
    if isinstance(padding, str) or not ceil_mode:
        return pads, pads
    ext = [(lo, hi + _ceil_extra(n, k, s, lo, hi))
           for (lo, hi), n, k, s in zip(pads, spatial, ks, st)]
    return pads, ext


def max_pool2d(x, *, kernel_size, stride=None, padding=0, ceil_mode=False, data_format="NCHW"):
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    cl = data_format != "NCHW"
    x = _channels_first(x, cl)
    _, pads = _pool_pads(x, ks, st, padding, ceil_mode)
    return _channels_back(_window_max(x, ks, st, pads), cl)


def max_pool2d_with_index(x, *, kernel_size, stride=None, padding=0, ceil_mode=False):
    """Max pool returning ``(out, mask)``, the mask each max's flat index in
    its input plane (NCHW); the first maximum in the window's row-major scan
    wins a tie, as in the JAX op."""
    if isinstance(padding, str):
        raise ValueError(
            "max_pool2d(return_mask=True) needs explicit integer padding "
            "(the index math has no SAME/VALID form); pass numbers"
        )
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    ph, pw = _pair(padding)
    h, w = x.shape[2], x.shape[3]
    eh = _ceil_extra(h, ks[0], st[0], ph, ph) if ceil_mode else 0
    ew = _ceil_extra(w, ks[1], st[1], pw, pw) if ceil_mode else 0
    xp = F.pad(x, (pw, pw + ew, ph, ph + eh), value=-math.inf)
    out, idx = F.max_pool2d(xp, ks, st, 0, return_indices=True)
    wp = xp.shape[3]
    idx = (idx // wp - ph) * w + (idx % wp - pw)
    return out, idx


def _unpool(x, indices, spatial_out):
    n, c = x.shape[0], x.shape[1]
    flat = torch.zeros((n * c, math.prod(spatial_out)), dtype=x.dtype, device=x.device)
    flat = flat.scatter(1, indices.reshape(n * c, -1).long(), x.reshape(n * c, -1))
    return flat.reshape((n, c) + tuple(spatial_out))


def max_unpool2d(x, indices, *, kernel_size, stride=None, padding=0, output_size=None):
    """Scatter pooled values back to their argmax positions (NCHW)."""
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    ph, pw = _pair(padding)
    oh, ow = x.shape[2], x.shape[3]
    if output_size is not None:
        h, w = int(output_size[-2]), int(output_size[-1])
    else:
        h = (oh - 1) * st[0] - 2 * ph + ks[0]
        w = (ow - 1) * st[1] - 2 * pw + ks[1]
    return _unpool(x, indices, (h, w))


def avg_pool2d(x, *, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW"):
    """The window sum over the pads, divided as the JAX op divides it: by
    ``divisor_override``; by the full window under "SAME"/"VALID"; by the
    real elements of each window when ``exclusive`` and padded; otherwise by
    the window clamped to the padded extent (the ceil-mode tail counts only
    what it covers)."""
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    cl = data_format != "NCHW"
    x = _channels_first(x, cl)
    base, pads = _pool_pads(x, ks, st, padding, ceil_mode)
    out = _avg_divide(x, _window_sum(x, ks, st, pads), ks, st, base, pads,
                      isinstance(padding, str), exclusive, divisor_override)
    return _channels_back(out, cl)


def _avg_divide(x, summed, ks, st, base, pads, string_pad, exclusive, divisor_override):
    if divisor_override is not None:
        if divisor_override <= 0:
            raise ValueError(f"divisor_override must be > 0, got {divisor_override}")
        return summed / divisor_override
    window = math.prod(ks)
    if string_pad:
        return summed / window
    if exclusive:
        if any(p != (0, 0) for p in pads):
            return summed / _window_counts(x, x.shape[2:], ks, st, pads)
        return summed / window
    if pads != base:
        padded = [n + lo + hi for n, (lo, hi) in zip(x.shape[2:], base)]
        ext = [(0, hi - bhi) for (_, hi), (_, bhi) in zip(pads, base)]
        return summed / _window_counts(x, padded, ks, st, ext)
    return summed / window


def adaptive_avg_pool2d(x, *, output_size, data_format="NCHW"):
    """An even split is an average pool; otherwise each spatial axis is
    contracted with its averaging matrix ``[o, n]``, as in the JAX op."""
    os = _pair(output_size)
    cl = data_format != "NCHW"
    x = _channels_first(x, cl)
    h, w = x.shape[2], x.shape[3]
    if h % os[0] == 0 and w % os[1] == 0:
        ks = (h // os[0], w // os[1])
        out = _window_sum(x, ks, ks, [(0, 0), (0, 0)]) / (ks[0] * ks[1])
        return _channels_back(out, cl)
    out = x
    for ax, o, n in ((2, os[0], h), (3, os[1], w)):
        idx = torch.arange(n, device=x.device)
        starts = (torch.arange(o, device=x.device) * n) // o
        ends = ((torch.arange(o, device=x.device) + 1) * n + o - 1) // o
        mask = (idx[None, :] >= starts[:, None]) & (idx[None, :] < ends[:, None])
        mat = mask.to(x.dtype) / mask.sum(dim=1, keepdim=True).to(x.dtype)
        out = torch.tensordot(out, mat, dims=([ax], [1])).movedim(-1, ax)
    return _channels_back(out, cl)


def max_pool1d(x, *, kernel_size, stride=None, padding=0, ceil_mode=False):
    """The 2-d pool over ``x[..., None]``; like the JAX op it takes no
    ceil-mode extension."""
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = stride if isinstance(stride, int) else (stride[0] if stride else k)
    p = padding if isinstance(padding, int) else padding[0]
    return max_pool2d(x[..., None], kernel_size=(k, 1), stride=(s, 1), padding=(p, 0))[..., 0]


def adaptive_avg_pool1d(x, *, output_size):
    return adaptive_avg_pool2d(x[..., None], output_size=(output_size, 1))[..., 0]


def _tuple3(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in (list(v) + [v[-1]] * 3)[:3])
    return (int(v),) * 3


def _pool3d_geometry(x, kernel_size, stride, padding, ceil_mode):
    ks = _tuple3(kernel_size)
    st = _tuple3(stride if stride is not None else kernel_size)
    pd = _tuple3(padding)
    pads = [(p, p + (_ceil_extra(n, k, s, p, p) if ceil_mode else 0))
            for n, k, s, p in zip(x.shape[2:], ks, st, pd)]
    return ks, st, pd, pads


def max_pool3d(x, *, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCDHW"):
    cl = data_format != "NCDHW"
    x = _channels_first(x, cl)
    ks, st, _, pads = _pool3d_geometry(x, kernel_size, stride, padding, ceil_mode)
    return _channels_back(_window_max(x, ks, st, pads), cl)


def avg_pool3d(x, *, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW"):
    cl = data_format != "NCDHW"
    x = _channels_first(x, cl)
    ks, st, pd, pads = _pool3d_geometry(x, kernel_size, stride, padding, ceil_mode)
    base = [(p, p) for p in pd]
    out = _avg_divide(x, _window_sum(x, ks, st, pads), ks, st, base, pads, False, exclusive,
                      divisor_override)
    return _channels_back(out, cl)


def avg_pool1d(x, *, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True):
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = (stride if isinstance(stride, int) else (stride[0] if stride else k)) or k
    p = padding if isinstance(padding, int) else padding[0]
    return avg_pool2d(x[..., None], kernel_size=(k, 1), stride=(s, 1), padding=(p, 0),
                      ceil_mode=ceil_mode, exclusive=exclusive)[..., 0]


def _adaptive_axis_reduce(x, axis, out_size, kind):
    """Reduce the windows ``[i n / o, ceil((i + 1) n / o))`` along one axis."""
    n = x.shape[axis]
    parts = []
    for i in range(out_size):
        seg = x.narrow(axis, (i * n) // out_size, -(-((i + 1) * n) // out_size) - (i * n) // out_size)
        parts.append(seg.amax(dim=axis, keepdim=True) if kind == "max"
                     else seg.mean(dim=axis, keepdim=True))
    return torch.cat(parts, dim=axis)


def adaptive_pool_nd(x, *, output_size, nd, kind, data_format="channels_first"):
    lo = 2 if data_format == "channels_first" else 1
    os = output_size if isinstance(output_size, (tuple, list)) else (output_size,) * nd
    out = x
    for i in range(nd):
        if os[i] is not None:
            out = _adaptive_axis_reduce(out, lo + i, int(os[i]), kind)
    return out


def adaptive_max_pool1d(x, *, output_size):
    return adaptive_pool_nd(x, output_size=output_size, nd=1, kind="max")


def adaptive_max_pool2d(x, *, output_size, data_format="NCHW"):
    return adaptive_pool_nd(x, output_size=output_size, nd=2, kind="max",
                            data_format="channels_first" if data_format == "NCHW"
                            else "channels_last")


def adaptive_max_pool3d(x, *, output_size, data_format="NCDHW"):
    return adaptive_pool_nd(x, output_size=output_size, nd=3, kind="max",
                            data_format="channels_first" if data_format == "NCDHW"
                            else "channels_last")


def adaptive_avg_pool3d(x, *, output_size, data_format="NCDHW"):
    return adaptive_pool_nd(x, output_size=output_size, nd=3, kind="avg",
                            data_format="channels_first" if data_format == "NCDHW"
                            else "channels_last")


def max_unpool1d(x, indices, *, kernel_size, stride=None, padding=0, output_size=None):
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = k if stride is None else (stride if isinstance(stride, int) else stride[0])
    p = padding if isinstance(padding, int) else padding[0]
    os2 = None if output_size is None else tuple(output_size) + (1,)
    return max_unpool2d(x[..., None], indices[..., None], kernel_size=(k, 1), stride=(s, 1),
                        padding=(p, 0), output_size=os2)[..., 0]


def max_unpool3d(x, indices, *, kernel_size, stride=None, padding=0, output_size=None):
    ks = _tuple3(kernel_size)
    st = _tuple3(stride if stride is not None else kernel_size)
    pd = _tuple3(padding)
    if output_size is not None:
        spatial = tuple(int(v) for v in output_size[-3:])
    else:
        spatial = tuple((o - 1) * s - 2 * p + k for o, s, p, k in zip(x.shape[2:], st, pd, ks))
    return _unpool(x, indices, spatial)


# ---------------------------------------------------------------------------
# Normalization (``paddle_tpu/ops/nn_ops.py:397-466``)
# ---------------------------------------------------------------------------
def _channel_shape(x, data_format):
    shape = [1] * x.dim()
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    shape[c_axis] = x.shape[c_axis]
    return shape


def batch_norm_infer(x, mean, var, scale, bias, *, epsilon=1e-5, data_format="NCHW"):
    shape = _channel_shape(x, data_format)
    inv = torch.rsqrt(var + epsilon)
    if scale is not None:
        inv = inv * scale
    out = (x - mean.reshape(shape)) * inv.reshape(shape)
    return out if bias is None else out + bias.reshape(shape)


def batch_norm_train(x, scale, bias, *, epsilon=1e-5, data_format="NCHW"):
    """Returns ``(out, batch_mean, batch_var)``: ``x`` normalised by its
    batch statistics over every axis but the channel one, with the biased
    variance, in the JAX op's order (mean, variance, then one scale and
    shift); the statistics carry no gradient, as the JAX layer writes them
    under ``no_grad``.

    A composition, not ATen's batch norm: at a small batch a channel's
    statistics can rest on a handful of values, where another variance
    algorithm (ATen's Welford) moves a normalised output far more than the
    two packages' differing summation orders do."""
    shape = _channel_shape(x, data_format)
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    mean = x.mean(dim=axes)
    var = x.var(dim=axes, unbiased=False)
    inv = torch.rsqrt(var + epsilon)
    if scale is not None:
        inv = inv * scale
    out = (x - mean.reshape(shape)) * inv.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, mean.detach(), var.detach()


def rms_norm(x, weight, *, epsilon=1e-6):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + epsilon) * weight


def group_norm(x, weight=None, bias=None, *, num_groups, epsilon=1e-5, data_format="NCHW"):
    if data_format != "NCHW":
        raise NotImplementedError("group_norm takes NCHW")
    n, c = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    xg = x.reshape((n, num_groups, c // num_groups) + spatial)
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = xg.var(dim=axes, unbiased=False, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    shape = (1, c) + (1,) * len(spatial)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, weight=None, bias=None, *, epsilon=1e-5):
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def normalize(x, *, p=2.0, axis=1, epsilon=1e-12):
    n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def local_response_norm(x, *, size, alpha=1e-4, beta=0.75, k=1.0):
    """Over the channel axis of NC...: ``x / (k + alpha * window_sum(x²) / size)^beta``."""
    sq = torch.square(x)
    half = size // 2
    pads = [0, 0] * (x.dim() - 2) + [half, size - half - 1]
    padded = F.pad(sq, pads)
    acc = sum(padded[:, i:i + x.shape[1]] for i in range(size))
    return x / torch.pow(k + alpha * acc / size, beta)


def spectral_normalize(wt, u, v, *, dim, power_iters, eps):
    """``wt`` over its largest singular value, estimated by ``power_iters``
    rounds of power iteration from ``u`` and ``v``; returns the result and
    the refined ``u``, ``v`` (no gradient through them)."""
    mat = wt.movedim(dim, 0).reshape(wt.shape[dim], -1)
    for _ in range(power_iters):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ mat @ v
    return wt / sigma, u.detach(), v.detach()


# ---------------------------------------------------------------------------
# Activations (``paddle_tpu/ops/nn_ops.py:473-600``), the jax.nn formulas
# ---------------------------------------------------------------------------
def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def leaky_relu(x, *, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight):
    return torch.where(x >= 0, x, x * weight)


def elu(x, *, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(torch.where(x > 0, 0.0, x)))


def selu(x, *, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, *, alpha=1.0):
    return torch.clamp(x, min=0.0) + alpha * torch.expm1(torch.clamp(x, max=0.0) / alpha)


def sigmoid(x):
    return torch.sigmoid(x)


def silu(x):
    return x * torch.sigmoid(x)


swish = silu


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mish(x):
    return x * torch.tanh(_softplus(x))


def softplus(x, *, beta=1.0, threshold=20.0):
    scaled = beta * x
    return torch.where(scaled > threshold, x, torch.log1p(torch.exp(scaled)) / beta)


def softsign(x):
    return x / (torch.abs(x) + 1)


def softshrink(x, *, threshold=0.5):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardshrink(x, *, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


def hardtanh(x, *, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


def hardsigmoid(x, *, slope=1.0 / 6.0, offset=0.5):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def hardswish(x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def tanhshrink(x):
    return x - torch.tanh(x)


def thresholded_relu(x, *, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros((), dtype=x.dtype, device=x.device))


def log_sigmoid(x):
    return -_softplus(-x)


def maxout(x, *, groups, axis=1):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis] = x.shape[axis] // groups
    shape.insert(axis + 1, groups)
    return x.reshape(shape).amax(dim=axis + 1)


def glu(x, *, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def log_softmax(x, *, axis=-1):
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, generator, *, temperature=1.0, hard=False, axis=-1):
    """Gumbel noise from ``generator`` (the JAX op takes a key); ``hard``
    gives the one-hot of the argmax with the soft sample's gradient."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


# ---------------------------------------------------------------------------
# Losses (``paddle_tpu/ops/nn_ops.py:607-700``, ``:1392-1545``)
# ---------------------------------------------------------------------------
def mse_loss(input, label):
    return torch.square(input - label)


def l1_loss(input, label):
    return torch.abs(input - label)


def smooth_l1_loss(input, label, *, delta=1.0):
    d = torch.abs(input - label)
    return torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)


def bce_loss(input, label):
    eps = 1e-12
    return -(label * torch.log(input + eps) + (1 - label) * torch.log(1 - input + eps))


def bce_with_logits(logit, label, pos_weight=None):
    log_p = log_sigmoid(logit)
    log_not_p = log_sigmoid(-logit)
    if pos_weight is not None:
        return -(pos_weight * label * log_p + (1 - label) * log_not_p)
    return -(label * log_p + (1 - label) * log_not_p)


def _take_last(t, label):
    """``t[..., label]`` with the label clipped below at 0."""
    return torch.gather(t, -1, label.clamp(min=0).long().unsqueeze(-1)).squeeze(-1)


def nll_loss(log_prob, label, weight=None, *, ignore_index=-100):
    loss = -_take_last(log_prob, label)
    if weight is not None:
        loss = loss * weight[label.clamp(min=0).long()]
    return torch.where(label != ignore_index, loss, torch.zeros((), dtype=loss.dtype,
                                                                device=loss.device))


def kl_div(input, label):
    # input is a log-probability
    return label * (torch.log(torch.clamp(label, min=1e-12)) - input)


def cosine_similarity(x1, x2, *, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def hinge_embedding_loss(input, label, *, margin=1.0):
    return torch.where(label == 1.0, input, torch.clamp(margin - input, min=0.0))


def margin_ranking_loss(input, other, label, *, margin=0.0):
    return torch.clamp(-label * (input - other) + margin, min=0.0)


def label_smooth(label, *, epsilon=0.1):
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


def square_error_cost(input, label):
    d = input - label
    return d * d


def log_loss(input, label, *, epsilon=1e-4):
    return -label * torch.log(input + epsilon) - (1.0 - label) * torch.log(1.0 - input + epsilon)


def dice_loss(input, label, *, epsilon=1e-5):
    label_oh = F.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(input.dtype)
    red = tuple(range(1, input.dim()))
    intersect = torch.sum(input * label_oh, dim=red)
    denom = torch.sum(input, dim=red) + torch.sum(label_oh, dim=red)
    dice = (2.0 * intersect + epsilon) / (denom + epsilon)
    return torch.mean(1.0 - dice)


def npair_loss(anchor, positive, labels, *, l2_reg=0.002):
    reg = torch.mean(torch.sum(anchor * anchor, dim=1)) + torch.mean(
        torch.sum(positive * positive, dim=1))
    reg = reg * 0.25 * l2_reg
    sim = anchor @ positive.T
    labels = labels.reshape(-1)
    target = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    target = target / torch.sum(target, dim=1, keepdim=True)
    logp = torch.log_softmax(sim, dim=1)
    ce = -torch.mean(torch.sum(target * logp, dim=1))
    return ce + reg


def ctc_loss_per_sample(log_probs, labels, input_lengths, label_lengths, *, blank=0):
    """The CTC forward algorithm in log space over ``[T, B, C]`` log-probs;
    ``labels`` ``[B, L]`` padded with anything (masked by ``label_lengths``).
    Returns each sample's negative log-likelihood."""
    T, B, _ = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev, dt = log_probs.device, log_probs.dtype
    neg_inf = torch.full((), -1e30, dtype=dt, device=dev)
    labels = labels.long()
    input_lengths = input_lengths.long()
    label_lengths = label_lengths.long()
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    skip_ok = torch.zeros((B, S), dtype=torch.bool, device=dev)
    skip_ok[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    valid_s = torch.arange(S, device=dev)[None, :] < (2 * label_lengths[:, None] + 1)

    def emit(t_lp):
        return torch.gather(t_lp, 1, ext)

    first = emit(log_probs[0])
    alpha = torch.full((B, S), -1e30, dtype=dt, device=dev)
    alpha = torch.cat([log_probs[0, :, blank:blank + 1],
                       torch.where(label_lengths[:, None] > 0, first[:, 1:2], neg_inf),
                       alpha[:, 2:]], dim=1)
    for t in range(1, T):
        prev1 = torch.cat([neg_inf.expand(B, 1), alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg_inf.expand(B, 2), alpha[:, :-2]], dim=1)
        prev2 = torch.where(skip_ok, prev2, neg_inf)
        merged = torch.logsumexp(torch.stack([alpha, prev1, prev2]), dim=0)
        new = torch.where(valid_s, merged + emit(log_probs[t]), neg_inf)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    end_a = torch.gather(alpha, 1, (2 * label_lengths - 1).clamp(min=0)[:, None])[:, 0]
    end_b = torch.gather(alpha, 1, (2 * label_lengths)[:, None])[:, 0]
    ll = torch.logsumexp(torch.stack([end_a, end_b]), dim=0)
    t_idx = torch.arange(T, device=dev)[:, None]
    blank_sum = torch.sum(torch.where(t_idx < input_lengths[None, :], log_probs[:, :, blank],
                                      torch.zeros((), dtype=dt, device=dev)), dim=0)
    ll = torch.where(label_lengths == 0, blank_sum, ll)
    return -ll


def hsigmoid_loss_op(x, labels, weight, bias=None, path_table=None, path_code=None, *,
                     num_classes):
    """Hierarchical sigmoid loss over the default complete binary tree
    (code ``c = label + num_classes``, node ``(c >> (j + 1)) - 1``, bit
    ``(c >> j) & 1``) or a custom tree; returns ``[N, 1]``."""
    if path_table is not None:
        idx = path_table.long()
        bits = path_code.to(x.dtype)
        valid = idx >= 0
        safe_idx = idx.clamp(min=0)
    else:
        max_len = int(math.floor(math.log2(max(num_classes - 1, 1)))) + 1
        c = labels.reshape(-1).long() + num_classes
        j = torch.arange(max_len, device=x.device)
        idx = (c[:, None] >> (j[None, :] + 1)) - 1
        bits = ((c[:, None] >> j[None, :]) & 1).to(x.dtype)
        valid = (c[:, None] >> (j[None, :] + 1)) > 0
        safe_idx = idx.clamp(0, weight.shape[0] - 1)
    w = weight[safe_idx]
    pre = torch.einsum("nld,nd->nl", w, x)
    if bias is not None:
        pre = pre + bias.reshape(-1)[safe_idx]
    loss = torch.where(valid, _softplus(pre) - bits * pre,
                       torch.zeros((), dtype=pre.dtype, device=pre.device))
    return torch.sum(loss, dim=1, keepdim=True)


def margin_cross_entropy_op(logits, label, *, margin1=1.0, margin2=0.5, margin3=0.0,
                            scale=64.0):
    """ArcFace-family margin softmax: the target logit cos θ becomes
    ``cos(m1 θ + m2) - m3``, every logit scaled by ``scale``. Returns
    ``(loss [N, 1], softmax)``."""
    oh = F.one_hot(label.reshape(-1).long(), logits.shape[-1]).to(logits.dtype)
    cos = torch.clamp(logits, -1.0, 1.0)
    if margin1 != 1.0 or margin2 != 0.0:
        target = torch.cos(margin1 * torch.arccos(cos) + margin2)
    else:
        target = cos
    target = target - margin3
    adjusted = torch.where(oh > 0, target, logits) * scale
    logp = torch.log_softmax(adjusted, dim=-1)
    loss = -torch.sum(oh * logp, dim=-1, keepdim=True)
    return loss, torch.exp(logp)


def sparse_attention_op(q, k, v, offset, columns):
    """Attention over ``[B, H, S, D]`` restricted to a per-(batch, head) CSR
    pattern, made dense as a mask; a row with no allowed key gives 0."""
    S = q.shape[-2]
    nnz = columns.shape[-1]
    j = torch.arange(nnz, device=q.device)
    rows = torch.searchsorted(offset.contiguous(), j.expand(*offset.shape[:-1], nnz).contiguous(),
                              right=True) - 1
    mask = torch.zeros(q.shape[:-2] + (S, S), dtype=torch.bool, device=q.device)
    lead = [torch.arange(n, device=q.device).reshape((-1,) + (1,) * (offset.dim() - 1 - i))
            for i, n in enumerate(offset.shape[:-1])]
    mask[tuple(lead) + (rows, columns.long())] = True
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~mask, -math.inf)
    w = torch.softmax(scores, dim=-1)
    w = torch.where(mask.any(-1, keepdim=True), w, torch.zeros((), dtype=w.dtype,
                                                                device=w.device))
    return w @ v


# ---------------------------------------------------------------------------
# Interpolate and vision ops (``paddle_tpu/ops/nn_ops.py:868-962``, ``:1229-1385``)
# ---------------------------------------------------------------------------
def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros((), dtype=x.dtype, device=x.device), out)


def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0.0)


def _resize_weights(n_in, n_out, kernel, dtype, device):
    """``jax.image``'s resampling matrix ``[n_in, n_out]`` (half-pixel
    centres, the kernel widened when downsampling, columns normalised)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    grid = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel(torch.abs(sample[None, :] - grid[:, None]) / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(dtype)


def _resize(x, size, method, axes):
    """``jax.image.resize(x, shape, method)`` along ``axes``: nearest takes
    ``floor((i + 0.5) n / o)``; linear and cubic contract each resized axis
    with its resampling matrix."""
    for ax, o in zip(axes, size):
        n = x.shape[ax]
        if n == o:
            continue
        if method == "nearest":
            idx = torch.floor((torch.arange(o, dtype=torch.float32, device=x.device) + 0.5)
                              * n / o).long()
            x = x.index_select(ax, idx)
        else:
            dt = x.dtype if x.is_floating_point() else torch.float32
            w = _resize_weights(n, o, _triangle if method == "linear" else _keys_cubic,
                                dt, x.device)
            x = torch.tensordot(x.to(dt), w, dims=([ax], [0])).movedim(-1, ax)
    return x


def interpolate(x, *, size=None, scale_factor=None, mode="nearest", align_corners=False,
                data_format="NCHW"):
    axes = (2, 3) if data_format == "NCHW" else (1, 2)
    h, w = x.shape[axes[0]], x.shape[axes[1]]
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (tuple, list)) else (scale_factor,) * 2
        size = (int(h * sf[0]), int(w * sf[1]))
    size = tuple(int(s) for s in size)
    method = {"nearest": "nearest", "bilinear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode]
    if align_corners and method != "nearest":
        out = x
        for ax, o in zip(axes, size):
            n_in = out.shape[ax]
            coords = (torch.zeros(1, device=x.device) if o == 1
                      else torch.linspace(0.0, n_in - 1.0, o, device=x.device))
            i0 = torch.clamp(torch.floor(coords).long(), 0, n_in - 1)
            i1 = torch.clamp(i0 + 1, 0, n_in - 1)
            t = (coords - i0).to(x.dtype)
            a = out.index_select(ax, i0)
            b = out.index_select(ax, i1)
            tshape = [1] * out.dim()
            tshape[ax] = o
            out = a + (b - a) * t.reshape(tshape)
        return out
    return _resize(x, size, method, axes)


def pixel_shuffle(x, *, upscale_factor, data_format="NCHW"):
    if data_format != "NCHW":
        raise NotImplementedError("pixel_shuffle takes NCHW")
    r = upscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def pixel_unshuffle(x, *, downscale_factor, data_format="NCHW"):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def grid_sample(x, grid, *, mode="bilinear", padding_mode="zeros", align_corners=True):
    """Bilinear sampling of NCHW ``x`` at ``grid`` ``[N, H', W', 2]`` (x, y
    in [-1, 1]); samples outside the input read zeros."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * 0.5 * (w - 1)
        fy = (gy + 1) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1) * w - 1) * 0.5
        fy = ((gy + 1) * h - 1) * 0.5
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    x1, y1 = x0 + 1, y0 + 1
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    batch = torch.arange(n, device=x.device).reshape(n, 1, 1)
    xl = x.permute(0, 2, 3, 1)  # [n, h, w, c]

    def sample(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = xl[batch, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]  # [n, gh, gw, c]
        return torch.where(valid[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                               device=vals.device))

    out = (sample(x0, y0) * (1 - wx) * (1 - wy) + sample(x1, y0) * wx * (1 - wy)
           + sample(x0, y1) * (1 - wx) * wy + sample(x1, y1) * wx * wy)
    return out.permute(0, 3, 1, 2)


def fold(x, *, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im: each kernel offset's columns added into its strided plane."""
    output_sizes, kernel_sizes = _pair(output_sizes), _pair(kernel_sizes)
    strides, dilations = _pair(strides), _pair(dilations)
    if isinstance(paddings, int):
        paddings = (paddings,) * 4
    elif len(paddings) == 2:
        paddings = (paddings[0], paddings[1], paddings[0], paddings[1])
    n, ckk, L = x.shape
    kh, kw = kernel_sizes
    c = ckk // (kh * kw)
    oh, ow = output_sizes
    ph = oh + paddings[0] + paddings[2]
    pw = ow + paddings[1] + paddings[3]
    nh = (ph - (dilations[0] * (kh - 1) + 1)) // strides[0] + 1
    nw = (pw - (dilations[1] * (kw - 1) + 1)) // strides[1] + 1
    if nh * nw != L:
        raise ValueError(f"fold: {L} columns inconsistent with output_sizes {output_sizes} "
                         f"(expected {nh}*{nw})")
    cols = x.reshape(n, c, kh, kw, nh, nw)
    out = torch.zeros((n, c, ph, pw), dtype=x.dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            hi, wj = i * dilations[0], j * dilations[1]
            out[:, :, hi:hi + nh * strides[0]:strides[0],
                wj:wj + nw * strides[1]:strides[1]] += cols[:, :, i, j]
    return out[:, :, paddings[0]:ph - paddings[2], paddings[1]:pw - paddings[3]]


def sequence_mask(lengths, *, maxlen, dtype=torch.int64):
    mask = torch.arange(maxlen, device=lengths.device)[None, :] < lengths.reshape(-1, 1)
    return mask.reshape(tuple(lengths.shape) + (maxlen,)).to(dtype)


def gather_tree(ids, parents):
    """Trace beam-search ancestry bottom-up over ``[T, B, beam]``."""
    cur = torch.arange(ids.shape[-1], device=ids.device).expand(ids.shape[1:])
    outs = []
    for t in range(ids.shape[0] - 1, -1, -1):
        outs.append(torch.gather(ids[t], -1, cur))
        cur = torch.gather(parents[t], -1, cur)
    return torch.stack(outs[::-1])


def temporal_shift(x, *, seg_num, shift_ratio=0.25, data_format="NCHW"):
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    pad = torch.zeros_like(v[:, :1])
    prev = torch.cat([v[:, 1:], pad], dim=1)[:, :, :c1]
    nxt = torch.cat([pad, v[:, :-1]], dim=1)[:, :, c1:c2]
    out = torch.cat([prev, nxt, v[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format != "NCHW" else out


def affine_grid(theta, *, out_shape, align_corners=True):
    """2-d affine sampling grid ``[N, H, W, 2]`` from ``theta`` ``[N, 2, 3]``."""
    h, w = out_shape[-2], out_shape[-1]

    def axis_coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, dtype=theta.dtype, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size, dtype=theta.dtype,
                              device=theta.device)

    gy, gx = torch.meshgrid(axis_coords(h), axis_coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nik->nhwi", base, theta)


def bilinear(x1, x2, weight, bias=None):
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    return out if bias is None else out + bias
