"""Neural-network ops on torch tensors: the subset of ``paddle_tpu/ops/nn_ops.py``
that the GPT and BERT inference and training paths run.

Each function keeps the JAX function's layout (weights ``[in, out]``,
attention over ``[batch, seq, heads, head_dim]``) and its operation order,
so the two packages compute the same thing step by step. Where a JAX op
promotes operands of two float types (``linear``'s product, dense
attention's P·V), the port casts them to the common type first
(``promoted``): ``torch.matmul`` and ``torch.einsum`` refuse mixed types.
"""
from __future__ import annotations

import functools
import math

import torch

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


def dropout(x, generator, *, p=0.5, mode="upscale_in_train"):
    """``generator`` draws the keep mask (the JAX op takes a key)."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - p)
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
