"""``paddle.nn.functional`` for the port: the functions the GPT path calls,
in inference and in training (``cross_entropy``).

``scaled_dot_product_attention`` picks the lowering as
``paddle_tpu/nn/functional/__init__.py:677`` does: the flash path when
``FLAGS_use_flash_attention`` is on, there is no mask, no dropout and the
shape is eligible; the dense path otherwise. (The JAX selector also keeps
sharded meshes on the dense path; the port runs on one card.)

Under ``amp.auto_cast`` O1, each function casts its inputs by the O1 lists
under the op name the JAX function gives ``apply`` (``amp.maybe_cast_inputs``).
"""
from __future__ import annotations

from ... import amp as _amp
from ...core import flags as _flags
from ...core import random as _random
from ...ops import nn_ops as _nn


def linear(x, weight, bias=None, name=None):
    x, weight, bias = _amp.maybe_cast_inputs("linear", (x, weight, bias))
    return _nn.linear(x, weight, bias)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05, name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    begin = x.dim() - len(normalized_shape)
    x, weight, bias = _amp.maybe_cast_inputs("layer_norm", (x, weight, bias))
    return _nn.layer_norm(x, weight, bias, epsilon=epsilon, begin_norm_axis=begin)


def gelu(x, approximate=False, name=None):
    return _nn.gelu(x, approximate=approximate)


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _amp.maybe_cast_inputs("softmax", (x,))
    out = _nn.softmax(x, axis=axis)
    return out if dtype is None else out.to(dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    return _nn.embedding(x, weight, padding_idx=padding_idx)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    if axis is not None:
        raise NotImplementedError("dropout with an axis is not ported yet")
    if not training or p == 0.0:
        # downscale_in_infer scales at inference (out = x * (1 - p)) and
        # masks without rescaling in training
        if mode == "downscale_in_infer" and p > 0.0:
            return x * (1.0 - p)
        return x
    return _nn.dropout(x, _random.generator(x.device), p=p, mode=mode)


def scaled_dot_product_attention(
    query, key, value, attn_mask=None, dropout_p=0.0, is_causal=False,
    training=True, name=None,
):
    dropout_gen = (
        _random.generator(query.device) if (dropout_p > 0.0 and training) else None
    )
    if (
        _flags.flag("use_flash_attention")
        and attn_mask is None
        and dropout_gen is None
        and _nn.flash_attention_eligible(query.shape, key.shape, value.shape)
    ):
        query, key, value = _amp.maybe_cast_inputs("flash_sdpa", (query, key, value))
        return _nn.flash_scaled_dot_product_attention(
            query, key, value, is_causal=is_causal
        )
    query, key, value, attn_mask = _amp.maybe_cast_inputs("sdpa", (query, key, value, attn_mask))
    return _nn.scaled_dot_product_attention(
        query, key, value, attn_mask, dropout_gen, is_causal=is_causal,
        dropout_p=dropout_p,
    )


def cross_entropy(
    input, label, weight=None, ignore_index=-100, reduction="mean",
    soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0, name=None,
):
    """Softmax cross-entropy over hard labels (``paddle_tpu/nn/functional/__init__.py:440``).

    The mean or sum is folded into the one loss op unless the mean must
    divide by the count of labels that are not ``ignore_index``. The other
    branches of the JAX function are not ported yet and raise."""
    for unported, what in (
        (label_smoothing > 0.0, "label_smoothing"),
        (weight is not None, "a class weight"),
        (not use_softmax, "use_softmax=False"),
        (soft_label, "soft labels"),
    ):
        if unported:
            raise NotImplementedError(
                f"cross_entropy with {what} is not ported yet (ROADMAP, open "
                "items, queue 1 item 4: the loss layers)"
            )
    input, label = _amp.maybe_cast_inputs("softmax_with_cross_entropy", (input, label))
    # mean with a real ignore_index divides by the VALID count
    mean_needs_valid_count = reduction == "mean" and ignore_index != -100
    if reduction in ("mean", "sum") and not mean_needs_valid_count:
        return _nn.softmax_with_cross_entropy(
            input, label, ignore_index=ignore_index, axis=axis, reduction=reduction
        )
    loss = _nn.softmax_with_cross_entropy(input, label, ignore_index=ignore_index, axis=axis)
    if loss.dim() > max(input.dim() - 1, 1):
        loss = loss.squeeze(axis)
    if mean_needs_valid_count:
        valid = (label != ignore_index).to(loss.dtype)
        return loss.sum() / valid.sum().clamp(min=1.0)
    return loss  # reduction "none": a mean or sum was folded into the op above
