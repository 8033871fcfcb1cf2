"""``paddle.nn.functional`` for the port: every function of
``paddle_tpu/nn/functional/__init__.py``, over the torch ops of
``ops/nn_ops.py``.

``scaled_dot_product_attention`` picks the lowering as
``paddle_tpu/nn/functional/__init__.py:677`` does: the flash path when
``FLAGS_use_flash_attention`` is on, there is no mask, no dropout and the
shape is eligible; the dense path otherwise. (The JAX selector also keeps
sharded meshes on the dense path; the port runs on one card.)

Each takes Paddle Tensors as well as torch tensors (``accepts_tensors``:
Tensors are unwrapped, results wrapped). Under ``amp.auto_cast`` O1, each
function casts its inputs by the O1 lists under the op name the JAX
function gives ``apply`` (``amp.maybe_cast_inputs``): ``linear``, the
convolutions, ``layer_norm``, ``batch_norm`` / ``batch_norm_infer``,
``group_norm``, ``softmax``, ``log_softmax``, ``softmax_with_cross_entropy``
and the attention routes.

``batch_norm`` in training writes the running statistics IN PLACE
(``copy_`` into the buffers), ``running = momentum * running + (1 -
momentum) * batch`` with the biased batch variance, as the JAX function
does by rebinding the buffers' values: a CUDA graph that captured the
update then accumulates the statistics on every replay.

Random functions (``dropout``, ``dropout2d`` / ``3d``, ``alpha_dropout``,
``gumbel_softmax``, ``class_center_sample``) draw from the port's generator
of the input's device (``core.random``).
"""
from __future__ import annotations

import numpy as np
import torch

from ... import amp as _amp
from ...core import flags as _flags
from ...core import random as _random
from ...core.dispatch import accepts_tensors, apply, is_grad_enabled  # noqa: F401
from ...core.dtype import to_torch_dtype
from ...core.tensor import Tensor, to_tensor  # noqa: F401
from ...ops import creation as _creation
from ...ops import manipulation as _mp
from ...ops import nn_ops as _nn


def _t(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _inplace(fn):
    """``fn``'s in-place form: a Paddle Tensor is rebound to the result (its
    identity kept, as the JAX cell is); a torch tensor is written through."""
    def inner(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        if isinstance(x, Tensor):
            return x._rebind(out._value)
        return x.copy_(out)

    inner.__name__ = fn.__name__ + "_"
    return inner


# ----------------------------- activations ---------------------------------
@accepts_tensors
def relu(x, name=None):
    return _nn.relu(x)


relu_ = _inplace(relu)


@accepts_tensors
def relu6(x, name=None):
    return _nn.relu6(x)


@accepts_tensors
def leaky_relu(x, negative_slope=0.01, name=None):
    return _nn.leaky_relu(x, negative_slope=negative_slope)


@accepts_tensors
def prelu(x, weight, data_format="NCHW", name=None):
    """A weight of more than one element is per channel (axis 1, or the last
    for channel-last formats)."""
    w = weight
    if w.numel() > 1 and x.dim() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format.startswith("NC") else x.dim() - 1] = w.numel()
        w = w.reshape(shape)
    return _nn.prelu(x, w)


@accepts_tensors
def elu(x, alpha=1.0, name=None):
    return _nn.elu(x, alpha=alpha)


@accepts_tensors
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _nn.selu(x, scale=scale, alpha=alpha)


@accepts_tensors
def celu(x, alpha=1.0, name=None):
    return _nn.celu(x, alpha=alpha)


@accepts_tensors
def gelu(x, approximate=False, name=None):
    return _nn.gelu(x, approximate=approximate)


@accepts_tensors
def sigmoid(x, name=None):
    return _nn.sigmoid(x)


@accepts_tensors
def silu(x, name=None):
    return _nn.silu(x)


@accepts_tensors
def swish(x, name=None):
    return _nn.swish(x)


@accepts_tensors
def mish(x, name=None):
    return _nn.mish(x)


@accepts_tensors
def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _nn.softplus(x, beta=beta, threshold=threshold)


@accepts_tensors
def softsign(x, name=None):
    return _nn.softsign(x)


@accepts_tensors
def softshrink(x, threshold=0.5, name=None):
    return _nn.softshrink(x, threshold=threshold)


@accepts_tensors
def hardshrink(x, threshold=0.5, name=None):
    return _nn.hardshrink(x, threshold=threshold)


@accepts_tensors
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _nn.hardtanh(x, min=min, max=max)


@accepts_tensors
def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5, name=None):
    return _nn.hardsigmoid(x, slope=slope, offset=offset)


@accepts_tensors
def hardswish(x, name=None):
    return _nn.hardswish(x)


@accepts_tensors
def tanhshrink(x, name=None):
    return _nn.tanhshrink(x)


@accepts_tensors
def thresholded_relu(x, threshold=1.0, name=None):
    return _nn.thresholded_relu(x, threshold=threshold)


@accepts_tensors
def log_sigmoid(x, name=None):
    return _nn.log_sigmoid(x)


@accepts_tensors
def maxout(x, groups, axis=1, name=None):
    return _nn.maxout(x, groups=groups, axis=axis)


@accepts_tensors
def glu(x, axis=-1, name=None):
    return _nn.glu(x, axis=axis)


@accepts_tensors
def tanh(x, name=None):
    return torch.tanh(x)


@accepts_tensors
def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _amp.maybe_cast_inputs("softmax", (x,))
    out = _nn.softmax(x, axis=axis)
    return out if dtype is None else out.to(to_torch_dtype(dtype))


@accepts_tensors
def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _amp.maybe_cast_inputs("log_softmax", (x,))
    out = _nn.log_softmax(x, axis=axis)
    return out if dtype is None else out.to(to_torch_dtype(dtype))


@accepts_tensors
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    return _nn.gumbel_softmax(x, _random.generator(x.device), temperature=temperature,
                              hard=hard, axis=axis)


elu_ = _inplace(elu)
tanh_ = _inplace(tanh)
softmax_ = _inplace(softmax)


# ----------------------------- linear/conv ----------------------------------
@accepts_tensors
def linear(x, weight, bias=None, name=None):
    x, weight, bias = _amp.maybe_cast_inputs("linear", (x, weight, bias))
    return _nn.linear(x, weight, bias)


@accepts_tensors
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    x, weight, bias = _amp.maybe_cast_inputs("conv1d", (x, weight, bias))
    return _nn.conv1d(x, weight, bias, stride=_t(stride), padding=_t(padding),
                      dilation=_t(dilation), groups=groups, data_format=data_format)


@accepts_tensors
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    x, weight, bias = _amp.maybe_cast_inputs("conv2d", (x, weight, bias))
    return _nn.conv2d(x, weight, bias, stride=_t(stride), padding=_t(padding),
                      dilation=_t(dilation), groups=groups, data_format=data_format)


@accepts_tensors
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    x, weight, bias = _amp.maybe_cast_inputs("conv3d", (x, weight, bias))
    return _nn.conv3d(x, weight, bias, stride=_t(stride), padding=_t(padding),
                      dilation=_t(dilation), groups=groups, data_format=data_format)


def _transpose_out_padding(output_size, in_spatial, k, stride, padding, dilation,
                           output_padding, nd):
    """The ``output_padding`` that gives ``output_size``: out = (in - 1) s -
    2 p + d (k - 1) + 1 + output_padding, with 0 <= output_padding < max(s, d)."""
    def tup(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd

    if output_size is None:
        return _t(output_padding)
    if isinstance(output_size, torch.Tensor):
        output_size = [int(v) for v in output_size.tolist()]
    want = tuple(int(v) for v in output_size)[-nd:]
    s, p, d = tup(stride), tup(padding), tup(dilation)
    out_pad = []
    for i in range(nd):
        base = (in_spatial[i] - 1) * s[i] - 2 * p[i] + d[i] * (k[i] - 1) + 1
        extra = want[i] - base
        if not (0 <= extra < max(s[i], d[i], 1)):
            raise ValueError(
                f"output_size {want} unreachable from input spatial "
                f"{tuple(in_spatial)} (base {base}, stride {s[i]})"
            )
        out_pad.append(extra)
    return tuple(out_pad)


@accepts_tensors
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, data_format="NCHW", output_size=None, name=None):
    if output_size is not None:
        spatial = tuple(x.shape[2:4]) if data_format == "NCHW" else tuple(x.shape[1:3])
        output_padding = _transpose_out_padding(
            output_size, spatial, tuple(weight.shape[-2:]), stride, padding, dilation,
            output_padding, 2)
    x, weight, bias = _amp.maybe_cast_inputs("conv2d_transpose", (x, weight, bias))
    return _nn.conv2d_transpose(x, weight, bias, stride=_t(stride), padding=_t(padding),
                                output_padding=_t(output_padding), dilation=_t(dilation),
                                groups=groups, data_format=data_format)


@accepts_tensors
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCL", name=None):
    if output_size is not None:
        output_padding = _transpose_out_padding(
            output_size, (x.shape[2] if data_format == "NCL" else x.shape[1],),
            (weight.shape[-1],), stride, padding, dilation, output_padding, 1)
    return _nn.conv1d_transpose(x, weight, bias, stride=_t(stride), padding=_t(padding),
                                output_padding=_t(output_padding), dilation=_t(dilation),
                                groups=groups, data_format=data_format)


@accepts_tensors
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCDHW", name=None):
    if output_size is not None:
        spatial = tuple(x.shape[2:5]) if data_format == "NCDHW" else tuple(x.shape[1:4])
        output_padding = _transpose_out_padding(
            output_size, spatial, tuple(weight.shape[-3:]), stride, padding, dilation,
            output_padding, 3)
    return _nn.conv3d_transpose(x, weight, bias, stride=_t(stride), padding=_t(padding),
                                output_padding=_t(output_padding), dilation=_t(dilation),
                                groups=groups, data_format=data_format)


# ----------------------------- pooling --------------------------------------
@accepts_tensors
def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False, name=None):
    return _nn.max_pool1d(x, kernel_size=_t(kernel_size), stride=_t(stride),
                          padding=_t(padding), ceil_mode=ceil_mode)


@accepts_tensors
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, return_mask=False,
               data_format="NCHW", name=None):
    if return_mask:
        if data_format != "NCHW":
            raise ValueError("return_mask requires NCHW (reference kernel layout)")
        return _nn.max_pool2d_with_index(x, kernel_size=_t(kernel_size), stride=_t(stride),
                                         padding=_t(padding), ceil_mode=ceil_mode)
    return _nn.max_pool2d(x, kernel_size=_t(kernel_size), stride=_t(stride),
                          padding=_t(padding), ceil_mode=ceil_mode, data_format=data_format)


@accepts_tensors
def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, return_mask=False,
               data_format="NCDHW", name=None):
    if return_mask:
        raise NotImplementedError(
            "max_pool3d(return_mask=True): 3-D argmax masks are not "
            "implemented; use max_pool2d(return_mask=True) per-slice"
        )
    return _nn.max_pool3d(x, kernel_size=_t(kernel_size), stride=_t(stride),
                          padding=_t(padding), ceil_mode=ceil_mode, data_format=data_format)


@accepts_tensors
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
               name=None):
    return _nn.avg_pool1d(x, kernel_size=_t(kernel_size), stride=_t(stride),
                          padding=_t(padding), ceil_mode=ceil_mode, exclusive=exclusive)


@accepts_tensors
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    return _nn.avg_pool2d(x, kernel_size=_t(kernel_size), stride=_t(stride),
                          padding=_t(padding), ceil_mode=ceil_mode, exclusive=exclusive,
                          divisor_override=divisor_override, data_format=data_format)


@accepts_tensors
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW", name=None):
    return _nn.avg_pool3d(x, kernel_size=_t(kernel_size), stride=_t(stride),
                          padding=_t(padding), ceil_mode=ceil_mode, exclusive=exclusive,
                          divisor_override=divisor_override, data_format=data_format)


@accepts_tensors
def adaptive_avg_pool1d(x, output_size, name=None):
    return _nn.adaptive_avg_pool1d(x, output_size=output_size)


@accepts_tensors
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _nn.adaptive_avg_pool2d(x, output_size=_t(output_size), data_format=data_format)


@accepts_tensors
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _nn.adaptive_avg_pool3d(x, output_size=_t(output_size), data_format=data_format)


def _no_mask(return_mask, name):
    if return_mask:
        raise NotImplementedError(f"{name}(return_mask=True)")


@accepts_tensors
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool1d")
    return _nn.adaptive_max_pool1d(x, output_size=_t(output_size))


@accepts_tensors
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool2d")
    return _nn.adaptive_max_pool2d(x, output_size=_t(output_size))


@accepts_tensors
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool3d")
    return _nn.adaptive_max_pool3d(x, output_size=_t(output_size))


def _output_size(output_size):
    return None if output_size is None else tuple(output_size)


@accepts_tensors
def max_unpool1d(x, indices, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCL", name=None):
    if data_format != "NCL":
        raise ValueError(f"max_unpool1d supports NCL only (reference unpool kernel "
                         f"layout), got {data_format}")
    return _nn.max_unpool1d(x, indices, kernel_size=_t(kernel_size), stride=_t(stride),
                            padding=_t(padding), output_size=_output_size(output_size))


@accepts_tensors
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None, name=None):
    if data_format != "NCHW":
        raise ValueError("max_unpool2d requires NCHW")
    return _nn.max_unpool2d(x, indices, kernel_size=_t(kernel_size), stride=_t(stride),
                            padding=_t(padding), output_size=_output_size(output_size))


@accepts_tensors
def max_unpool3d(x, indices, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCDHW", name=None):
    if data_format != "NCDHW":
        raise ValueError(f"max_unpool3d supports NCDHW only (reference unpool kernel "
                         f"layout), got {data_format}")
    return _nn.max_unpool3d(x, indices, kernel_size=_t(kernel_size), stride=_t(stride),
                            padding=_t(padding), output_size=_output_size(output_size))


# ----------------------------- norm ------------------------------------------
@accepts_tensors
def batch_norm(x, running_mean, running_var, weight, bias, training=False, momentum=0.9,
               epsilon=1e-05, data_format="NCHW", use_global_stats=None, name=None):
    """Batch statistics in training (and the running statistics updated in
    place), the running statistics otherwise or under ``use_global_stats``."""
    if use_global_stats is None:
        use_global_stats = not training
    if use_global_stats:
        x, running_mean, running_var, weight, bias = _amp.maybe_cast_inputs(
            "batch_norm_infer", (x, running_mean, running_var, weight, bias))
        return _nn.batch_norm_infer(x, running_mean, running_var, weight, bias,
                                    epsilon=epsilon, data_format=data_format)
    x, weight, bias = _amp.maybe_cast_inputs("batch_norm", (x, weight, bias))
    out, batch_mean, batch_var = _nn.batch_norm_train(x, weight, bias, epsilon=epsilon,
                                                      data_format=data_format)
    if isinstance(running_mean, torch.Tensor):
        with torch.no_grad():
            for running, batch in ((running_mean, batch_mean), (running_var, batch_var)):
                batch = batch.to(running.dtype)
                running.copy_(running * momentum + batch * (1 - momentum))
    return out


@accepts_tensors
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05, name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    begin = x.dim() - len(normalized_shape)
    x, weight, bias = _amp.maybe_cast_inputs("layer_norm", (x, weight, bias))
    return _nn.layer_norm(x, weight, bias, epsilon=epsilon, begin_norm_axis=begin)


@accepts_tensors
def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None, data_format="NCHW",
               name=None):
    x, weight, bias = _amp.maybe_cast_inputs("group_norm", (x, weight, bias))
    return _nn.group_norm(x, weight, bias, num_groups=num_groups, epsilon=epsilon,
                          data_format=data_format)


@accepts_tensors
def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-05, data_format="NCHW",
                  name=None):
    """Per-sample statistics over the spatial axes (the running statistics
    are neither read nor written, as in the JAX function)."""
    if weight is None:
        return _nn.instance_norm(x, epsilon=eps)
    return _nn.instance_norm(x, weight, bias, epsilon=eps)


@accepts_tensors
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return _nn.normalize(x, p=float(p), axis=axis, epsilon=epsilon)


@accepts_tensors
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                        name=None):
    return _nn.local_response_norm(x, size=size, alpha=alpha, beta=beta, k=k)


# ----------------------------- dropout ---------------------------------------
@accepts_tensors
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    """``axis``: the mask varies only along those axes and is broadcast
    along the rest."""
    if not training or p == 0.0:
        # downscale_in_infer scales at inference (out = x * (1 - p)) and
        # masks without rescaling in training
        if mode == "downscale_in_infer" and p > 0.0:
            return x * (1.0 - p)
        return x
    mask_shape = None
    if axis is not None:
        axes = {a % x.dim() for a in ([axis] if isinstance(axis, int) else axis)}
        mask_shape = tuple(int(d) if i in axes else 1 for i, d in enumerate(x.shape))
    return _nn.dropout(x, _random.generator(x.device), p=float(p), mode=mode,
                       mask_shape=mask_shape)


def _channel_dropout(x, p, training, channel_last):
    if not training or p == 0.0:
        return x
    shape = [1] * x.dim()
    shape[0] = x.shape[0]
    shape[-1 if channel_last else 1] = x.shape[-1 if channel_last else 1]
    return _nn.dropout(x, _random.generator(x.device), p=float(p), mask_shape=tuple(shape))


@accepts_tensors
def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Drop whole channels: one keep draw per (sample, channel)."""
    return _channel_dropout(x, p, training, data_format != "NCHW")


@accepts_tensors
def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Drop whole 3-D channel volumes."""
    return _channel_dropout(x, p, training, data_format != "NCDHW")


@accepts_tensors
def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped units take SELU's negative
    saturation, then an affine map restores the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    neg = -alpha * scale
    keep = torch.rand(x.shape, generator=_random.generator(x.device), device=x.device) \
        < (1.0 - p)
    a = 1.0 / (scale * ((1 - p) * (1 + p * alpha ** 2)) ** 0.5)
    b = -a * neg * p
    return a * torch.where(keep, x, torch.full((), neg, dtype=x.dtype, device=x.device)) + b


# ----------------------------- losses ----------------------------------------
def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@accepts_tensors
def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy (``paddle_tpu/nn/functional/__init__.py:440``):
    hard or soft labels, ``label_smoothing`` (hard labels become smoothed
    one-hot rows), a class ``weight`` (the mean divides by the weights of
    the labels not ignored), ``use_softmax=False`` (``input`` holds
    probabilities). The mean or sum is folded into the one loss op when no
    weight and no count of valid labels is needed."""
    if label_smoothing > 0.0:
        num = input.shape[axis]
        if not soft_label:
            label = _creation.one_hot(label, num_classes=num)
            soft_label = True
        label = label * (1.0 - label_smoothing) + label_smoothing / num
    # mean with a real ignore_index divides by the VALID count
    mean_needs_valid_count = reduction == "mean" and ignore_index != -100 and not soft_label
    if not use_softmax:
        loss = nll_from_logprob(torch.log(torch.clamp(input, min=1e-12)), label, soft_label,
                                ignore_index, axis)
    else:
        input, label = _amp.maybe_cast_inputs("softmax_with_cross_entropy", (input, label))
        if weight is None and reduction in ("mean", "sum") and not mean_needs_valid_count:
            return _nn.softmax_with_cross_entropy(input, label, soft_label=soft_label,
                                                  ignore_index=ignore_index, axis=axis,
                                                  reduction=reduction)
        loss = _nn.softmax_with_cross_entropy(input, label, soft_label=soft_label,
                                              ignore_index=ignore_index, axis=axis)
    if loss.dim() > max(input.dim() - 1, 1):
        loss = loss.squeeze(axis)
    if weight is not None and not soft_label:
        w = weight[label.clamp(min=0).long()]
        # ignored positions contribute neither loss nor denominator
        w = torch.where(label != ignore_index, w, torch.zeros((), dtype=w.dtype,
                                                              device=w.device))
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp(min=1e-12)
    if mean_needs_valid_count:
        valid = (label != ignore_index).to(loss.dtype)
        return loss.sum() / valid.sum().clamp(min=1.0)
    return _reduce(loss, reduction)


@accepts_tensors
def nll_from_logprob(logp, label, soft_label, ignore_index, axis):
    if soft_label:
        return -torch.sum(label * logp, dim=axis)
    picked = torch.gather(logp, axis, label.clamp(min=0).long().unsqueeze(axis)).squeeze(axis)
    return torch.where(label != ignore_index, -picked, torch.zeros((), dtype=logp.dtype,
                                                                   device=logp.device))


@accepts_tensors
def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    logits, label = _amp.maybe_cast_inputs("softmax_with_cross_entropy", (logits, label))
    loss = _nn.softmax_with_cross_entropy(logits, label, soft_label=soft_label,
                                          ignore_index=ignore_index, axis=axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


@accepts_tensors
def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(_nn.mse_loss(input, label), reduction)


@accepts_tensors
def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(_nn.l1_loss(input, label), reduction)


@accepts_tensors
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return _reduce(_nn.smooth_l1_loss(input, label, delta=delta), reduction)


@accepts_tensors
def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):
    loss = _nn.bce_loss(input, label)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@accepts_tensors
def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean",
                                     pos_weight=None, name=None):
    loss = _nn.bce_with_logits(logit, label, pos_weight)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@accepts_tensors
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean", name=None):
    return _reduce(_nn.nll_loss(input, label, weight, ignore_index=ignore_index), reduction)


@accepts_tensors
def kl_div(input, label, reduction="mean", name=None):
    loss = _nn.kl_div(input, label)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@accepts_tensors
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):
    return _reduce(_nn.margin_ranking_loss(input, other, label, margin=margin), reduction)


@accepts_tensors
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean", name=None):
    return _reduce(_nn.hinge_embedding_loss(input, label, margin=margin), reduction)


@accepts_tensors
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return _nn.cosine_similarity(x1, x2, axis=axis, eps=eps)


@accepts_tensors
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0, reduction="sum",
                       name=None):
    p = torch.sigmoid(logit)
    ce = _nn.bce_with_logits(logit, label)
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@accepts_tensors
def square_error_cost(input, label):
    return _nn.square_error_cost(input, label)


@accepts_tensors
def log_loss(input, label, epsilon=1e-4, name=None):
    return _nn.log_loss(input, label, epsilon=float(epsilon))


@accepts_tensors
def dice_loss(input, label, epsilon=1e-5, name=None):
    return _nn.dice_loss(input, label, epsilon=float(epsilon))


@accepts_tensors
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    return _nn.npair_loss(anchor, positive, labels, l2_reg=float(l2_reg))


@accepts_tensors
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0, reduction="mean",
             norm_by_times=False):
    """CTC over ``[T, B, C]`` logits (log-softmaxed here, as warpctc
    softmaxes internally); the mean divides each sample by its label length
    first."""
    lp = log_softmax(log_probs, axis=-1)
    loss = _nn.ctc_loss_per_sample(lp, labels, input_lengths, label_lengths, blank=int(blank))
    if norm_by_times:
        loss = loss / input_lengths.to(loss.dtype)
    if reduction == "mean":
        return (loss / label_lengths.to(loss.dtype).clamp(min=1.0)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@accepts_tensors
def hsigmoid_loss(input, label, num_classes, weight, bias=None, path_table=None,
                  path_code=None, is_sparse=False, name=None):
    return _nn.hsigmoid_loss_op(input, label, weight, bias, path_table, path_code,
                                num_classes=int(num_classes))


@accepts_tensors
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0, scale=64.0,
                         group=None, return_softmax=False, reduction="mean"):
    loss, sm = _nn.margin_cross_entropy_op(logits, label, margin1=float(margin1),
                                           margin2=float(margin2), margin3=float(margin3),
                                           scale=float(scale))
    loss = _reduce(loss, reduction)
    return (loss, sm) if return_softmax else loss


@accepts_tensors
def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    if key_padding_mask is not None or attn_mask is not None:
        raise NotImplementedError("sparse_attention masks beyond the CSR pattern")
    return _nn.sparse_attention_op(query, key, value, sparse_csr_offset, sparse_csr_columns)


@accepts_tensors
def class_center_sample(label, num_classes, num_samples, group=None):
    """Keep every positive class and fill up to ``num_samples`` with negatives
    drawn from the port's generator; labels remapped into the sampled
    index space. Returns ``(remapped_label, sampled_class_index)``."""
    lab = label.detach().cpu().numpy().reshape(-1)
    pos = np.unique(lab)
    rest = num_samples - len(pos)
    if rest > 0:
        neg_pool = np.setdiff1d(np.arange(num_classes), pos)
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=_random.generator(label.device),
                                 device=label.device))
        rng = np.random.default_rng(seed)
        sampled = np.concatenate([pos, rng.permutation(neg_pool)[:rest]])
    else:
        sampled = pos
    remap = np.full(num_classes, -1, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return (torch.as_tensor(remap[lab], device=label.device),
            torch.as_tensor(sampled.astype(np.int64), device=label.device))


# ----------------------------- embedding / inputs ----------------------------
@accepts_tensors
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    return _nn.embedding(x, weight, padding_idx=padding_idx)


@accepts_tensors
def one_hot(x, num_classes, name=None):
    return _creation.one_hot(x, num_classes=num_classes)


@accepts_tensors
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return _nn.label_smooth(label, epsilon=epsilon)


# ----------------------------- shape / vision --------------------------------
@accepts_tensors
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    return _mp.pad(x, pad=tuple(int(p) for p in pad), mode=mode, value=value,
                   data_format=data_format)


@accepts_tensors
def zeropad2d(x, padding, data_format="NCHW", name=None):
    return _mp.pad(x, pad=tuple(int(p) for p in padding), mode="constant", value=0.0,
                   data_format=data_format)


@accepts_tensors
def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
                align_mode=0, data_format="NCHW", name=None):
    return _nn.interpolate(x, size=None if size is None else tuple(int(s) for s in size),
                           scale_factor=_t(scale_factor), mode=mode,
                           align_corners=align_corners, data_format=data_format)


def upsample(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
             align_mode=0, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode, data_format)


@accepts_tensors
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return _nn.pixel_shuffle(x, upscale_factor=upscale_factor, data_format=data_format)


@accepts_tensors
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return _nn.pixel_unshuffle(x, downscale_factor=int(downscale_factor),
                               data_format=data_format)


@accepts_tensors
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True, name=None):
    return _nn.grid_sample(x, grid, mode=mode, padding_mode=padding_mode,
                           align_corners=align_corners)


@accepts_tensors
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return _mp.unfold(x, kernel_sizes=_t(kernel_sizes), strides=_t(strides),
                      paddings=_t(paddings), dilations=_t(dilations))


@accepts_tensors
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return _nn.fold(x, output_sizes=_t(output_sizes), kernel_sizes=_t(kernel_sizes),
                    strides=_t(strides), paddings=_t(paddings), dilations=_t(dilations))


@accepts_tensors
def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return _mp.diag_embed(x, offset=offset, dim1=dim1, dim2=dim2)


@accepts_tensors
def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None:
        maxlen = int(x.max())
    with torch.no_grad():
        return _nn.sequence_mask(x, maxlen=int(maxlen), dtype=to_torch_dtype(dtype))


@accepts_tensors
def gather_tree(ids, parents):
    with torch.no_grad():
        return _nn.gather_tree(ids, parents)


@accepts_tensors
def temporal_shift(x, seg_num, shift_ratio=0.25, name=None, data_format="NCHW"):
    return _nn.temporal_shift(x, seg_num=int(seg_num), shift_ratio=float(shift_ratio),
                              data_format=data_format)


@accepts_tensors
def affine_grid(theta, out_shape, align_corners=True, name=None):
    if isinstance(out_shape, torch.Tensor):
        out_shape = [int(v) for v in out_shape.tolist()]
    return _nn.affine_grid(theta, out_shape=tuple(int(v) for v in out_shape),
                           align_corners=align_corners)


@accepts_tensors
def bilinear(x1, x2, weight, bias=None, name=None):
    return _nn.bilinear(x1, x2, weight, bias)


# ----------------------------- attention -------------------------------------
@accepts_tensors
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


__all__ = [n for n in dir() if not n.startswith("_")]
