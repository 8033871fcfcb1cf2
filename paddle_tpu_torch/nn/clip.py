"""Gradient clipping: the port of ``paddle_tpu/nn/clip.py`` (reference:
python/paddle/fluid/clip.py, used by optimizers through ``grad_clip=...``).

Each clip is one function over the raw grad tensors (``_pure()``), with the
JAX ``_pure``'s formulas as torch ops. ``__call__(params_grads)`` (through
``_clip``) applies it to the grads of ``[(param, grad), ...]`` and keeps a
None grad as None. The eager ``Optimizer.step()``, the compiled training
step (``paddle_tpu_torch.jit``) and the captured step of ``core/lazy.py``
call it between the backward and the update. The ops read nothing back to
the host, so a CUDA graph captures them.

``clip_fingerprint()`` is the capture controller's hashable identity of a
clip config, part of the step signature; ``capture_clip_fn()`` the pure
clip function of a stock clip. A clip of another class (a subclass
overriding ``_clip``) has semantics the capture cannot vouch for: its
fingerprint is None and such a step is never armed for capture.
"""
from __future__ import annotations

import torch

__all__ = [
    "capture_clip_fn",
    "clip_fingerprint",
    "ClipGradBase",
    "ClipGradByValue",
    "ClipGradByNorm",
    "ClipGradByGlobalNorm",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
]


class ClipGradBase:
    def _pure(self):
        """``list[grad tensors] -> list[clipped tensors]``."""
        raise NotImplementedError

    def _fingerprint(self):
        raise NotImplementedError

    @torch.no_grad()
    def __call__(self, params_grads):
        return self._clip(params_grads)

    def _clip(self, params_grads):
        clipped = iter(self._pure()([g for _, g in params_grads if g is not None]))
        return [(p, None if g is None else next(clipped)) for p, g in params_grads]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _pure(self):
        lo, hi = self.min, self.max

        def fn(g_vals):
            return [torch.clamp(g, lo, hi) for g in g_vals]

        return fn

    def _fingerprint(self):
        return ("value", self.min, self.max)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _pure(self):
        clip_norm = self.clip_norm

        def fn(g_vals):
            out = []
            for g in g_vals:
                norm = torch.sqrt(torch.sum(torch.square(g)))
                # clip_norm / norm as a true division (a Python scalar over a
                # tensor would multiply by the reciprocal)
                scale = torch.where(norm > clip_norm, norm.new_full((), clip_norm) / norm,
                                    torch.ones_like(norm))
                out.append(g * scale)
            return out

        return fn

    def _fingerprint(self):
        return ("norm", self.clip_norm)


class ClipGradByGlobalNorm(ClipGradBase):
    """reference: fluid/clip.py ClipGradByGlobalNorm. The norm is taken in
    f32 over every grad; each clipped grad keeps its dtype."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def _pure(self):
        clip_norm = self.clip_norm

        def fn(g_vals):
            sq = [torch.sum(torch.square(g.float())) for g in g_vals]
            if not sq:
                return []
            global_norm = torch.sqrt(sum(sq))
            scale = global_norm.new_full((), clip_norm) / torch.clamp(global_norm, min=clip_norm)
            # the product in f32, as the JAX clip promotes a 16-bit grad
            # times the f32 scale, then rounded to the grad's dtype
            return [(g.float() * scale).to(g.dtype) for g in g_vals]

        return fn

    def _fingerprint(self):
        return ("global_norm", self.clip_norm)


_BUILTIN_CLIPS = (ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm)


def _is_builtin(clip) -> bool:
    # the exact class AND the stock _clip: a subclass has semantics the pure
    # form does not cover
    return type(clip) in _BUILTIN_CLIPS and type(clip)._clip is ClipGradBase._clip


def capture_clip_fn(clip):
    """The pure clip function of a stock clip config, or None."""
    if clip is None or not _is_builtin(clip):
        return None
    return clip._pure()


def clip_fingerprint(clip):
    """``("none",)`` for no clip, ``(tag, hypers...)`` for the three stock
    clips, None for any other (its step is never armed for capture)."""
    if clip is None:
        return ("none",)
    if not _is_builtin(clip):
        return None
    return clip._fingerprint()


GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
