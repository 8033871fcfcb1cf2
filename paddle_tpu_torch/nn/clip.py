"""Gradient clipping: the port of ``paddle_tpu/nn/clip.py`` (reference:
python/paddle/fluid/clip.py, used by optimizers through ``grad_clip=...``).

Each clip is one function over the raw grad tensors (``_pure()``), with the
JAX ``_pure``'s formulas as torch ops. ``__call__(params_grads)`` applies it
to the grads of ``[(param, grad), ...]`` and keeps a None grad as None. The
eager ``Optimizer.step()`` and the compiled training step
(``paddle_tpu_torch.jit``) both call it between the backward and the update.
The ops read nothing back to the host, so a CUDA graph can capture them.

Not ported: the JAX module's ``capture_clip_fn`` / ``clip_fingerprint``,
which key the whole-step capture of ``core/lazy.py`` (ROADMAP, open items,
queue 1 item 9).
"""
from __future__ import annotations

import torch

__all__ = [
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

    @torch.no_grad()
    def __call__(self, params_grads):
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


GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
