"""DGC — Deep Gradient Compression momentum optimizer
(``paddle_tpu/distributed/fleet/dgc.py``).

Reference analogue: fleet/meta_optimizers/dgc_optimizer.py over the dgc_op
CUDA kernels: momentum correction and residual accumulation locally, top-k
sparsification with momentum-factor masking, and an exchange of only the
selected (index, value) pairs. Here the local math is torch's; the exchange
all-gathers one packet per step over the data-parallel group (the world
when no topology is installed): every parameter's indices and values, then
the dense residuals of the warm-up steps, and scatter-adds them into dense
synchronised updates. Every rank applies the same aggregate, so the
replicas stay equal. An eager multi-process meta-optimizer.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .localsgd import data_group

__all__ = ["DGCMomentumOptimizer"]


def _topk_sparsify(v, k):
    """The top-k |v| entries: (idx [k], vals [k], v with them zeroed)."""
    flat = v.reshape(-1)
    idx = torch.topk(flat.abs(), k, sorted=True).indices
    vals = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return idx, vals, residual.reshape(v.shape)


class DGCMomentumOptimizer:
    """Momentum SGD with top-k compressed gradient synchronisation.

    ``sparsity`` is a ramp-up schedule of DROP fractions; each stage lasts
    ``rampup_step`` steps after ``rampup_begin_step`` dense steps. A bare
    float is a one-stage schedule."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 rampup_begin_step: int = 0, rampup_step: int = 1,
                 sparsity: Union[float, Sequence[float]] = (0.999,),
                 parameters=None, grad_clip=None, weight_decay=None, name=None):
        self._lr = learning_rate
        self._learning_rate = learning_rate
        self._mu = momentum
        self._parameters = list(parameters or [])
        self._sched = [float(s) for s in (
            [sparsity] if isinstance(sparsity, (int, float)) else sparsity)]
        if not all(0.0 <= s < 1.0 for s in self._sched):
            raise ValueError("sparsity entries are DROP fractions in [0, 1)")
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))
        self._grad_clip = grad_clip
        self._wd = (
            float(weight_decay) if isinstance(weight_decay, (int, float))
            else getattr(weight_decay, "_coeff", None) if weight_decay is not None
            else None
        )
        self._count = 0
        self._u = {}
        self._v = {}

    def _drop_ratio(self) -> Optional[float]:
        """None during the dense warm-up; else the scheduled drop fraction."""
        if self._count <= self._rampup_begin:
            return None
        stage = (self._count - self._rampup_begin - 1) // self._rampup_step
        return self._sched[min(stage, len(self._sched) - 1)]

    def _lr_value(self):
        return float(self._lr() if callable(self._lr) else self._lr)

    def _param_list(self):
        return self._parameters

    def clear_grad(self, set_to_zero=False):
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    @torch.no_grad()
    def step(self):
        self._count += 1
        params_grads = [(p, p.grad) for p in self._parameters
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self._lr_value()
        group = data_group()
        world = group.nranks
        drop = self._drop_ratio()
        sparse, dense = [], []
        for p, g in params_grads:
            gv = g.float()
            if self._wd:
                gv = gv + self._wd * p.float()
            u = self._u.get(id(p))
            v = self._v.get(id(p))
            if u is None:
                u = torch.zeros_like(gv)
                v = torch.zeros_like(gv)
            # momentum correction, then residual accumulation (DGC eq. 4)
            u = self._mu * u + gv
            v = v + u
            if drop is None or gv.numel() < 2:
                dense.append((p, v))
                v = torch.zeros_like(v)
            else:
                k = max(1, gv.numel() - int(drop * gv.numel()))
                idx, vals, v = _topk_sparsify(v, k)
                # momentum-factor masking: the sent coordinates forget their history
                u = u.reshape(-1).index_fill(0, idx, 0.0).reshape(u.shape)
                sparse.append((p, idx, vals))
            self._u[id(p)] = u
            self._v[id(p)] = v
        if world > 1 and (sparse or dense):
            from .. import collective as C

            packet = ([(idx.cpu(), vals.cpu()) for _, idx, vals in sparse],
                      [v.cpu() for _, v in dense])
            got = C.all_gather_object([], packet, group)
            g_sparse = [[r[0][i] for r in got] for i in range(len(sparse))]
            g_dense = [[r[1][i] for r in got] for i in range(len(dense))]
        else:
            g_sparse = [[(idx, vals)] for _, idx, vals in sparse]
            g_dense = [[v] for _, v in dense]
        for (p, _, _), parts in zip(sparse, g_sparse):
            agg = torch.zeros(p.numel(), dtype=torch.float32, device=p.device)
            for idx, vals in parts:
                agg.index_add_(0, idx.to(p.device), vals.to(p.device))
            agg = agg / max(world, 1)
            p.sub_(lr * agg.reshape(p.shape).to(p.dtype))
        for (p, _), parts in zip(dense, g_dense):
            sync = torch.stack([v.to(p.device) for v in parts]).mean(0)
            p.sub_(lr * sync.to(p.dtype))

    def state_dict(self):
        """The u / v accumulators and the step count, keyed by parameter
        position."""
        out = {"count": self._count}
        for i, p in enumerate(self._parameters):
            if id(p) in self._u:
                out[f"u_{i}"] = self._u[id(p)].clone()
                out[f"v_{i}"] = self._v[id(p)].clone()
        return out

    def set_state_dict(self, state):
        self._count = int(state.get("count", 0))
        for i, p in enumerate(self._parameters):
            if f"u_{i}" in state:
                self._u[id(p)] = torch.as_tensor(state[f"u_{i}"]).to(p.device)
                self._v[id(p)] = torch.as_tensor(state[f"v_{i}"]).to(p.device)

    def get_lr(self):
        return self._lr_value()
