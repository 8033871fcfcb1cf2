"""LocalSGD — train locally, average the parameters every k steps
(``paddle_tpu/distributed/fleet/localsgd.py``).

Reference analogue: fleet/meta_optimizers/localsgd_optimizer.py. Each rank
steps its own replica on its own data; the parameters are averaged over the
data-parallel group (the world when no topology is installed) after every
step until ``begin_step``, then every ``k_steps`` steps: one flat all-reduce
per dtype. An eager multi-process meta-optimizer: ``loss.backward();
opt.step()``, never ``fleet.distributed_train_step``.
"""
from __future__ import annotations

import torch

__all__ = ["LocalSGDOptimizer"]


def data_group():
    """The data-parallel group of the installed topology, else the world."""
    from ...parallel.topology import get_hcg
    from .. import collective as C

    hcg = get_hcg()
    return hcg.get_data_parallel_group() if hcg is not None else C._ensure_default()


class LocalSGDOptimizer:
    """Wrap any optimizer; every k_steps, average the parameters over the ranks."""

    def __init__(self, optimizer, k_steps: int = 1, begin_step: int = 0):
        if int(k_steps) < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self._inner = optimizer
        self._k = int(k_steps)
        self._begin = int(begin_step)
        self._count = 0

    def step(self):
        self._inner.step()
        self._count += 1
        # dense per-step sync until begin_step, then every k steps
        if self._count <= self._begin or self._count % self._k == 0:
            self.sync_params()

    @torch.no_grad()
    def sync_params(self):
        from .. import collective as C

        C.all_reduce_flat([p.data for p in self._inner._param_list() if p.requires_grad],
                          data_group(), average=True)

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)
