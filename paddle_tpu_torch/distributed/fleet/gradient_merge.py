"""GradientMerge — k-step gradient accumulation as a meta-optimizer
(``paddle_tpu/distributed/fleet/gradient_merge.py``).

Reference analogue: fleet/meta_optimizers/gradient_merge_optimizer.py:20.
An eager wrapper: ``step()`` folds the current ``.grad``s into float32
accumulators and invokes the inner optimizer on every k-th call only;
between boundaries parameters (and the LR schedule) do not move, so a k-step
merged run is numerically a k x batch run. ``fleet.distributed_train_step``
unwraps it into the sharded step's own accumulation (``accumulate_steps``).
"""
from __future__ import annotations

import torch

__all__ = ["GradientMergeOptimizer"]


class GradientMergeOptimizer:
    """Wrap any optimizer; apply the merged gradient every ``k_steps``.

    avg=True divides the accumulated gradient by k (the reference default)."""

    def __init__(self, optimizer, k_steps: int = 1, avg: bool = True):
        if int(k_steps) < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self._inner = optimizer
        self._k = int(k_steps)
        self._avg = bool(avg)
        self._acc = {}          # id(param) -> (param, fp32 accumulator)
        self._micro_count = 0

    @property
    def inner_opt(self):
        return self._inner

    @torch.no_grad()
    def step(self):
        params = [p for p in self._inner._param_list()
                  if p.requires_grad and p.grad is not None]
        self._micro_count += 1
        for p in params:
            cur = self._acc.get(id(p))
            g = p.grad.float()
            self._acc[id(p)] = (p, g.clone() if cur is None else cur[1] + g)
        if self._micro_count % self._k:
            return
        scale = 1.0 / self._k if self._avg else 1.0
        for p, acc in self._acc.values():
            # a parameter without a grad on the boundary step takes its dtype
            gd = p.grad.dtype if p.grad is not None else p.dtype
            p.grad = (acc * scale).to(gd)
        self._inner.step()
        self._acc.clear()

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero=set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def state_dict(self):
        out = dict(self._inner.state_dict())
        out["_gm_micro_count"] = self._micro_count
        return out

    def set_state_dict(self, state):
        state = dict(state)
        state.pop("_gm_micro_count", None)
        # the accumulators are not checkpointed: a restore starts a fresh
        # window (the count without the partial sum would mis-scale the
        # next boundary's update)
        self._micro_count = 0
        self._acc.clear()
        self._inner.set_state_dict(state)

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)
