"""StrategyCompiler — meta-optimizer selection, chaining order, and the
no-silent-no-op guarantee for DistributedStrategy
(``paddle_tpu/distributed/fleet/strategy_compiler.py``).

Reference analogue: fleet/base/strategy_compiler.py:114 — the reference
generates valid meta-optimizer chains (each meta-optimizer rewrites the
Program and wraps an inner optimizer) and picks the highest-priority valid
one. Here, as in the JAX package, tensor parallelism and ZeRO are the
sharded step's (``parallel/sharding.py``); the meta-optimizers that remain
chain in a FIXED documented order (outermost first):

    GradientMerge  ->  LocalSGD | DGC  ->  Lars/Lamb-substituted base

 - GradientMerge is outermost so the comm-reducing wrappers (whose step
   counters must track ACTUAL parameter updates) only see boundary steps.
 - LocalSGD and DGC are mutually exclusive (both reduce DP communication).
 - strategy.lars / strategy.lamb SUBSTITUTE the base optimizer the way the
   reference's _can_apply-gated meta-optimizers do (lars_optimizer.py
   requires Momentum; lamb_optimizer.py requires Adam/AdamW).

Every DistributedStrategy field carries a consumption status below; a field
set away from its default that nothing consumes raises a warning at
distributed_optimizer time — a user must never get different training than
they asked for with no signal (the round-3 gradient_merge/fp16_allreduce
silent-no-op bug class).
"""
from __future__ import annotations

import warnings
from typing import List, Tuple

__all__ = ["StrategyCompiler", "FIELD_STATUS"]

# How each DistributedStrategy field is consumed.
#   optimizer : applied by StrategyCompiler.compile (this module)
#   train-step: consumed by fleet.distributed_train_step / the compiled step
#   mesh      : consumed by fleet.init (mesh axes / HybridCommunicateGroup)
#   ps        : consumed by the parameter-server runtime
#   absorbed  : the sharded step's own (it buckets each collective into one
#               flat buffer); documented no-op by design
#   unimplemented: accepted but NOT wired — warn loudly when set
FIELD_STATUS = {
    "amp": "train-step",
    "amp_configs": "train-step",
    "recompute": "train-step",
    "recompute_configs": "train-step",
    "gradient_merge": "optimizer",
    "gradient_merge_configs": "optimizer",
    "lamb": "optimizer",
    "lamb_configs": "optimizer",
    "lars": "optimizer",
    "lars_configs": "optimizer",
    "dgc": "optimizer",
    "dgc_configs": "optimizer",
    "localsgd": "optimizer",
    "localsgd_configs": "optimizer",
    "fp16_allreduce": "unimplemented",
    "sharding": "train-step",
    "sharding_configs": "train-step",
    "pipeline": "train-step",
    "pipeline_configs": "train-step",
    "tensor_parallel": "mesh",
    "tensor_parallel_configs": "mesh",
    "hybrid_configs": "mesh",
    "heter_ccl_mode": "unimplemented",
    "auto": "train-step",   # auto_parallel planner (distributed/auto_parallel)
    "auto_configs": "train-step",  # planner tune/topk knobs
    "a_sync": "ps",
    "a_sync_configs": "ps",
    "nccl_comm_num": "absorbed",
    "find_unused_parameters": "absorbed",
    "fuse_grad_size_in_MB": "absorbed",
    "last_comm_group_size_MB": "absorbed",
    "fuse_all_reduce_ops": "absorbed",
}


class StrategyCompiler:
    """Chain optimizer-level meta-optimizers for a DistributedStrategy."""

    # application order: substitutions first, wrappers inside-out
    # (reference: strategy_compiler.py:114 picks by meta-optimizer priority)
    ORDER = ("lars", "lamb", "localsgd", "dgc", "gradient_merge")

    def validate(self, strategy) -> List[str]:
        """Warn for set-but-unwired fields. Unknown fields never get this
        far: DistributedStrategy.__setattr__ rejects them at assignment."""
        from .distributed_strategy import DistributedStrategy

        defaults = DistributedStrategy().__dict__
        issues = []
        for key, value in strategy.__dict__.items():
            if key.startswith("_") or key not in FIELD_STATUS:
                continue
            if FIELD_STATUS[key] == "unimplemented" and value != defaults.get(key):
                issues.append(
                    f"strategy.{key} is set but NOT implemented in the port "
                    " — training proceeds WITHOUT it"
                )
        for msg in issues:
            warnings.warn(msg, stacklevel=3)
        return issues

    def compile(self, strategy, optimizer) -> Tuple[object, List[str]]:
        """Return (wrapped_optimizer, applied_meta_optimizer_names)."""
        self.validate(strategy)
        applied: List[str] = []
        if getattr(strategy, "localsgd", False) and getattr(strategy, "dgc", False):
            raise ValueError(
                "strategy.localsgd and strategy.dgc are mutually exclusive "
                "(both reduce DP communication; pick one)"
            )
        for name in self.ORDER:
            if not getattr(strategy, name, False):
                continue
            optimizer, ok = getattr(self, f"_apply_{name}")(strategy, optimizer)
            if ok:
                applied.append(name)
        return optimizer, applied

    # -- substitutions -------------------------------------------------------
    def _apply_lars(self, strategy, optimizer):
        from ...optimizer import Lars, Momentum

        if not isinstance(optimizer, Momentum):
            warnings.warn(
                "strategy.lars applies only to Momentum (reference "
                f"_can_apply rule); {type(optimizer).__name__} left as-is"
            )
            return optimizer, False
        cfg = getattr(strategy, "lars_configs", {}) or {}
        return Lars(
            learning_rate=optimizer._lr,
            momentum=optimizer._momentum,
            lars_coeff=cfg.get("lars_coeff", 0.001),
            lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
            parameters=optimizer._parameters,
            grad_clip=optimizer._grad_clip,
            exclude_from_weight_decay=cfg.get("exclude_from_weight_decay", None),
            epsilon=cfg.get("epsilon", 0.0),
        ), True

    def _apply_lamb(self, strategy, optimizer):
        from ...optimizer import Adam, AdamW, Lamb

        if not isinstance(optimizer, (Adam, AdamW)):
            warnings.warn(
                "strategy.lamb applies only to Adam/AdamW (reference "
                f"_can_apply rule); {type(optimizer).__name__} left as-is"
            )
            return optimizer, False
        cfg = getattr(strategy, "lamb_configs", {}) or {}
        return Lamb(
            learning_rate=optimizer._lr,
            lamb_weight_decay=cfg.get("lamb_weight_decay", 0.01),
            beta1=optimizer._beta1,
            beta2=optimizer._beta2,
            epsilon=optimizer._epsilon,
            parameters=optimizer._parameters,
            grad_clip=optimizer._grad_clip,
        ), True

    # -- wrappers ------------------------------------------------------------
    def _apply_localsgd(self, strategy, optimizer):
        from .localsgd import LocalSGDOptimizer

        if getattr(optimizer, "_parameters", None) is None:
            raise ValueError("LocalSGD needs an optimizer with a parameter list")
        cfg = getattr(strategy, "localsgd_configs", {}) or {}
        return LocalSGDOptimizer(
            optimizer,
            k_steps=cfg.get("k_steps", 1),
            begin_step=cfg.get("begin_step", 0),
        ), True

    def _apply_dgc(self, strategy, optimizer):
        from ...optimizer import Momentum
        from .dgc import DGCMomentumOptimizer

        if not isinstance(optimizer, Momentum):
            warnings.warn(
                "strategy.dgc applies only to Momentum (reference _can_apply "
                f"rule); {type(optimizer).__name__} left unwrapped"
            )
            return optimizer, False
        if getattr(optimizer, "_nesterov", False):
            warnings.warn(
                "DGC has no Nesterov variant; momentum applies non-Nesterov"
            )
        if optimizer._parameters is None:
            raise ValueError("DGC needs an optimizer with a parameter list")
        cfg = getattr(strategy, "dgc_configs", {}) or {}
        return DGCMomentumOptimizer(
            learning_rate=optimizer._lr,
            momentum=optimizer._momentum,
            rampup_begin_step=cfg.get("rampup_begin_step", 0),
            rampup_step=cfg.get("rampup_step", 1),
            sparsity=cfg.get("sparsity", (0.999,)),
            parameters=optimizer._parameters,
            grad_clip=optimizer._grad_clip,
            weight_decay=optimizer._weight_decay or None,
        ), True

    def _apply_gradient_merge(self, strategy, optimizer):
        from .gradient_merge import GradientMergeOptimizer

        cfg = getattr(strategy, "gradient_merge_configs", {}) or {}
        k = int(cfg.get("k_steps", 1))
        if k <= 1:
            return optimizer, False
        return GradientMergeOptimizer(
            optimizer, k_steps=k, avg=bool(cfg.get("avg", True))
        ), True
