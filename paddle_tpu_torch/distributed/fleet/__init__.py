"""``paddle.distributed.fleet`` in collective mode
(``paddle_tpu/distributed/fleet/__init__.py:109-304, 485-640``).

``init`` installs the hybrid topology of ``strategy.hybrid_configs`` over
the ranks ``init_parallel_env`` joined (it joins them itself when nothing
has), ``distributed_model`` cuts the parameters for ZeRO-3,
``distributed_optimizer`` chains the meta-optimizers and
``distributed_train_step`` builds the sharded step of
``parallel/sharding.py``, with ``strategy.amp`` as its forward context,
``strategy.recompute`` on the named sublayers and gradient merge as its
microbatches. Build the model after ``init``: the tensor-parallel layers
cut their weights by the installed mp degree.

Not ported yet: ``strategy.auto`` and the parameter-server entry points
(ROADMAP queue 1 item 13c), ``pp_degree`` > 1 (item 13b).
"""
from __future__ import annotations

import os
from typing import Optional

from ...nn.layer_base import Layer
from ...parallel.topology import (
    HybridCommunicateGroup,
    get_hcg as _topo_get_hcg,
    init_mesh,
)
from . import meta_parallel, utils  # noqa: F401
from .distributed_strategy import DistributedStrategy
from .meta_parallel import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    PipelineLayer,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from .role_maker import PaddleCloudRoleMaker, Role, UserDefinedRoleMaker  # noqa: F401
from .localsgd import LocalSGDOptimizer  # noqa: F401
from .dgc import DGCMomentumOptimizer  # noqa: F401
from . import base  # noqa: F401

__all__ = [
    "init",
    "DistributedStrategy",
    "HybridCommunicateGroup",
    "get_hybrid_communicate_group",
    "distributed_model",
    "distributed_optimizer",
    "distributed_train_step",
    "get_rank",
    "worker_index",
    "worker_num",
    "is_first_worker",
    "barrier_worker",
    "PaddleCloudRoleMaker",
    "UserDefinedRoleMaker",
    "LocalSGDOptimizer",
    "DGCMomentumOptimizer",
    "is_server",
    "init_server",
    "run_server",
    "init_worker",
    "stop_worker",
    "UtilBase",
    "Fleet",
]

_state = {"strategy": None, "hcg": None, "initialized": False}


def _ps_later(what):
    raise NotImplementedError(
        f"fleet.{what}: the parameter-server mode is not ported yet (ROADMAP, open items, "
        "queue 1 item 13c); use distributed.ps's MemorySparseTable, or PsServer / PsClient "
        "directly"
    )


def is_server() -> bool:
    return os.getenv("TRAINING_ROLE", "TRAINER") == "PSERVER"


def init_server(*args, **kwargs):
    _ps_later("init_server")


def run_server():
    _ps_later("run_server")


def init_worker(*args, **kwargs):
    _ps_later("init_worker")


def stop_worker():
    _ps_later("stop_worker")


def init(role_maker=None, is_collective=False, strategy: Optional[DistributedStrategy] = None):
    """reference: fleet_base.py:206 fleet.init, collective mode."""
    from .. import parallel as _parallel
    from . import meta_parallel as _mp

    strategy = strategy or DistributedStrategy()
    if is_server():
        _ps_later("init in parameter-server mode")
    if strategy.auto:
        raise NotImplementedError(
            "strategy.auto (the auto-parallel planner) is not ported yet (ROADMAP, open "
            "items, queue 1 item 13c)"
        )
    _state["strategy"] = strategy
    hybrid = strategy.hybrid_configs
    dp = hybrid.get("dp_degree", 1)
    mp = hybrid.get("mp_degree", 1)
    if strategy.tensor_parallel and mp == 1:
        mp = int(strategy.tensor_parallel_configs.get("tensor_parallel_degree", 1))
    pp = hybrid.get("pp_degree", 1)
    sharding = hybrid.get("sharding_degree", 1)
    sep = hybrid.get("sep_degree", 1)
    if pp > 1:
        raise NotImplementedError(
            "pp_degree > 1 (pipeline parallelism) is not ported yet (ROADMAP, open items, "
            "queue 1 item 13b)"
        )
    import torch.distributed as dist

    if not dist.is_initialized():
        _parallel.init_parallel_env()
    world = _parallel.get_world_size()
    specified = dp * mp * pp * sharding * sep
    if specified == 1 and world > 1:
        dp = world  # pure data parallel over every rank
    elif dp == -1 or (specified < world and dp == 1):
        dp = max(1, world // (mp * pp * sharding * sep))
    init_mesh(dp=dp, mp=mp, pp=pp, sharding=sharding, sep=sep)
    _state["hcg"] = _topo_get_hcg()
    _state["initialized"] = True
    if mp > 1 and "model_parallel_rng" not in _mp.get_rng_state_tracker()._states:
        from ...core import random as _random

        seed = _random._seed
        _mp.get_rng_state_tracker().add("global_seed", seed)
        _mp.get_rng_state_tracker().add("model_parallel_rng", seed + 1 + _mp.mp_rank())
    return None


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    return _state["hcg"] or _topo_get_hcg()


def _strategy() -> DistributedStrategy:
    return _state["strategy"] or DistributedStrategy()


def distributed_model(model: Layer):
    """reference: fleet_base.py:932 — with ZeRO-3 the parameters cut to this
    rank's shards (``parallel.sharding.shard_params``); the model itself
    is returned, ready for ``distributed_train_step``."""
    from ...parallel.sharding import shard_params

    shard_params(model, zero_stage=_strategy().sharding_stage)
    return model


def distributed_optimizer(optimizer, strategy: Optional[DistributedStrategy] = None):
    """reference: fleet_base.py:875 — the meta-optimizer chain of
    ``strategy_compiler``; tensor parallelism and ZeRO are the sharded
    step's, amp and recompute ``distributed_train_step``'s."""
    from .gradient_merge import GradientMergeOptimizer
    from .strategy_compiler import StrategyCompiler

    if isinstance(optimizer, (LocalSGDOptimizer, DGCMomentumOptimizer,
                              GradientMergeOptimizer)):
        if strategy is not None and strategy is not _state["strategy"]:
            raise ValueError(
                f"optimizer is already wrapped by {type(optimizer).__name__}; call "
                "distributed_optimizer with a new strategy on the UNWRAPPED optimizer"
            )
        return optimizer
    if strategy is not None:
        _state["strategy"] = strategy
    st = _strategy()
    optimizer, applied = StrategyCompiler().compile(st, optimizer)
    optimizer._fleet_strategy = st
    optimizer._fleet_applied_meta_optimizers = applied
    return optimizer


def distributed_train_step(model, loss_fn, optimizer, grad_input_idx=()):
    """The hybrid-parallel training step of the installed topology and
    strategy (``parallel.sharding.ShardedTrainStep``); call it with the
    global batch on every rank."""
    from ...parallel.sharding import sharded_train_step
    from ...parallel.topology import axis_size
    from .gradient_merge import GradientMergeOptimizer

    strategy = _strategy()
    accumulate_steps = 1
    if isinstance(optimizer, GradientMergeOptimizer):
        accumulate_steps = optimizer._k
        if not optimizer._avg:
            raise ValueError("the sharded step's gradient merge always averages (avg=False "
                             "only exists on the eager wrapper)")
        optimizer = optimizer.inner_opt
    elif strategy.gradient_merge:
        cfg_gm = strategy.gradient_merge_configs or {}
        accumulate_steps = int(cfg_gm.get("k_steps", 1))
        if accumulate_steps > 1 and not cfg_gm.get("avg", True):
            raise ValueError("the sharded step's gradient merge always averages (avg=False "
                             "only exists on the eager wrapper)")
    if isinstance(optimizer, (LocalSGDOptimizer, DGCMomentumOptimizer)):
        raise ValueError(
            "LocalSGD/DGC are EAGER multi-process meta-optimizers; call loss.backward(); "
            "opt.step() directly instead of distributed_train_step"
        )
    forward_ctx = None
    if strategy.amp:
        from ... import amp as _amp

        cfg = strategy.amp_configs or {}
        level = "O2" if (cfg.get("use_pure_fp16") or cfg.get("use_pure_bf16")) else "O1"
        dtype = "float16" if cfg.get("use_pure_fp16") else "bfloat16"

        def forward_ctx(_cfg=cfg, _level=level, _dtype=dtype):
            return _amp.auto_cast(
                enable=True,
                custom_white_list=_cfg.get("custom_white_list") or None,
                custom_black_list=_cfg.get("custom_black_list") or None,
                level=_level, dtype=_dtype,
            )
    if strategy.recompute:
        _apply_strategy_recompute(
            model, (strategy.recompute_configs or {}).get("checkpoints") or [])
    if strategy.auto or axis_size("pp") > 1:
        raise NotImplementedError(
            "strategy.auto and pp_degree > 1 are not ported yet (ROADMAP, open items, queue "
            "1 item 13c and item 13b)"
        )
    return sharded_train_step(
        model, loss_fn, optimizer, zero_stage=strategy.sharding_stage,
        forward_ctx=forward_ctx, accumulate_steps=accumulate_steps,
        loss_scale=_static_loss_scale(strategy), grad_input_idx=grad_input_idx,
    )


def _static_loss_scale(strategy) -> float:
    """Pure fp16 trains with ``amp_configs.init_loss_scaling`` as a static
    scale (the gradients are unscaled before the clip); bf16 needs none."""
    cfg = strategy.amp_configs or {}
    if strategy.amp and cfg.get("use_pure_fp16"):
        return float(cfg.get("init_loss_scaling", 32768.0))
    return 1.0


def _apply_strategy_recompute(model, checkpoints):
    """strategy.recompute: each named sublayer's forward runs as one
    recompute segment (``incubate.recompute``). Idempotent per layer."""
    from ...incubate.recompute import recompute as _rc

    target = model._layers if hasattr(model, "_layers") else model
    layers = dict(target.named_sublayers()) if checkpoints else {}
    for name in checkpoints:
        layer = layers.get(name)
        if layer is None:
            raise ValueError(
                f"recompute checkpoint {name!r} is not a named sublayer of the model "
                f"(have: {sorted(layers)[:20]}...)"
            )
        if getattr(layer, "_fleet_recompute_wrapped", False):
            continue
        orig = layer.forward
        layer.forward = (lambda *a, _orig=orig, **k: _rc(_orig, *a, **k))
        layer._fleet_recompute_wrapped = True


def get_rank():
    from ..parallel import get_rank as _r

    return _r()


def worker_index():
    return get_rank()


def worker_num():
    from ..parallel import get_world_size as _w

    return _w()


def is_first_worker():
    return worker_index() == 0


def barrier_worker():
    from ..collective import barrier

    barrier()


class UtilBase:
    """reference: fleet/base/util_factory.py UtilBase — helper collectives
    across the workers."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import numpy as np
        import torch

        from ..collective import ReduceOp, all_reduce_

        op = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX, "min": ReduceOp.MIN}[mode]
        t = torch.as_tensor(np.asarray(input)).clone()
        return all_reduce_(t, op).numpy()

    def barrier(self, comm_world="worker"):
        from ..collective import barrier

        barrier()

    def all_gather(self, input, comm_world="worker"):
        from ..collective import all_gather_object

        return all_gather_object([], input)

    def get_file_shard(self, files):
        """This worker's contiguous part of ``files``."""
        n, rank = worker_num(), worker_index()
        per, rem = divmod(len(files), n)
        start = rank * per + min(rank, rem)
        end = start + per + (1 if rank < rem else 0)
        return list(files)[start:end]

    def print_on_rank(self, message, rank_id=0):
        if worker_index() == rank_id:
            print(message)


util = UtilBase()


class Fleet:
    """The class form of the facade (reference: fleet_base.py:206 Fleet)."""

    def __init__(self):
        self.util = util

    def init(self, role_maker=None, is_collective=False, strategy=None):
        return init(role_maker=role_maker, is_collective=is_collective, strategy=strategy)

    def distributed_model(self, model):
        return distributed_model(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy=strategy)

    def distributed_train_step(self, model, loss_fn, optimizer, grad_input_idx=()):
        return distributed_train_step(model, loss_fn, optimizer, grad_input_idx)

    def is_first_worker(self):
        return is_first_worker()

    def worker_index(self):
        return worker_index()

    def worker_num(self):
        return worker_num()

    def is_worker(self):
        return not is_server()

    def is_server(self):
        return is_server()

    def init_server(self, *args, **kwargs):
        return init_server(*args, **kwargs)

    def run_server(self):
        return run_server()

    def init_worker(self, *args, **kwargs):
        return init_worker(*args, **kwargs)

    def barrier_worker(self):
        return barrier_worker()

    def stop_worker(self):
        return stop_worker()
