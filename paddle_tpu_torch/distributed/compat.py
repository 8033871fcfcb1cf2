"""The collective names of ``paddle_tpu/distributed/compat.py``:
``ParallelMode``, the gloo rendezvous names and the group-sharded (ZeRO)
API. The PS entry configs and the launch-era cluster model wait for
ROADMAP queue 1 item 13c.
"""
from __future__ import annotations

import os

__all__ = ["ParallelMode", "gloo_init_parallel_env", "gloo_barrier", "gloo_release",
           "group_sharded_parallel", "save_group_sharded_model"]


class ParallelMode:
    """reference: fleet/base/topology.py ParallelMode constants."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


_gloo = {"group": None}


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """A CPU rendezvous of ``rank_num`` processes at ``server_endpoint``
    (``host:port``, or a ``file://`` path): a gloo group for
    ``gloo_barrier``, beside whatever the default group is. When no default
    group exists, it becomes the default, over gloo."""
    import torch.distributed as dist

    from . import collective as C
    from .parallel import _make_store

    if int(rank_num) <= 1:
        return
    if not dist.is_initialized():
        store = _make_store(server_endpoint, int(rank_id), int(rank_num))
        dist.init_process_group("gloo", store=store, rank=int(rank_id),
                                world_size=int(rank_num))
        C._default_group = None
        _gloo["group"] = C._ensure_default()
    else:
        _gloo["group"] = C.new_group(list(range(int(rank_num))), backend="gloo")


def gloo_barrier():
    from .collective import barrier

    barrier(_gloo["group"])


def gloo_release():
    """Forget the gloo group of ``gloo_init_parallel_env``."""
    _gloo["group"] = None


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None, offload=False,
                           sync_buffers=False, buffer_max_size=2**23, segment_size=2**20,
                           sync_comm=False):
    """ZeRO by level (reference: sharding/group_sharded.py; os / os_g /
    p_g_os = stages 1 / 2 / 3): with p_g_os the parameters are cut to this
    rank's shards now; the stage is kept on the model for
    ``fleet.distributed_train_step``, whose strategy sets it."""
    from ..parallel.sharding import shard_params

    stage = {"os": 1, "os_g": 2, "p_g_os": 3}.get(level)
    if stage is None:
        raise ValueError(f"level must be one of os|os_g|p_g_os, got {level!r}")
    shard_params(model, zero_stage=stage)
    model._group_sharded_stage = stage
    if scaler is not None:
        return model, optimizer, scaler
    return model, optimizer


def save_group_sharded_model(model, output, optimizer=None):
    """reference: sharding/group_sharded.py save_group_sharded_model: the
    whole state gathered over the topology on every rank and saved by rank
    0 as ``output/model.pdparams`` (and ``model.pdopt``), in the JAX
    package's ``paddle.save`` format. Every rank calls it."""
    from .. import framework
    from ..convert import gather_model_state
    from .parallel import get_rank

    if output.endswith((".pdparams", ".pdopt", ".pdmodel")):
        raise ValueError(
            f"save_group_sharded_model expects a directory/prefix, got a file suffix: {output}")
    state = gather_model_state(model)
    opt_state = gather_model_state(model, optimizer) if optimizer is not None else None
    if get_rank() == 0:
        os.makedirs(output, exist_ok=True)
        framework.io_utils.save(state, os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            framework.io_utils.save(opt_state, os.path.join(output, "model.pdopt"))
