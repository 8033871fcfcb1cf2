"""``paddle_tpu_torch.parallel`` — the engine under ``paddle.distributed``
(``paddle_tpu/parallel/__init__.py``): the hybrid topology over the ranks
(``topology``) and the sharding rules with the hybrid-parallel training
step (``sharding``). Pipelines are ROADMAP queue 1 item 13b."""
from .topology import (  # noqa: F401
    CommunicateTopology,
    HybridCommunicateGroup,
    get_mesh,
    global_mesh,
    init_mesh,
)
from .sharding import (  # noqa: F401
    ShardingSpec,
    param_spec,
    shard_params,
    sharded_train_step,
)
