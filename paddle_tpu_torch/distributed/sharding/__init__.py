"""``paddle.distributed.sharding`` — the group-sharded (ZeRO) user API
(``paddle_tpu/distributed/sharding/__init__.py``)."""
from ..compat import (  # noqa: F401
    group_sharded_parallel,
    save_group_sharded_model,
)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]
