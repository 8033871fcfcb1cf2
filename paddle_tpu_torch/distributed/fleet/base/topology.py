"""``paddle.distributed.fleet.base.topology``: the process topology's
reference module path (``paddle_tpu/distributed/fleet/base/topology.py``);
the implementation is ``paddle_tpu_torch.parallel.topology``."""
from ....parallel.topology import (  # noqa: F401
    CommunicateTopology,
    HybridCommunicateGroup,
)

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]
