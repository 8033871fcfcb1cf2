"""``paddle.distributed.fleet.utils``: the recompute re-export
(``paddle_tpu/distributed/fleet/utils.py:11``). The filesystem clients wait
for ROADMAP queue 1 item 13c."""
from ...incubate.recompute import recompute, recompute_sequential  # noqa: F401

__all__ = ["recompute", "recompute_sequential"]
