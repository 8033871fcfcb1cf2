"""``paddle.distributed.fleet.base`` (``paddle_tpu/distributed/fleet/base``)."""
from . import topology  # noqa: F401
