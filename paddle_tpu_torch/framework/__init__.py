"""``paddle.framework`` for the port: ``io_utils`` (``paddle.save`` / ``paddle.load``)."""
from . import io_utils  # noqa: F401
