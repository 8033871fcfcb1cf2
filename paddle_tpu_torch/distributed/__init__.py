"""Distributed layers of the port; on one card they run unsharded.
``checkpoint`` is the asynchronous checkpointing and resume loop."""
from . import checkpoint, fleet  # noqa: F401
