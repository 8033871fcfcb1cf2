"""Distributed layers of the port; on one card they run unsharded.
``checkpoint`` is the asynchronous checkpointing and resume loop; ``ps`` the
parameter-server tables and service."""
from . import checkpoint, fleet, ps  # noqa: F401
