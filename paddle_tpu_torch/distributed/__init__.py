"""Distributed layers of the port; on one card they run unsharded."""
from . import fleet  # noqa: F401
