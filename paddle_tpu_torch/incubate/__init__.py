"""``paddle.incubate`` for the port: activation recomputation
(``paddle_tpu/incubate/__init__.py``; the rest of the JAX package's incubate
waits for ROADMAP queue 1 item 14)."""
from .recompute import recompute, recompute_sequential  # noqa: F401

__all__ = ["recompute", "recompute_sequential"]
