"""``paddle.optimizer`` for the port: Adam and AdamW over torch parameters."""
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401

__all__ = ["Adam", "AdamW", "Optimizer"]
