"""``paddle.optimizer`` for the port: SGD, Momentum, Adam and AdamW over
torch parameters, and the ``lr`` schedulers."""
from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401

__all__ = ["Adam", "AdamW", "Momentum", "Optimizer", "SGD", "lr"]
