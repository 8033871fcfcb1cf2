"""``paddle.optimizer`` for the port: SGD, Momentum, Adam, AdamW, Adamax,
Adagrad, Adadelta, RMSProp, Lamb and Lars over torch parameters, and the
``lr`` schedulers."""
from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    SGD,
    Adadelta,
    Adagrad,
    Adam,
    Adamax,
    AdamW,
    Lamb,
    Lars,
    Momentum,
    Optimizer,
    RMSProp,
)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "Lamb", "Lars", "Momentum",
           "Optimizer", "RMSProp", "SGD", "lr"]
