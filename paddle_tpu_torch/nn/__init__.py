"""``paddle.nn`` for the port: layers are ``torch.nn.Module``s."""
from . import functional, initializer  # noqa: F401
from .layer import Dropout, Embedding, LayerList, LayerNorm, Linear  # noqa: F401
