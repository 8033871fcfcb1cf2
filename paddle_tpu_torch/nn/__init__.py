"""``paddle.nn`` for the port: layers are ``nn.Layer``s, ``torch.nn.Module``s
with Paddle's state methods."""
from . import clip, functional, initializer, layer_base  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    GradientClipByGlobalNorm,
    GradientClipByNorm,
    GradientClipByValue,
)
from .layer import Dropout, Embedding, LayerList, LayerNorm, Linear  # noqa: F401
from .layer_base import Layer  # noqa: F401
