"""``paddle.nn`` for the port: layers are ``torch.nn.Module``s."""
from . import clip, functional, initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    GradientClipByGlobalNorm,
    GradientClipByNorm,
    GradientClipByValue,
)
from .layer import Dropout, Embedding, LayerList, LayerNorm, Linear  # noqa: F401
