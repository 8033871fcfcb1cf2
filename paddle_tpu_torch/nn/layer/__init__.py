from .common import Dropout, Embedding, LayerList, Linear  # noqa: F401
from .norm import LayerNorm  # noqa: F401
