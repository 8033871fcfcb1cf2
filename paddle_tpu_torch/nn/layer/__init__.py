from . import activation, common, conv, loss, norm, pooling, transformer  # noqa: F401
