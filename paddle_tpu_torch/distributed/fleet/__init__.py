from . import meta_parallel, utils  # noqa: F401
