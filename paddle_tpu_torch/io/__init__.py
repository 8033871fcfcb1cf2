"""Data helpers of the PyTorch port: the shape-bucketing policy (``BucketSpec``)."""
from .bucketing import BucketSpec  # noqa: F401

__all__ = ["BucketSpec"]
