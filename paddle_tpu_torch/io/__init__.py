"""Data helpers of the PyTorch port: the padding policy the serving engine uses."""
from .bucketing import BucketSpec  # noqa: F401

__all__ = ["BucketSpec"]
