"""paddle_tpu_torch: the PyTorch and CUDA port of ``paddle_tpu``, for NVIDIA Hopper.

It mirrors the JAX package's module paths and names. Entry points run on
the card unless the caller asks for the CPU, with ``set_device("cpu")`` or
a ``device="cpu"`` argument; without CUDA the default device raises. The
package imports torch and never jax or ``paddle_tpu``.
"""
from __future__ import annotations

from . import (  # noqa: F401
    amp, distributed, incubate, inference, io, jit, models, nn, optimizer, profiler,
    regularizer, resilience, serving,
)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.place import CPUPlace, CUDAPlace, get_device, set_device  # noqa: F401
from .core.random import get_rng_state, seed, set_rng_state  # noqa: F401

__all__ = [
    "CPUPlace", "CUDAPlace", "amp", "distributed", "get_device", "get_flags",
    "get_rng_state", "incubate", "inference", "io", "jit", "models", "nn", "optimizer",
    "profiler", "regularizer", "resilience", "seed", "serving", "set_device", "set_flags",
    "set_rng_state",
]
