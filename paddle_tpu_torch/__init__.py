"""paddle_tpu_torch: the PyTorch and CUDA port of ``paddle_tpu``, for NVIDIA Hopper.

It mirrors the JAX package's module paths and names. Entry points run on
the card unless the caller asks for the CPU, with ``set_device("cpu")`` or
a ``device="cpu"`` argument; without CUDA the default device raises. The
package imports torch and never jax or ``paddle_tpu``.

``paddle.Tensor`` is a mutable cell over a ``torch.Tensor`` (``_value``);
autograd runs on torch's tape and ``stop_gradient`` is ``not
requires_grad``. It does not subclass ``torch.Tensor``: Paddle's method
names (``shape``, ``size``, ``reshape``, ``transpose``, ``max``, ``split``,
``dtype``) differ from torch's, which torch and the port's modules call.
In-place Paddle ops rebind the cell to an out-of-place result, so views
taken earlier are never changed and recorded history is never broken. Layers,
``nn.functional`` and the criteria take Tensors or torch tensors: they
unwrap a Tensor at entry (no copy) and wrap what they return; calls with
torch tensors run as they did. The ``paddle.*`` functions also take a plain
``torch.Tensor``, as a Tensor whose ``stop_gradient`` is ``not
requires_grad``. Parameters are ``nn.Parameter``s, a ``torch.nn.Parameter``
subclass whose grad the whole-step capture watches (their Paddle surface is
``ParamAttr`` and ``nn.layer.common.param_of``). Under
``FLAGS_eager_lazy_dispatch`` eager calls are deferred into segments and a
steady training step is captured whole (``core/lazy.py``);
``paddle.device.synchronize()`` flushes.
"""
from __future__ import annotations

# API.spec lists these three at the top level: the JAX package's star
# import of its tensor API carries them
from typing import Optional, Sequence, Union  # noqa: F401

from . import core  # noqa: F401
from .core.dispatch import enable_grad, is_grad_enabled, no_grad, set_grad_enabled  # noqa: F401
from .core.dtype import (  # noqa: F401
    DType, bfloat16, bool_, complex64, complex128, float16, float32, float64,
    get_default_dtype, int8, int16, int32, int64, set_default_dtype, to_np_dtype, uint8,
)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.place import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace, IPUPlace, MLUPlace, NPUPlace, Place,
    TPUPlace, XPUPlace, device_count, get_device, is_compiled_with_cuda,
    is_compiled_with_tpu, set_device,
)
from .core.random import Generator, get_rng_state, seed, set_rng_state  # noqa: F401
from .core.tensor import Tensor, to_tensor  # noqa: F401
from .tensor_api import *  # noqa: F401,F403
from . import tensor_api as _tensor_api

from . import (  # noqa: F401,E402
    amp, autograd, device, distributed, framework, incubate, inference, io, jit, linalg, models,
    nn, optimizer, profiler, regularizer, resilience, serving, utils,
)
from .autograd import grad  # noqa: F401,E402
from .distributed.parallel import DataParallel  # noqa: F401,E402
from .batch import batch  # noqa: F401,E402
from .framework.io_utils import load, save  # noqa: F401,E402
from .nn.param_attr import ParamAttr  # noqa: F401,E402
from . import vision  # noqa: F401,E402

__version__ = "0.1.0"  # the JAX package's full_version
bool = bool_  # noqa: A001 — paddle.bool is the dtype
dtype = DType
# the card's generator state is the one get_rng_state returns
get_cuda_rng_state = get_rng_state
set_cuda_rng_state = set_rng_state

__all__ = sorted(set(_tensor_api.__all__) | {
    "CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "CustomPlace", "DataParallel", "DType",
    "Generator",
    "ParamAttr", "vision",
    "IPUPlace", "MLUPlace", "NPUPlace", "Place", "TPUPlace", "Tensor", "XPUPlace", "amp",
    "autograd", "batch", "bfloat16", "device", "bool", "bool_", "complex64", "complex128",
    "device_count", "distributed", "dtype", "enable_grad", "float16", "float32", "float64",
    "framework", "get_cuda_rng_state", "get_default_dtype", "get_device", "get_flags",
    "get_rng_state", "grad", "incubate", "inference", "int8", "int16", "int32", "int64",
    "io", "is_compiled_with_cuda", "is_compiled_with_tpu", "is_grad_enabled", "jit",
    "load", "models", "nn", "no_grad", "optimizer", "profiler", "regularizer",
    "resilience", "save", "seed", "serving", "set_cuda_rng_state", "set_default_dtype",
    "set_device", "set_flags", "set_grad_enabled", "set_rng_state", "to_np_dtype",
    "to_tensor", "uint8", "utils",
})
