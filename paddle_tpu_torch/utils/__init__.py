"""``paddle.utils`` of the port: the host C++ build (``cpp_extension``) and
the four API.spec names ``deprecated``, ``require_version``, ``run_check``
and ``try_import`` (``paddle_tpu/utils/__init__.py``)."""
from __future__ import annotations

import functools
import importlib
import warnings

from . import cpp_extension  # noqa: F401

__all__ = ["cpp_extension", "deprecated", "require_version", "run_check", "try_import"]


def try_import(name):
    """The module ``name``, or None when it cannot be imported."""
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def deprecated(update_to="", since="", reason=""):
    """A decorator that warns once, at the first call, that ``fn`` is
    deprecated (reference: python/paddle/utils/deprecated.py)."""

    def decorate(fn):
        warned = []

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not warned:
                warned.append(True)
                msg = f"API {fn.__qualname__} is deprecated"
                if since:
                    msg += f" since {since}"
                if update_to:
                    msg += f"; use {update_to} instead"
                if reason:
                    msg += f" ({reason})"
                warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return decorate


def _version_tuple(v):
    return tuple(int(p) for p in str(v).split(".")[:3] if p.isdigit())


def require_version(min_version, max_version=None):
    """Raise unless the installed version lies in [min_version, max_version]
    (reference: python/paddle/utils/install_check.py)."""
    from .. import __version__

    cur = _version_tuple(__version__)
    if _version_tuple(min_version) > cur:
        raise RuntimeError(f"installed version {__version__} < required {min_version}")
    if max_version is not None and _version_tuple(max_version) < cur:
        raise RuntimeError(f"installed version {__version__} > allowed {max_version}")


def run_check():
    """Check the install: a small matmul on the current device (the card
    unless ``set_device("cpu")``), its result against the exact one, and
    the devices found."""
    import numpy as np
    import torch

    from .. import get_device, matmul, to_tensor

    x = to_tensor(np.ones((2, 2), np.float32))
    y = matmul(x, x)
    assert np.allclose(y.numpy(), np.full((2, 2), 2.0)), y.numpy()
    device = get_device()
    if device.startswith("gpu"):
        print(f"PaddlePaddle works! Found {torch.cuda.device_count()} GPU(s); ran on "
              f"{torch.cuda.get_device_name(x._value.device)}.")
    else:
        print(f"PaddlePaddle works! Ran on the CPU ({device}).")
