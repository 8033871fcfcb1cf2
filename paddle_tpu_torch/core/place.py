"""Device / Place: the port's counterpart of ``paddle_tpu/core/place.py``.

A ``CUDAPlace`` takes the place of ``TPUPlace``. The default device is the
first card. Entry points resolve their device through ``torch_device``,
which raises when the card is asked for and CUDA is absent: nothing
continues quietly on the CPU. The CPU is an opt-in, by
``set_device("cpu")`` or a ``device="cpu"`` argument.

The other Places of the API (``TPUPlace``, ``XPUPlace``, ``NPUPlace``,
``MLUPlace``, ``IPUPlace``, ``CustomPlace``) exist so scripts that name them
import; this build has none of those devices, so using one raises.
``CUDAPinnedPlace`` is host memory.
"""
from __future__ import annotations

import torch


class Place:
    device_type = "undefined"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __repr__(self):
        return f"Place({self.device_type}:{self._device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place) and self.device_type == other.device_type
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((self.device_type, self._device_id))

    def torch_device(self) -> torch.device:
        raise RuntimeError(f"{self!r}: this build has no {self.device_type} device; "
                           "use CUDAPlace or CPUPlace")


class CPUPlace(Place):
    device_type = "cpu"

    def __str__(self):
        return "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: a host Place."""


class CUDAPlace(Place):
    """The accelerator Place: one NVIDIA card, by index."""

    device_type = "gpu"

    def __str__(self):
        return f"gpu:{self._device_id}"

    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self} was asked for but CUDA is not available; call "
                "paddle_tpu_torch.set_device('cpu') or pass device='cpu' to "
                "run on the CPU"
            )
        return torch.device("cuda", self._device_id)


class TPUPlace(Place):
    device_type = "tpu"


class XPUPlace(Place):
    device_type = "xpu"


class NPUPlace(Place):
    device_type = "npu"


class MLUPlace(Place):
    device_type = "mlu"


class IPUPlace(Place):
    device_type = "ipu"


class CustomPlace(Place):
    def __init__(self, device_type="custom", device_id=0):
        super().__init__(device_id)
        self.device_type = device_type


_current: Place = CUDAPlace(0)


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        device = str(device)
    text = str(device).strip().lower()
    kind, _, idx = text.partition(":")
    if kind == "cpu" and not idx:
        return CPUPlace()
    if kind in ("gpu", "cuda"):
        return CUDAPlace(int(idx) if idx else 0)
    raise ValueError(f"unknown device {device!r}: use 'cpu', 'gpu' or 'gpu:N'")


def set_device(device) -> Place:
    """``paddle.set_device``: 'cpu', 'gpu', 'gpu:N' (or 'cuda:N', a Place)."""
    global _current
    _current = _parse(device)
    return _current


def get_device() -> str:
    """The current device as Paddle names it ('gpu:0' or 'cpu')."""
    return str(_current)


def torch_device(device=None) -> torch.device:
    """The torch device for ``device``, or for the current device when None.

    Raises RuntimeError when that is a card and CUDA is absent."""
    return (_current if device is None else _parse(device)).torch_device()


def device_of(device=None) -> torch.device:
    """The torch device of ``device``, or of the current device when None,
    without asking CUDA whether the card is there (``torch_device`` asks)."""
    place = _current if device is None else _parse(device)
    if isinstance(place, CUDAPlace):
        return torch.device("cuda", place.get_device_id())
    return place.torch_device()


def place_of(device: torch.device) -> Place:
    """The Place of a torch device."""
    if device.type == "cuda":
        return CUDAPlace(device.index or 0)
    return CPUPlace()


def is_compiled_with_cuda() -> bool:
    """Whether this torch was built with CUDA."""
    return torch.version.cuda is not None


def is_compiled_with_tpu() -> bool:
    return False


def device_count() -> int:
    """The number of devices of the current device's kind."""
    return torch.cuda.device_count() if isinstance(_current, CUDAPlace) else 1
