"""Device / Place: the port's counterpart of ``paddle_tpu/core/place.py``.

A ``CUDAPlace`` takes the place of ``TPUPlace``. The default device is the
first card. Entry points resolve their device through ``torch_device``,
which raises when the card is asked for and CUDA is absent: nothing
continues quietly on the CPU. The CPU is an opt-in, by
``set_device("cpu")`` or a ``device="cpu"`` argument.
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


class CPUPlace(Place):
    device_type = "cpu"

    def __str__(self):
        return "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


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
