"""Random state: one ``torch.Generator`` per device behind ``seed()``.

The counterpart of ``paddle_tpu/core/random.py``, which splits jax keys. The
two packages can never share random bits, so tests make their inputs with
numpy and carry weights across with ``convert.state_dict_from_numpy``.
"""
from __future__ import annotations

import torch

_DEFAULT_SEED = 0
_seed = _DEFAULT_SEED
_generators: dict = {}


def seed(value: int) -> None:
    """``paddle.seed``: reseed every device's generator from ``value``."""
    global _seed
    _seed = int(value)
    _generators.clear()


def generator(device: torch.device) -> torch.Generator:
    """The generator of ``device``, made from the current seed on first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    gen = _generators.get(key)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_seed)
        _generators[key] = gen
    return gen
