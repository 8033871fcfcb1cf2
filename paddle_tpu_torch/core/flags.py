"""Global flags: the port's own copy of the registry in ``paddle_tpu/core/flags.py``.

It holds only the flags that the port reads. Each keeps the JAX package's
name and default, can be overridden from the environment as ``FLAGS_<name>``
when this module is imported, and is read and set at run time through
``get_flags`` / ``set_flags``.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_registry: Dict[str, dict] = {}

_TRUE_WORDS = frozenset(("1", "true", "yes", "on", "y", "t"))
_FALSE_WORDS = frozenset(("0", "false", "no", "off", "n", "f", ""))


def _parse(text: str, default):
    if isinstance(default, bool):
        word = text.strip().lower()
        if word in _TRUE_WORDS:
            return True
        if word in _FALSE_WORDS:
            return False
        raise ValueError(
            f"invalid boolean flag value {text!r}: use 1/0, true/false, "
            "yes/no, or on/off"
        )
    if isinstance(default, int):
        return int(text)
    if isinstance(default, float):
        return float(text)
    return text


def _norm(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def define_flag(name: str, default: Any, doc: str = ""):
    name = _norm(name)
    env = os.environ.get("FLAGS_" + name)
    value = default if env is None else _parse(env, default)
    _registry[name] = {"value": value, "default": default, "doc": doc}
    return value


def get_flags(flags):
    """Accepts one name or a list of names; returns ``{"FLAGS_name": value}``."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for n in names:
        key = _norm(n)
        if key not in _registry:
            raise ValueError(f"unknown flag {n!r}")
        out["FLAGS_" + key] = _registry[key]["value"]
    return out


def set_flags(flags: Dict[str, Any]):
    """``{"FLAGS_name": value, ...}``; string values parse like the environment's."""
    for n, v in flags.items():
        key = _norm(n)
        if key not in _registry:
            raise ValueError(f"unknown flag {n!r}")
        entry = _registry[key]
        if isinstance(v, str) and not isinstance(entry["default"], str):
            v = _parse(v, entry["default"])
        entry["value"] = v


def flag(name: str):
    return _registry[_norm(name)]["value"]


define_flag(
    "use_flash_attention",
    True,
    "route scaled_dot_product_attention through the flash kernel when "
    "shapes/mask allow",
)
define_flag(
    "pallas_fused_update", False,
    "route the fused optimizer update (optimizer.make_fused_update, the one "
    "applier behind the eager step()) through the hand-written fused-update "
    "kernels for Adam / SGD / Momentum: each parameter's whole elementwise "
    "update chain, gated by the step's non-finite sentinel, runs as one "
    "kernel pass (one read and one write per buffer) on the card. On CPU "
    "tensors the kernels' plain PyTorch versions run; unsupported rules and "
    "dtypes keep the rule's torch ops unchanged",
)
define_flag(
    "pallas_update_interpret", False,
    "accepted for parity with the JAX package, where it runs the Pallas "
    "fused-update kernel in interpreter mode on the CPU. The port reads it "
    "nowhere: on a CPU tensor the fused update always runs the kernels' "
    "plain versions, on a CUDA tensor it always launches the kernels",
)
define_flag(
    "numeric_rescue", "",
    "step-level numeric rescue policy: '' (off), 'skip' (drop steps with "
    "non-finite gradients; params/optimizer state untouched), 'lr_backoff' "
    "(skip + multiply lr by FLAGS_numeric_rescue_lr_factor), or 'abort' "
    "(raise FloatingPointError). Detection is one device scalar computed in "
    "the fused update, which gates the update on the device; the host reads "
    "it once per step",
)
define_flag(
    "numeric_rescue_lr_factor", 0.5,
    "lr multiplier applied by the 'lr_backoff' numeric-rescue policy on "
    "each rescued step",
)
