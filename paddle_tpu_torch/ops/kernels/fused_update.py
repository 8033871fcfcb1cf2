"""Fused optimizer updates: the port of ``paddle_tpu/ops/pallas/fused_update.py``.

Three kernels in ``csrc/fused_update.cu``, one per stock rule, each running
one parameter's whole update chain in one pass over its buffers:

    SGD       p' = p - lr * (g + wd*p)
    Momentum  v' = mu*v + (g + wd*p);  p' = p - lr * (v' [+ mu*v' nesterov])
    Adam      m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g^2
              p' = p - lr_t * m' / (sqrt(v') + eps)

Each wrapper (``fused_sgd``, ``fused_momentum``, ``fused_adam``) launches
its kernel on a CUDA tensor (built with nvcc at first use, see ``_build``)
and counts the launch in its ``launches``; on a CPU tensor it runs the
kernel's plain PyTorch version (``sgd_plain``, ``momentum_plain``,
``adam_plain``), which the card checks hold the kernel against bit for bit.
``param_update`` dispatches one parameter to its rule's wrapper. Any other
device raises, and there is no fallback from a kernel to its plain version.

Where the JAX kernel returns fresh arrays, the port writes p and the state
tensors IN PLACE: one read and one write per buffer. The step's non-finite
sentinel ``bad`` (a 0-d device bool, or None) gates the update inside the
kernel, so a rescued step leaves every buffer as it was. Adam's bias
correction ``lr_t`` and its beta-pow accumulators are scalar math, done with
torch ops around the kernel, as the JAX package does them around its kernel.

Eligibility (``supported``) takes any f32 parameter of n >= 1 elements whose
buffers are contiguous: the JAX rule that n be a multiple of 1024 is the
TPU's (8, 128) tile, not a contract of the update.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ...core import flags
from . import _build

__all__ = ["enabled", "rule_kind", "supported", "param_update", "fused_sgd",
           "fused_momentum", "fused_adam", "sgd_plain", "momentum_plain", "adam_plain"]

KERNEL_NAME = "fused_update"

_ARGTYPES = {
    "paddle_fused_sgd": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "paddle_fused_momentum": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                               ctypes.c_void_p],
    "paddle_fused_adam": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
    + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p],
}


def enabled() -> bool:
    return bool(flags.flag("pallas_fused_update"))


def rule_kind(opt_type) -> Optional[str]:
    """'sgd' | 'momentum' | 'adam' when ``opt_type._update`` is one of the
    three stock rules the kernels implement; None otherwise (AdamW, and any
    subclass that overrides ``_update``, keep the rule's torch ops)."""
    from ...optimizer.optimizer import SGD, Adam, Momentum

    upd = opt_type._update
    if upd is SGD._update:
        return "sgd"
    if upd is Momentum._update:
        return "momentum"
    if upd is Adam._update:
        return "adam"
    return None


def supported(kind: Optional[str], p, g, state: Dict) -> bool:
    """One parameter's eligibility: f32, the grad already cast and of p's
    shape, contiguous p, g and state buffers of p's shape and dtype on p's
    device, and at least one element."""
    if kind is None:
        return False
    if p.dtype != torch.float32 or g.dtype != p.dtype or g.shape != p.shape:
        return False
    if p.numel() == 0 or not (p.is_contiguous() and g.is_contiguous()):
        return False
    if g.device != p.device:
        return False
    for v in state.values():
        if v.shape == p.shape and (v.dtype != p.dtype or v.device != p.device
                                   or not v.is_contiguous()):
            return False
    return True


# ---------------------------------------------------------------------------
# plain versions: the kernel bodies (fused_update.py:116-165) as torch ops,
# out of place. ``lr`` is a 0-d tensor of p's dtype (lr_t for Adam); ``bad`` a
# 0-d bool tensor or None.
# ---------------------------------------------------------------------------
def sgd_plain(p, g, lr, *, wd, bad=None):
    if wd:
        g = g + wd * p
    new_p = p - lr * g
    if bad is not None:
        new_p = torch.where(bad, p, new_p)
    return new_p


def momentum_plain(p, g, v, lr, *, mu, nesterov, wd, bad=None):
    if wd:
        g = g + wd * p
    new_v = mu * v + g
    step = g + mu * new_v if nesterov else new_v
    new_p = p - lr * step
    if bad is not None:
        new_p = torch.where(bad, p, new_p)
        new_v = torch.where(bad, v, new_v)
    return new_p, new_v


def adam_plain(p, g, m, v, lr_t, *, b1, b2, eps, wd, bad=None):
    if wd:
        g = g + wd * p
    new_m = b1 * m + (1 - b1) * g
    new_v = b2 * v + (1 - b2) * torch.square(g)
    new_p = p - lr_t * new_m / (torch.sqrt(new_v) + eps)
    if bad is not None:
        new_p = torch.where(bad, p, new_p)
        new_m = torch.where(bad, m, new_m)
        new_v = torch.where(bad, v, new_v)
    return new_p, new_m, new_v


def _fn(symbol):
    fn = getattr(_build.load(KERNEL_NAME), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[symbol]
    return fn


def _check_cuda(kind, p, bufs, lr, bad):
    """What the kernel takes: contiguous f32 buffers of p's shape on p's
    device, one-element lr (f32) and bad (bool) there; raises otherwise."""
    for t in (p,) + bufs:
        if (t.device != p.device or t.dtype != torch.float32 or t.shape != p.shape
                or not t.is_contiguous()):
            raise ValueError(
                f"fused_update[{kind}]: every buffer must be a contiguous float32 tensor "
                f"of p's shape {tuple(p.shape)} on {p.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
    for t, dtype in ((lr, torch.float32), (bad, torch.bool)):
        if t is not None and (t.device != p.device or t.dtype != dtype or t.numel() != 1):
            raise ValueError(
                f"fused_update[{kind}]: lr and bad must be one-element {dtype} tensors "
                f"on {p.device}"
            )
    if p.numel() == 0:
        raise ValueError(f"fused_update[{kind}]: empty parameter")


def _launch(wrapper, symbol, p, args):
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = _fn(symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{wrapper.__name__}: kernel launch failed with cudaError_t {err} "
            f"at {p.numel()} elements"
        )
    wrapper.launches += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _device_of(name, p):
    if p.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{name}: no kernel for device {p.device}")
    return p.device.type == "cuda"


def fused_sgd(p, g, lr, *, wd, bad=None):
    """SGD over p in place: ``csrc/fused_update.cu`` on a CUDA tensor,
    ``sgd_plain`` on a CPU tensor."""
    if _device_of("fused_sgd", p):
        _check_cuda("sgd", p, (g,), lr, bad)
        _launch(fused_sgd, "paddle_fused_sgd", p,
                (p.data_ptr(), g.data_ptr(), p.numel(), lr.data_ptr(), _ptr(bad),
                 wd, int(wd != 0.0)))
    else:
        p.copy_(sgd_plain(p, g, lr, wd=wd, bad=bad))


fused_sgd.launches = 0


def fused_momentum(p, g, v, lr, *, mu, nesterov, wd, bad=None):
    """Momentum over p and its velocity v in place: the kernel on a CUDA
    tensor, ``momentum_plain`` on a CPU tensor."""
    if _device_of("fused_momentum", p):
        _check_cuda("momentum", p, (g, v), lr, bad)
        _launch(fused_momentum, "paddle_fused_momentum", p,
                (p.data_ptr(), g.data_ptr(), v.data_ptr(), p.numel(), lr.data_ptr(),
                 _ptr(bad), mu, int(nesterov), wd, int(wd != 0.0)))
    else:
        new_p, new_v = momentum_plain(p, g, v, lr, mu=mu, nesterov=nesterov, wd=wd, bad=bad)
        p.copy_(new_p)
        v.copy_(new_v)


fused_momentum.launches = 0


def fused_adam(p, g, m, v, lr_t, *, b1, b2, eps, wd, bad=None):
    """Adam over p and its moments m, v in place, with the bias-corrected
    step size ``lr_t``: the kernel on a CUDA tensor, ``adam_plain`` on a CPU
    tensor."""
    if _device_of("fused_adam", p):
        _check_cuda("adam", p, (g, m, v), lr_t, bad)
        _launch(fused_adam, "paddle_fused_adam", p,
                (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                 lr_t.data_ptr(), _ptr(bad), b1, 1 - b1, b2, 1 - b2, eps, wd,
                 int(wd != 0.0)))
    else:
        new_p, new_m, new_v = adam_plain(p, g, m, v, lr_t, b1=b1, b2=b2, eps=eps, wd=wd,
                                         bad=bad)
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)


fused_adam.launches = 0


def param_update(kind: str, p, g, lr, state: Dict, hyper: Dict, *, wd, bad):
    """One parameter's fused update, IN PLACE over p and ``state``'s tensors.

    ``lr`` is the step's 0-d f32 learning rate on p's device; ``bad`` the
    step's 0-d bool sentinel or None. Gating happens in the kernel (and in
    the plain version on the CPU): the caller must NOT gate again. Returns
    ``(p, state)``, the same tensors, updated."""
    wd = float(wd)
    if kind == "sgd":
        fused_sgd(p, g, lr.to(p.dtype), wd=wd, bad=bad)
        return p, state
    if kind == "momentum":
        fused_momentum(p, g, state["velocity"], lr.to(p.dtype), mu=float(hyper["mu"]),
                       nesterov=bool(hyper["nesterov"]), wd=wd, bad=bad)
        return p, state
    if kind == "adam":
        b1, b2, eps = float(hyper["b1"]), float(hyper["b2"]), float(hyper["eps"])
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        lr_t = (lr * torch.sqrt(1 - b2p) / (1 - b1p)).to(p.dtype)
        fused_adam(p, g, state["moment1"], state["moment2"], lr_t, b1=b1, b2=b2, eps=eps,
                   wd=wd, bad=bad)
        if bad is not None:
            # the beta pows gate with the buffers: a rescued step must not
            # advance the bias correction either
            b1p = torch.where(bad, state["beta1_pow"], b1p)
            b2p = torch.where(bad, state["beta2_pow"], b2p)
        state["beta1_pow"].copy_(b1p)
        state["beta2_pow"].copy_(b2p)
        return p, state
    raise ValueError(f"unsupported fused-update kind {kind!r}")


KERNELS = {"sgd": fused_sgd, "momentum": fused_momentum, "adam": fused_adam}
