"""Transient-vs-fatal error classification + capped exponential backoff: the
port of ``paddle_tpu/resilience/retry.py``, with the classification
re-derived for PyTorch and CUDA.

The classification contract is the JAX package's: only errors that a
*re-execution of the same program* could plausibly clear are transient —
injected harness faults, an out-of-memory of the caching allocator (the
RESOURCE_EXHAUSTED case: memory another step held may be free on the
retry), connection/timeout errors and flaky-mount OSErrors, and messages
that carry a transient status word (UNAVAILABLE, RESOURCE_EXHAUSTED, ...:
the status names of gRPC, which torch.distributed's RPC layer reports too).
Everything else (shape errors, user exceptions, NaN detections) is fatal and
propagates after a single attempt.

A CUDA launch or asynchronous error is FATAL. An illegal address or a
device-side assert leaves the process's CUDA context unusable: every later
call on it fails the same way, so a retry in the same process cannot
succeed. PyTorch raises these as ``torch.AcceleratorError`` (torch >= 2.8)
or as a ``RuntimeError`` whose message starts "CUDA error". Only a new
process recovers from one; in serving that ends in ``Engine.fail_clean``
once the Supervisor's restart budget is spent.
"""
from __future__ import annotations

import errno as _errno
import random
from typing import Optional

import torch

from ..core import flags
from .faults import InjectedFault

__all__ = ["RetryPolicy", "default_policy", "is_transient"]

# substrings of runtime-status messages that mark infrastructure (not
# program) failures
_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "RESOURCE_EXHAUSTED",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "connection reset",
    "socket closed",
    "temporarily unavailable",
)
# torch.distributed's network and store errors: a peer or the rendezvous
# store dropped, which a retry may find back
_TRANSIENT_TYPE_NAMES = ("DistNetworkError", "DistStoreError")

# a sticky CUDA error: the context is gone for this process
_CUDA_ERROR_PREFIX = "CUDA error"
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)

# deterministic program/user errors: never retried even when a message
# happens to contain a marker word
_FATAL_TYPES = (
    FloatingPointError,
    AssertionError,
    TypeError,
    ValueError,
    KeyError,
    IndexError,
    AttributeError,
    NotImplementedError,
)

# OSErrors whose cause is deterministic — a bad path, permissions, a full or
# read-only disk: retrying the same call cannot succeed
_FATAL_OS_TYPES = (
    PermissionError,
    FileNotFoundError,
    FileExistsError,
    IsADirectoryError,
    NotADirectoryError,
)
_FATAL_ERRNOS = frozenset(
    e for e in (
        _errno.EACCES, _errno.EPERM, _errno.ENOENT, _errno.EEXIST,
        _errno.ENOSPC, _errno.EROFS, _errno.EISDIR, _errno.ENOTDIR,
        _errno.ENOTEMPTY, _errno.ENAMETOOLONG, _errno.EINVAL, _errno.EBADF,
    ) if e is not None
)


def is_cuda_error(e: BaseException) -> bool:
    """A CUDA launch or asynchronous error (sticky: the context is lost)."""
    if _ACCELERATOR_ERROR is not None and isinstance(e, _ACCELERATOR_ERROR):
        return True
    return isinstance(e, RuntimeError) and str(e).startswith(_CUDA_ERROR_PREFIX)


def is_transient(e: BaseException) -> bool:
    """True when retrying the failed call could plausibly succeed."""
    if isinstance(e, InjectedFault):
        return e.transient
    if not isinstance(e, Exception):
        return False  # KeyboardInterrupt / SystemExit / Preempted propagate
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    if is_cuda_error(e):
        return False
    if isinstance(e, _FATAL_TYPES):
        return False
    if isinstance(e, OSError):
        # connection drops / flaky mounts retry; deterministic filesystem
        # failures (ENOSPC, EACCES, ENOENT, ...) fail loud on attempt one
        if isinstance(e, _FATAL_OS_TYPES) or e.errno in _FATAL_ERRNOS:
            return False
        return True
    if type(e).__name__ in _TRANSIENT_TYPE_NAMES:
        return True
    return any(m in str(e) for m in _TRANSIENT_MARKERS)


class RetryPolicy:
    """Capped exponential backoff with jitter.

    Arguments default to the FLAGS_retry_* values at call time, so a policy
    object constructed once stays in sync with runtime flag changes; pass
    explicit values to pin a policy. The jitter draws from the policy's own
    ``random.Random`` (``rng``), never the module-global generator, so a
    caller's ``random.seed`` is neither consumed nor relied on."""

    def __init__(self, max_retries: Optional[int] = None,
                 backoff_ms: Optional[float] = None,
                 backoff_max_ms: Optional[float] = None,
                 jitter: float = 0.25, rng: Optional[random.Random] = None):
        self._max_retries = max_retries
        self._backoff_ms = backoff_ms
        self._backoff_max_ms = backoff_max_ms
        self.jitter = float(jitter)
        self._rng = rng if rng is not None else random.Random()

    @property
    def max_retries(self) -> int:
        if self._max_retries is not None:
            return self._max_retries
        return int(flags.flag("retry_max"))

    @property
    def backoff_ms(self) -> float:
        if self._backoff_ms is not None:
            return self._backoff_ms
        return float(flags.flag("retry_backoff_ms"))

    @property
    def backoff_max_ms(self) -> float:
        if self._backoff_max_ms is not None:
            return self._backoff_max_ms
        return float(flags.flag("retry_backoff_max_ms"))

    def delay_ms(self, attempt: int) -> float:
        """Backoff before retry `attempt` (1-based): base * 2^(attempt-1),
        capped, with multiplicative jitter so synchronized workers don't
        retry in lockstep."""
        base = self.backoff_ms * (2.0 ** max(0, attempt - 1))
        base = min(base, self.backoff_max_ms)
        if base <= 0:
            return 0.0
        return base * (1.0 + self.jitter * self._rng.random())


_default = RetryPolicy()


def default_policy() -> RetryPolicy:
    return _default
