"""Step-level numeric rescue over the fused non-finite sentinel: the port of
``paddle_tpu/resilience/rescue.py``.

With FLAGS_numeric_rescue set, the fused optimizer update
(``optimizer.make_fused_update``) computes one extra 0-d device bool,
``any(~isfinite(g))`` over every gradient, and gates the whole update on it
on the device: a step with a non-finite gradient leaves params and optimizer
state untouched. The host then reads the sentinel, once per step, and applies
the configured policy:

    skip        drop the step (the update was already suppressed)
    lr_backoff  drop the step AND multiply the lr by
                FLAGS_numeric_rescue_lr_factor (a loss-spike brake)
    abort       raise FloatingPointError (fail fast, e.g. under a debugger)

Each rescue and each lr back-off is counted in ``counters``, under the JAX
package's counter names, and each rescue emits a ``rescue`` event into the
flight recorder and dumps a ``numeric_rescue`` postmortem (a no-op unless
FLAGS_postmortem_dir is set). The step number is the resilience runtime's
(``faults.current_step()``), as in the JAX package. A rescued step inside
``amp.GradScaler.step`` marks the scaler's found_inf (the optimizer's
``_rescue_scaler``), so dynamic loss scaling backs off as if its own check
had caught the step.
"""
from __future__ import annotations

import warnings
from typing import Optional

from ..core import flags

__all__ = [
    "Abort",
    "LRBackoff",
    "RescuePolicy",
    "SkipStep",
    "active",
    "counters",
    "handle_sentinel",
    "mode",
    "policy",
    "reset_counters",
]

counters = {"numeric_rescues": 0, "rescue_lr_backoffs": 0}


def reset_counters():
    for key in counters:
        counters[key] = 0


def mode() -> str:
    return str(flags.flag("numeric_rescue"))


def active() -> bool:
    return mode() != ""


class RescuePolicy:
    """What to do, beyond the on-device update suppression, when the
    sentinel reports non-finite gradients."""

    name = ""

    def apply(self, optimizer):
        raise NotImplementedError


class SkipStep(RescuePolicy):
    name = "skip"

    def apply(self, optimizer):
        pass  # update already suppressed on the device


class LRBackoff(RescuePolicy):
    name = "lr_backoff"

    def apply(self, optimizer):
        factor = float(flags.flag("numeric_rescue_lr_factor"))
        try:
            optimizer.set_lr(optimizer.get_lr() * factor)
            counters["rescue_lr_backoffs"] += 1
        except RuntimeError:
            # scheduler-driven lr: the optimizer refuses set_lr; degrade to
            # skip-step and say so
            warnings.warn(
                "numeric_rescue=lr_backoff: optimizer lr is scheduler-driven; "
                "rescued steps are skipped without backing off the lr",
                stacklevel=3,
            )


class Abort(RescuePolicy):
    name = "abort"

    def apply(self, optimizer):
        raise FloatingPointError(
            "non-finite gradients at optimizer.step "
            f"(step {_current_step()}): numeric_rescue=abort"
        )


def _current_step() -> int:
    from . import faults

    return faults.current_step()


_POLICIES = {p.name: p for p in (SkipStep(), LRBackoff(), Abort())}


def policy() -> Optional[RescuePolicy]:
    m = mode()
    if not m:
        return None
    pol = _POLICIES.get(m)
    if pol is None:
        raise ValueError(
            f"unknown FLAGS_numeric_rescue policy {m!r}: expected one of "
            f"{sorted(_POLICIES)}"
        )
    return pol


def handle_sentinel(optimizer, bad) -> bool:
    """Read the sentinel on the host; on non-finite apply the policy.

    Returns True when the step was rescued (params and state unchanged).
    Reading ``bad`` waits for the update already queued on the device; it
    launches nothing."""
    if not bool(bad):
        return False
    from ..profiler import trace

    counters["numeric_rescues"] += 1
    step = _current_step()
    trace.emit("rescue", site="optimizer", policy=mode(), step=step)
    trace.dump_postmortem("numeric_rescue", policy=mode(), step=step)
    scaler = getattr(optimizer, "_rescue_scaler", None)
    if scaler is not None:
        scaler._found_inf = True
    pol = policy()
    if pol is not None:
        pol.apply(optimizer)
    return True
