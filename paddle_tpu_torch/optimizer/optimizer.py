"""Optimizer base, SGD, Momentum, Adam, AdamW, Adamax, Adagrad, Adadelta,
RMSProp, Lamb and Lars: the port of ``paddle_tpu/optimizer/optimizer.py``.

Every optimizer defines a per-parameter update rule
``_update(p, g, lr, state, **hyper) -> (new_p, new_state)`` over tensors,
with the JAX rule's formulas in the same operand order. Two appliers write
its results IN PLACE into the parameters and the state tensors:

  - ``make_fused_update`` is the eager ``step()``'s, as in the JAX package:
    with ``FLAGS_pallas_fused_update`` on, a parameter of a stock SGD,
    Momentum or Adam rule goes through its hand-written fused-update kernel
    (``ops/kernels/fused_update.py``); with ``FLAGS_numeric_rescue`` set it
    folds the step's non-finite sentinel over every grad and gates the whole
    update on it on the device;
  - ``apply_update`` is the rule alone, the compiled training step's
    (``paddle_tpu_torch.jit``), as the JAX ``_make_step_fn`` calls the rule
    directly. A CUDA graph captured over it keeps reading and writing the
    same storage.

``step()`` applies the optimizer's ``grad_clip`` first and reads the lr
through ``get_lr()``, which calls an ``LRScheduler`` when one was given. It
is the training step boundary of the resilience runtime: the fused update
launches under ``resilience.runtime.execute("optimizer", ...)``, a
``nan:grads`` fault clause poisons the first gradient, and ``step()`` ends
with ``on_step_end()`` whatever happened.
State is one dict of tensors per parameter, on the parameter's device, in
``_accumulators`` keyed by ``id(param)``. ``lr`` reaches the rule as a 0-d
float32 tensor on that device. Only SGD, Momentum and Adam have fused
kernels (``fused_update.rule_kind``); every other rule runs its torch ops on
both appliers, as in the JAX package.

``step()`` is also the whole-step capture's boundary
(``paddle_tpu/optimizer/optimizer.py:194-212``): ``lazy.step_capture_step``
first flushes the pending lazy segment and observes the step, or runs a
deferred step as one captured program, in which case ``step()`` only
counts it. The captured program runs ``_update_params``, the same clip
and update as the eager step, with the learning rate from a device scalar.
Not ported yet (ROADMAP, open items, queue 1 item 12): the offload hooks
of ``step()`` and the fused telemetry output.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .. import profiler
from ..core import lazy as _lazy
from ..ops.kernels import fused_update as _fu
from ..ops.nn_ops import promoted
from ..resilience import faults as _faults
from ..resilience import rescue as _rescue
from ..resilience import runtime as _rrt
from .lr import LRScheduler


def param_name(p):
    """The parameter's Paddle name (``param_<n>``), or None for a tensor the
    port's layers did not make."""
    return getattr(p, "param_name", None)


def _rule_update(opt, p, g, lr, st, hyper, bad=None):
    """``opt``'s rule over one parameter, written in place into p and its
    state; with a sentinel ``bad``, where-gated so that a set one keeps
    every old value.

    A result whose dtype is not its tensor's replaces the tensor's storage
    instead (``p.data``, the state dict's entry), as the JAX step rebinds
    every result: Lamb's update of a bf16 parameter is f32 there (bf16
    moments over f32 beta pows promote), so under AMP O2 the parameters and
    then the moments turn f32 after the first steps. Never inside a CUDA
    graph capture, whose replays would go on reading the old storage."""
    new_p, new_st = type(opt)._update(opt, p, g, lr, st, **hyper)
    if bad is not None:
        new_p = torch.where(bad, p, new_p)
        new_st = {k: torch.where(bad, st[k], v) for k, v in new_st.items()}
    if new_p.dtype == p.dtype:
        p.copy_(new_p)
    else:
        _check_not_capturing(p, new_p.dtype)
        p.data = new_p
    for key, value in new_st.items():
        if value.dtype == st[key].dtype:
            st[key].copy_(value)
        else:
            _check_not_capturing(p, value.dtype)
            st[key] = value


def _check_not_capturing(p, dtype):
    if p.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"an optimizer update turns a {p.dtype} parameter's state into {dtype} inside a "
            "CUDA graph capture; run the steps that change dtypes eagerly first"
        )


@torch.no_grad()
def apply_update(opt, params, grads, lr, states):
    """One update of ``params`` by ``opt``'s rule, in place.

    ``grads[i]`` None counts as a zero gradient, as ``jax.grad`` gives for an
    unused parameter; a gradient of another dtype is cast to the
    parameter's. ``lr`` is a 0-d float32 tensor; ``states[i]`` is the state
    dict of ``params[i]``, overwritten in place."""
    hyper = opt._hyper()
    for p, g, st in zip(params, grads, states):
        if g is None:
            g = torch.zeros_like(p)
        if g.dtype != p.dtype:
            g = g.to(p.dtype)
        _rule_update(opt, p, g, lr, st, dict(hyper, **opt._per_param_hyper(p)))


def make_fused_update(opt, params, sentinel=False, telemetry=False):
    """The eager step's in-place multi-tensor update applier,
    ``(params, grads, lr, states) -> bad``, over ``opt``'s rule for ``params``
    (``paddle_tpu/optimizer/optimizer.py:30``).

    Per parameter the grad is cast to the parameter's dtype, then either
    the fused kernel runs (``FLAGS_pallas_fused_update`` on, a stock SGD,
    Momentum or Adam rule, and ``supported()``), or the rule's torch ops.
    With ``sentinel=True`` the applier first folds ``any(~isfinite(g))``
    over every grad into one 0-d device bool and returns it: the kernel
    gates its own writes on it, and the rule's results are where-gated, so
    a non-finite step leaves every parameter and state tensor as it was.
    Without the sentinel it returns None. ``telemetry`` is not ported."""
    if telemetry:
        raise NotImplementedError(
            "make_fused_update(telemetry=True) is not ported yet (ROADMAP, open "
            "items, queue 1 item 12: the profiler's fused numerics telemetry)"
        )
    hypers = [dict(opt._hyper(), **opt._per_param_hyper(p)) for p in params]
    kind = _fu.rule_kind(type(opt)) if _fu.enabled() else None

    @torch.no_grad()
    def apply(params, grads, lr, states):
        bad = None
        if sentinel:
            bad = torch.zeros((), dtype=torch.bool, device=lr.device)
            for g in grads:
                bad = bad | ~torch.isfinite(g).all()
        for p, g, st, hy in zip(params, grads, states, hypers):
            if g.dtype != p.dtype:
                g = g.to(p.dtype)
            if kind is not None and _fu.supported(kind, p, g, st):
                # gated inside the kernel: not gated again here
                _fu.param_update(kind, p, g, lr, st, hy, wd=opt._weight_decay, bad=bad)
            else:
                _rule_update(opt, p, g, lr, st, hy, bad)
        return bad

    return apply


class Optimizer:
    def __init__(
        self,
        learning_rate=0.001,
        parameters=None,
        weight_decay=None,
        grad_clip=None,
        name=None,
        multi_precision=False,
    ):
        self._lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                    else float(learning_rate))
        self._grad_clip = grad_clip
        self._parameters = list(parameters) if parameters is not None else None
        self._weight_decay = self._parse_wd(weight_decay)
        # per-parameter optimizer state: id(param) -> dict[str, torch.Tensor]
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    @staticmethod
    def _parse_wd(weight_decay):
        if weight_decay is None:
            return 0.0
        if isinstance(weight_decay, float):
            return weight_decay
        # L2Decay regularizer object
        coeff = getattr(weight_decay, "_coeff", None)
        return float(coeff) if coeff is not None else float(weight_decay)

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError(
                "optimizer's learning rate is an LRScheduler; call scheduler.step()"
            )
        self._lr = float(value)

    # -- state rules (override per optimizer) --------------------------------
    def _create_state(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, p, g, lr, state, **hyper):
        raise NotImplementedError

    def _hyper(self) -> Dict:
        """Hyper-parameters every parameter's update takes."""
        return {}

    def _per_param_hyper(self, p) -> Dict:
        """Per-parameter hyper overrides (e.g. no-decay params)."""
        return {}

    def _state_of(self, p) -> Dict[str, torch.Tensor]:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._create_state(p)
            self._accumulators[id(p)] = st
        return st

    # -- main API ------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient, in place: the grad
        clip, then the fused update (``make_fused_update``), then the
        numeric-rescue policy when ``FLAGS_numeric_rescue`` is set; then the
        resilience step boundary. A deferred whole step runs here as one
        captured program instead (``core/lazy.py``)."""
        try:
            if _lazy.step_capture_step(self):
                self._step_count += 1
                return
            self._step_count += 1
            if self._update_params():
                profiler.count_program("optimizer")
        finally:
            # advances the fault-injection step counter, the ladder's
            # cooldown clocks and the 'train' heartbeat
            _rrt.on_step_end()

    def _update_params(self, lr=None, clip_fn=None) -> bool:
        """The update of ``step()``: the clip over the parameters that have a
        gradient (``clip_fn``, the pure form of a stock clip that a captured
        step passes, else the optimizer's ``grad_clip``), then the fused
        update with ``lr`` (a 0-d float32 device tensor; ``get_lr()`` when
        None). Returns whether anything had a gradient."""
        params_grads = [(p, p.grad) for p in self._param_list()
                        if p.requires_grad and p.grad is not None]
        if clip_fn is not None:
            clipped = iter(clip_fn([g for _, g in params_grads]))
            params_grads = [(p, next(clipped)) for p, _ in params_grads]
        elif self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        if params_grads:
            self._apply_fused(params_grads, lr)
        return bool(params_grads)

    def _apply_fused(self, params_grads, lr=None):
        params = [p for p, _ in params_grads]
        grads = [g for _, g in params_grads]
        # chaos harness: a `nan:grads` clause poisons the first gradient this
        # step (a new tensor: p.grad stays as it was); the numeric-rescue
        # sentinel must catch it
        plan = _faults.active_plan()
        if plan is not None and plan.nan_fires("grads", _faults.current_step()):
            profiler.count("injected_faults")
            grads[0] = torch.full_like(grads[0], float("nan"))
        sentinel = _rescue.active()
        states = [self._state_of(p) for p in params]
        # a fill on the device, not a copy from the host: nothing here
        # waits for the card
        if lr is None:
            lr = torch.full((), self.get_lr(), dtype=torch.float32, device=params[0].device)
        update = make_fused_update(self, params, sentinel=sentinel)
        # the kernels write p, m and v IN PLACE, where the JAX update is
        # pure: a real fault after the launch may have applied part of the
        # update, so it must propagate, never re-run (retry_unsafe). An
        # injected fault is raised before the launch and still retries.
        bad = _rrt.execute("optimizer", lambda: update(params, grads, lr, states),
                           retry_unsafe=True)
        if bad is not None:
            # the one host read of the step: applies skip / lr_backoff / abort
            _rescue.handle_sentinel(self, bad)

    def _param_list(self) -> List[torch.Tensor]:
        if self._parameters is None:
            raise ValueError("optimizer was created without a parameter list")
        return self._parameters

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        """reference: optimizer.py:1120, backward and apply."""
        loss.backward()
        self.step()
        return None, None

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        for p in self._param_list():
            p.grad = None

    clear_gradients = clear_grad

    # -- checkpoint ----------------------------------------------------------
    def state_dict(self):
        """``{"_step_count": n, "<param name or index>.<state key>": tensor}``,
        the JAX package's key names, and ``"LR_Scheduler"`` with the
        scheduler's state when the lr is one. The tensors are copies: a later
        step does not change a state dict already taken."""
        out = {"_step_count": self._step_count}
        for i, p in enumerate(self._param_list()):
            st = self._accumulators.get(id(p))
            if st:
                for k, v in st.items():
                    out[f"{param_name(p) or i}.{k}"] = v.detach().clone()
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load a ``state_dict()``. A state tensor that exists already is
        overwritten in place (a captured training step keeps reading it);
        values may be tensors or numpy arrays."""
        self._step_count = int(state_dict.get("_step_count", 0))
        if "LR_Scheduler" in state_dict and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        for i, p in enumerate(self._param_list()):
            prefix = f"{param_name(p) or i}."
            st = {
                k[len(prefix):]: v for k, v in state_dict.items()
                if isinstance(k, str) and k.startswith(prefix)
            }
            if not st:
                continue
            cur = self._state_of(p)
            for k, v in st.items():
                v = torch.as_tensor(v)
                if k in cur and cur[k].shape == v.shape and cur[k].dtype == v.dtype:
                    cur[k].copy_(v)
                else:
                    cur[k] = v.to(p.device).clone()

    set_dict = set_state_dict

    def _apply_weight_decay_l2(self, g, p):
        if self._weight_decay:
            return g + self._weight_decay * p
        return g


class SGD(Optimizer):
    """reference: phi/kernels/sgd_kernel.h."""

    def _update(self, p, g, lr, state):
        g = self._apply_weight_decay_l2(g, p)
        return p - lr.to(p.dtype) * g, state


class Momentum(Optimizer):
    """reference: phi momentum_kernel; ``use_nesterov`` supported."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _hyper(self):
        return {"mu": self._momentum, "nesterov": self._nesterov}

    def _create_state(self, p):
        return {"velocity": torch.zeros_like(p, memory_format=torch.contiguous_format)}

    def _update(self, p, g, lr, state, *, mu, nesterov):
        g = self._apply_weight_decay_l2(g, p)
        v = mu * state["velocity"] + g
        step = g + mu * v if nesterov else v
        return p - lr.to(p.dtype) * step, {"velocity": v}


class Adam(Optimizer):
    """Bias-corrected Adam with beta-pow accumulators, L2 decay folded into g."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _hyper(self):
        return {"b1": self._beta1, "b2": self._beta2, "eps": self._epsilon}

    def _create_state(self, p):
        # the moments take the parameter's dtype: bf16 under AMP O2, as in
        # the JAX package; the beta pows are f32 scalars
        return {
            "moment1": torch.zeros_like(p, memory_format=torch.contiguous_format),
            "moment2": torch.zeros_like(p, memory_format=torch.contiguous_format),
            "beta1_pow": torch.ones((), dtype=torch.float32, device=p.device),
            "beta2_pow": torch.ones((), dtype=torch.float32, device=p.device),
        }

    def _update(self, p, g, lr, state, *, b1, b2, eps):
        g = self._apply_weight_decay_l2(g, p)
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * torch.square(g)
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        lr_t = (lr * torch.sqrt(1 - b2p) / (1 - b1p)).to(p.dtype)
        new_p = p - lr_t * m / (torch.sqrt(v) + eps)
        return new_p, {
            "moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p,
        }


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p·(1 − lr·wd) − lr_t·m/(√v + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd_coeff = (
            float(weight_decay._coeff) if hasattr(weight_decay, "_coeff")
            else float(weight_decay)
        )
        self._apply_decay_param_fun = apply_decay_param_fun

    def _hyper(self):
        return {"b1": self._beta1, "b2": self._beta2, "eps": self._epsilon,
                "wd": self._wd_coeff}

    def _update(self, p, g, lr, state, *, b1, b2, eps, wd):
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * torch.square(g)
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        lr_t = (lr * torch.sqrt(1 - b2p) / (1 - b1p)).to(p.dtype)
        new_p = p * (1.0 - (lr * wd).to(p.dtype)) - lr_t * m / (torch.sqrt(v) + eps)
        return new_p, {
            "moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p,
        }

    def _per_param_hyper(self, p):
        if self._apply_decay_param_fun is not None and not self._apply_decay_param_fun(
            param_name(p)
        ):
            return {"wd": 0.0}
        return {}


class Adamax(Optimizer):
    """Adam over the infinity norm: ``u = max(b2·u, |g|)``, bias-corrected
    first moment, L2 decay folded into g."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _hyper(self):
        return {"b1": self._beta1, "b2": self._beta2, "eps": self._epsilon}

    def _create_state(self, p):
        return {
            "moment": torch.zeros_like(p, memory_format=torch.contiguous_format),
            "inf_norm": torch.zeros_like(p, memory_format=torch.contiguous_format),
            "beta1_pow": torch.ones((), dtype=torch.float32, device=p.device),
        }

    def _update(self, p, g, lr, state, *, b1, b2, eps):
        g = self._apply_weight_decay_l2(g, p)
        m = b1 * state["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * state["inf_norm"], torch.abs(g))
        b1p = state["beta1_pow"] * b1
        new_p = p - (lr / (1 - b1p)).to(p.dtype) * m / (u + eps)
        return new_p, {"moment": m, "inf_norm": u, "beta1_pow": b1p}


class Adagrad(Optimizer):
    """Per-element lr over the root of the summed squared gradients."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, initial_accumulator_value=0.0,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _hyper(self):
        return {"eps": self._epsilon}

    def _create_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          memory_format=torch.contiguous_format)}

    def _update(self, p, g, lr, state, *, eps):
        g = self._apply_weight_decay_l2(g, p)
        acc = state["moment"] + torch.square(g)
        return p - lr.to(p.dtype) * g / (torch.sqrt(acc) + eps), {"moment": acc}


class Adadelta(Optimizer):
    """Step scaled by the ratio of running RMS of updates and of gradients."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _hyper(self):
        return {"eps": self._epsilon, "rho": self._rho}

    def _create_state(self, p):
        return {
            "avg_squared_grad": torch.zeros_like(p, memory_format=torch.contiguous_format),
            "avg_squared_update": torch.zeros_like(p, memory_format=torch.contiguous_format),
        }

    def _update(self, p, g, lr, state, *, eps, rho):
        g = self._apply_weight_decay_l2(g, p)
        asg = rho * state["avg_squared_grad"] + (1 - rho) * torch.square(g)
        update = (
            torch.sqrt(state["avg_squared_update"] + eps) / torch.sqrt(asg + eps) * g
        )
        asu = rho * state["avg_squared_update"] + (1 - rho) * torch.square(update)
        return p - lr.to(p.dtype) * update, {
            "avg_squared_grad": asg, "avg_squared_update": asu,
        }


class RMSProp(Optimizer):
    """Step over the root of the running mean square (centered: minus the
    running mean's square), with momentum."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _hyper(self):
        return {"rho": self._rho, "eps": self._epsilon,
                "mu": self._momentum, "centered": self._centered}

    def _create_state(self, p):
        return {
            "mean_square": torch.zeros_like(p, memory_format=torch.contiguous_format),
            "mean_grad": torch.zeros_like(p, memory_format=torch.contiguous_format),
            "momentum": torch.zeros_like(p, memory_format=torch.contiguous_format),
        }

    def _update(self, p, g, lr, state, *, rho, eps, mu, centered):
        g = self._apply_weight_decay_l2(g, p)
        ms = rho * state["mean_square"] + (1 - rho) * torch.square(g)
        if centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - torch.square(mg) + eps)
        else:
            mg = state["mean_grad"]
            denom = torch.sqrt(ms + eps)
        mom = mu * state["momentum"] + lr.to(p.dtype) * g / denom
        return p - mom, {"mean_square": ms, "mean_grad": mg, "momentum": mom}


class Lamb(Optimizer):
    """Adam's bias-corrected step plus decoupled decay, scaled per parameter
    by the trust ratio ||w|| / ||r|| (1 where either norm is 0).

    ``exclude_from_weight_decay_fn`` is accepted and, as in the JAX package,
    never read: every parameter decays. The bias corrections promote as jnp
    does: under AMP O2 a bf16 moment over an f32 beta pow gives f32, so the
    first update turns the parameters f32 and the second the moments, as in
    the JAX package (``_rule_update``)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _hyper(self):
        return {"b1": self._beta1, "b2": self._beta2, "eps": self._epsilon,
                "wd": self._wd}

    def _create_state(self, p):
        return {
            "moment1": torch.zeros_like(p, memory_format=torch.contiguous_format),
            "moment2": torch.zeros_like(p, memory_format=torch.contiguous_format),
            "beta1_pow": torch.ones((), dtype=torch.float32, device=p.device),
            "beta2_pow": torch.ones((), dtype=torch.float32, device=p.device),
        }

    def _update(self, p, g, lr, state, *, b1, b2, eps, wd):
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * torch.square(g)
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        # jnp divides a bf16 moment by an f32 beta pow in f32; torch would
        # keep a 0-d divisor's type out of the result
        m_hat = torch.div(*promoted(m, 1 - b1p))
        v_hat = torch.div(*promoted(v, 1 - b2p))
        r = m_hat / (torch.sqrt(v_hat) + eps) + wd * p
        w_norm = torch.sqrt(torch.sum(torch.square(p)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        # on the device: a captured step reads no value on the host
        ratio = w_norm / r_norm
        trust = torch.where((w_norm > 0) & (r_norm > 0), ratio,
                            torch.ones_like(ratio)).to(p.dtype)
        return p - lr.to(p.dtype) * trust * r, {
            "moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p,
        }


class Lars(Optimizer):
    """LARS, layer-wise adaptive rate scaling for large-batch SGD:
    ``local_lr = lr·coeff·||w|| / (||g|| + wd·||w|| + eps)`` (1 where either
    norm is 0), momentum on the decayed gradient. A parameter whose
    ``param_name`` contains a fragment of ``exclude_from_weight_decay`` does
    not decay (the JAX optimizer matches ``p.name``)."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, exclude_from_weight_decay=None,
                 epsilon=0.0, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._wd = lars_weight_decay
        self._eps = epsilon
        self._exclude = list(exclude_from_weight_decay or [])

    def _hyper(self):
        return {"mu": self._momentum, "coeff": self._coeff, "wd": self._wd,
                "eps": self._eps}

    def _per_param_hyper(self, p):
        name = param_name(p) or ""
        if any(frag in name for frag in self._exclude):
            return {"wd": 0.0}
        return {}

    def _create_state(self, p):
        return {"velocity": torch.zeros_like(p, memory_format=torch.contiguous_format)}

    def _update(self, p, g, lr, state, *, mu, coeff, wd, eps):
        w_norm = torch.sqrt(torch.sum(torch.square(p)))
        g_norm = torch.sqrt(torch.sum(torch.square(g)))
        ratio = coeff * w_norm / (g_norm + wd * w_norm + eps)
        local_lr = torch.where((w_norm > 0) & (g_norm > 0), ratio,
                               torch.ones_like(ratio)).to(p.dtype)
        step = g + wd * p
        v = mu * state["velocity"] + (lr.to(p.dtype) * local_lr) * step
        return p - v, {"velocity": v}
