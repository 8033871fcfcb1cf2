"""Optimizer base, Adam and AdamW: the port of ``paddle_tpu/optimizer/optimizer.py``.

Every optimizer defines a per-parameter update rule
``_update(p, g, lr, state, **hyper) -> (new_p, new_state)`` over tensors,
with the JAX rule's formulas in the same operand order. ``apply_update``
applies it to a list of parameters and writes the results IN PLACE into the
parameters and into the state tensors. The eager ``step()`` and the compiled
training step (``paddle_tpu_torch.jit``) both go through ``apply_update``, so
they share the optimizer's arithmetic, and a CUDA graph captured over it
keeps reading and writing the same storage.

State is one dict of tensors per parameter, on the parameter's device, in
``_accumulators`` keyed by ``id(param)``. ``lr`` reaches the rule as a 0-d
float32 tensor on that device. Not ported yet (ROADMAP, open items, queue 1
item 6): SGD, Momentum and the other optimizers, ``optimizer/lr.py``
schedulers, grad clip, and the lazy, offload and resilience hooks of
``step()``.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def param_name(p):
    """The parameter's Paddle name (``param_<n>``), or None for a tensor the
    port's layers did not make."""
    return getattr(p, "param_name", None)


@torch.no_grad()
def apply_update(opt, params, grads, lr, states):
    """One update of ``params`` by ``opt``'s rule, in place.

    ``grads[i]`` None counts as a zero gradient, as ``jax.grad`` gives for an
    unused parameter; a gradient of another dtype is cast to the
    parameter's. ``lr`` is a 0-d float32 tensor; ``states[i]`` is the state
    dict of ``params[i]``, overwritten in place."""
    rule = type(opt)._update
    hyper = opt._hyper()
    for p, g, st in zip(params, grads, states):
        if g is None:
            g = torch.zeros_like(p)
        if g.dtype != p.dtype:
            g = g.to(p.dtype)
        new_p, new_st = rule(opt, p, g, lr, st, **dict(hyper, **opt._per_param_hyper(p)))
        p.copy_(new_p)
        for key, value in new_st.items():
            st[key].copy_(value)


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
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "a learning-rate scheduler is not ported yet (ROADMAP, open "
                "items, queue 1 item 6: optimizer/lr.py); pass a number and "
                "call set_lr()"
            )
        if grad_clip is not None:
            raise NotImplementedError(
                "grad clip is not ported yet (ROADMAP, open items, queue 1 item 4: nn/clip.py)"
            )
        self._lr = float(learning_rate)
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
        return float(self._lr)

    def set_lr(self, value):
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
        """Update every parameter that has a gradient, in place."""
        params = [p for p in self._param_list() if p.requires_grad and p.grad is not None]
        self._step_count += 1
        if params:
            lr = torch.tensor(self.get_lr(), dtype=torch.float32, device=params[0].device)
            apply_update(self, params, [p.grad for p in params], lr,
                         [self._state_of(p) for p in params])

    def _param_list(self) -> List[torch.Tensor]:
        if self._parameters is None:
            raise ValueError("optimizer was created without a parameter list")
        return self._parameters

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        for p in self._param_list():
            p.grad = None

    # -- checkpoint ----------------------------------------------------------
    def state_dict(self):
        """``{"_step_count": n, "<param name or index>.<state key>": tensor}``,
        the JAX package's key names. The tensors are copies: a later step
        does not change a state dict already taken."""
        out = {"_step_count": self._step_count}
        for i, p in enumerate(self._param_list()):
            st = self._accumulators.get(id(p))
            if st:
                for k, v in st.items():
                    out[f"{param_name(p) or i}.{k}"] = v.detach().clone()
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load a ``state_dict()``. A state tensor that exists already is
        overwritten in place (a captured training step keeps reading it);
        values may be tensors or numpy arrays."""
        self._step_count = int(state_dict.get("_step_count", 0))
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

    def _apply_weight_decay_l2(self, g, p):
        if self._weight_decay:
            return g + self._weight_decay * p
        return g


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
