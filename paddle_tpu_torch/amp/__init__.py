"""``paddle.amp`` for the port: ``auto_cast`` with the O1 cast lists,
``decorate`` and ``GradScaler`` (``paddle_tpu/amp/__init__.py``).

O1 (``auto_cast``) casts per op by the lists below. The port has no per-op
dispatcher, so each function of the port that the JAX package routes through
``apply`` under one of these names calls ``maybe_cast_inputs`` itself, after
choosing its lowering, as the JAX dispatcher does: ``nn.functional.linear``,
``layer_norm``, ``softmax``, ``cross_entropy`` (``softmax_with_cross_entropy``),
``scaled_dot_product_attention`` (``flash_sdpa`` or ``sdpa``) and GPT's tied
head (``matmul``). Ops on neither list keep their inputs' dtypes, and a
low-precision tensor added to an f32 one gives f32, as in jnp.

O2 (``decorate``) casts the model's floating parameters and buffers to the
low dtype and wraps ``forward`` to cast floating tensor inputs to it. The
optimizer state then takes the parameters' dtype (bf16 moments under O2
bf16), as in the JAX package. O1 leaves the model as it is.

``GradScaler`` is dynamic loss scaling with the JAX scaler's state machine.
Its ``unscale_`` reduces the non-finite check over every gradient on the
device and reads one bool, where the JAX one reads one per gradient; under
``FLAGS_numeric_rescue`` it skips the check and the optimizer's sentinel
marks the scaler instead (``resilience.rescue.handle_sentinel``).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.dtype import to_torch_dtype

__all__ = ["auto_cast", "autocast", "decorate", "GradScaler", "amp_guard",
           "is_bfloat16_supported", "is_float16_supported"]

# paddle_tpu/amp/__init__.py:31-40: ops safe to run in low precision
# (matmul heavy) and ops that must stay f32
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "sdpa", "flash_sdpa",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "mean", "sum", "softmax",
    "log_softmax", "softmax_with_cross_entropy", "cross_entropy",
    "layer_norm", "batch_norm", "batch_norm_infer", "group_norm", "norm",
    "reduce_sum", "pow", "square", "cumsum",
}
_LOW = (torch.bfloat16, torch.float16)

_state = threading.local()


def _amp_state():
    if not hasattr(_state, "level"):
        _state.level = "O0"
        _state.dtype = "bfloat16"
        _state.custom_white = set()
        _state.custom_black = set()
    return _state


def amp_active():
    return _amp_state().level in ("O1", "O2")


def amp_dtype():
    return _amp_state().dtype


def maybe_cast_inputs(op_name: str, tensors):
    """``tensors`` cast for the op ``op_name`` by the O1 lists: a white-listed
    op's floating inputs to the low dtype, a black-listed op's bf16 and fp16
    inputs to f32; anything else, and every input outside O1, as it is."""
    st = _amp_state()
    if st.level != "O1":
        return list(tensors)
    name = op_name.split(":")[-1]
    if name in (WHITE_LIST | st.custom_white) - st.custom_black:
        low = to_torch_dtype(st.dtype)
        return [t.to(low) if isinstance(t, torch.Tensor) and t.is_floating_point() else t
                for t in tensors]
    if name in (BLACK_LIST | st.custom_black):
        return [t.float() if isinstance(t, torch.Tensor) and t.dtype in _LOW else t
                for t in tensors]
    return list(tensors)


def state():
    """This thread's cast state, for ``restored`` (a recompute segment
    recasts its forward in the backward, which may run on another thread)."""
    st = _amp_state()
    return st.level, st.dtype, set(st.custom_white), set(st.custom_black)


@contextlib.contextmanager
def restored(saved):
    st = _amp_state()
    prev = (st.level, st.dtype, st.custom_white, st.custom_black)
    st.level, st.dtype, st.custom_white, st.custom_black = saved
    try:
        yield
    finally:
        st.level, st.dtype, st.custom_white, st.custom_black = prev


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast``: O1 casts per op inside the ``with`` block."""
    return restored((level if enable else "O0", dtype, set(custom_white_list or ()),
                     set(custom_black_list or ())))


autocast = auto_cast
amp_guard = auto_cast


def _wrap_forward(m: torch.nn.Module, low: torch.dtype):
    orig = m.forward

    def forward(*args, **kw):
        # pure-low-precision mode casts floating inputs at model entry
        def cast(a):
            if isinstance(a, torch.Tensor) and a.is_floating_point() and a.dtype != low:
                return a.to(low)
            return a

        return orig(*[cast(a) for a in args], **{k: cast(v) for k, v in kw.items()})

    m.forward = forward


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: parameters in ``dtype``, floating inputs cast at model entry.

    Returns ``models`` (or ``(models, optimizers)`` when optimizers are given)."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        low = to_torch_dtype(dtype)
        for m in model_list:
            m.to(dtype=low)
            _wrap_forward(m, low)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


def is_bfloat16_supported(place=None):
    return True


def is_float16_supported(place=None):
    return True


class GradScaler:
    """Dynamic loss scaling (``paddle_tpu/amp/__init__.py:157``): the loss is
    multiplied by the scale, the gradients divided by it before the step; a
    step with a non-finite gradient is skipped, and ``update()`` halves the
    scale after ``decr_every_n_nan_or_inf`` such steps and doubles it after
    ``incr_every_n_steps`` good ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale in place and note whether any
        is non-finite: per dtype one multi-tensor divide and one multi-tensor
        check into a single flag, then one host read; no check while
        ``FLAGS_numeric_rescue`` is set (the optimizer's sentinel checks the
        gradients in its update and marks this scaler)."""
        if not self._enable:
            return
        from ..resilience import rescue as _rescue

        by_dtype: dict = {}
        for p in optimizer._param_list():
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        found_inf = None
        for grads in by_dtype.values():
            torch._foreach_div_(grads, self._scale)
            if not _rescue.active():
                if found_inf is None:
                    found_inf = torch.zeros(1, device=grads[0].device)
                    one = torch.ones(1, device=grads[0].device)
                # multiplies by 1: a no-op but for the flag it sets
                torch._amp_foreach_non_finite_check_and_unscale_(grads, found_inf, one)
        self._found_inf = found_inf is not None and bool(found_inf.item())
        self._unscaled = True

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        # a step that the rescue sentinel skips marks found_inf, so update()
        # backs the scale off as if the scan above had caught it
        optimizer._rescue_scaler = self
        try:
            if not self._found_inf:
                optimizer.step()
        finally:
            optimizer._rescue_scaler = None
        self._unscaled = False

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, d):
        self._scale = d["scale"]
        self._good_steps = d.get("good_steps", 0)
        self._bad_steps = d.get("bad_steps", 0)
