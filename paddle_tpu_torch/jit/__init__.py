"""``paddle.jit`` for the port: the compiled training step
(``paddle_tpu/jit/__init__.py:339`` ``CompiledTrainStep``, ``:793``
``compile_train_step``).

``step(*batch)`` runs forward, loss, backward and the optimizer's update as
one training step and returns the loss; with ``grad_input_idx`` it returns
``(loss, [gradients of those batch arguments])``, as the JAX step does for
the parameter-server path, where embedding rows pulled from the host table
are batch inputs. The last batch argument is the loss function's label; the
others go to the model. It keeps the JAX contract of
``__call__``: the learning rate is read from ``optimizer.get_lr()`` on every
call, gradients are cast to their parameter's dtype, ``opt._step_count`` and
``opt._accumulators`` stay the source of truth, the optimizer's
``grad_clip`` clips the gradients first (as the JAX ``_make_step_fn``:473
does), and the optimizer's own rule does the update
(``optimizer.apply_update``: the rule alone, as the JAX step calls it; the
fused-update kernels belong to the eager ``step()``).

On a card the step is ONE CUDA graph per batch signature. The first
``WARMUP_STEPS`` calls of a signature run eagerly, on a side stream: they are real
training steps, and they build and load every kernel library and set every
kernel attribute before capture. The next call captures the whole step over
static input buffers, then replays it; later calls copy their batch into
those buffers and replay. Parameters and optimizer state are updated in
place by the graph: that is the analogue of the JAX step's buffer donation.
The learning rate and the beta-pow accumulators are device scalars the graph
reads, so a new ``set_lr()`` or a loaded state dict takes effect at the next
replay. Rebinding a parameter or a state tensor to new storage after capture
is not seen by the graph.

Dropout draws from the port's generator of the device (``core.random``),
the warm-up steps as any eager code does; the graph registers that generator
before its capture, so every replay draws new masks, as every JAX call draws
a new key. A recompute segment (``GPTConfig.use_recompute``) inside the
capture draws its forward and its recomputation from a pair of generator
states registered with the graph, one pair per segment the warm-up steps
counted, seeded before every replay from a key drawn from the device's
generator: ``paddle.set_rng_state`` brings back every mask of a replay.

A batch of ``paddle.Tensor``s is unwrapped (no copy) into the step's torch
inputs, and the model and the loss function get ``Tensor``s over them, as
the JAX step gives them (``paddle_tpu/jit/__init__.py:418-422``); the loss
comes back as a ``Tensor``. A batch of torch tensors runs on torch tensors
throughout and gets a torch loss back. Inside a capture the cells are made
around the static input buffers, so no cell outlives a replay.

On the CPU the same step function runs eagerly on every call. That is the
path the tests take, not a fallback: there is no graph on the CPU.

Not ported yet (ROADMAP, open items, queue 1 items 12 and 13): meshes and
input shardings, and the memory plan.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..core import cuda_graphs, dispatch
from ..core import random as _random
from ..optimizer.optimizer import apply_update

__all__ = ["CompiledTrainStep", "compile_train_step"]

WARMUP_STEPS = 2  # eager steps per batch signature before its graph is captured


class _Captured:
    """One batch signature's graph and its static buffers."""

    def __init__(self):
        self.eager_steps = 0
        self.segments = 0  # recompute segments per step, counted while warming up
        self.graph = None  # a cuda_graphs.Graph
        self.inputs = None
        self.out = None

    @property
    def pairs(self):
        """The recompute segments' generator pairs registered with the graph."""
        return None if self.graph is None else self.graph.pairs


class CompiledTrainStep:
    """Forward, backward and update as one step: one CUDA graph per batch
    signature on a card, eager on the CPU."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 grad_input_idx=()):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._grad_input_idx = tuple(int(i) for i in grad_input_idx)
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._captured: Dict[tuple, _Captured] = {}
        self._lr = None  # the device scalar a captured graph reads

    def _states(self):
        return [self.optimizer._state_of(p) for p in self._params]

    def _step_fn(self, batch, lr, states, as_tensors=False):
        """The whole step: loss, gradients, then the in-place update. Returns
        the loss and the gradients of the ``grad_input_idx`` batch inputs.
        With ``as_tensors`` the model and the loss function get Paddle
        Tensors over the batch's torch tensors."""
        model = self.model
        batch = list(batch)
        for i in self._grad_input_idx:
            batch[i] = batch[i].detach().requires_grad_()
        diff = [batch[i] for i in self._grad_input_idx]
        ins = [dispatch.wrap(b) for b in batch] if as_tensors else batch
        with torch.enable_grad():
            out = model(*ins[:-1]) if len(ins) > 1 else model(ins[0])
            loss = self.loss_fn(out, ins[-1]) if self.loss_fn is not None else out
            loss = dispatch.unwrap(loss)
            grads = torch.autograd.grad(loss, self._params + diff, allow_unused=True)
        grads, in_grads = list(grads[:len(self._params)]), grads[len(self._params):]
        clip = self.optimizer._grad_clip
        if clip is not None:
            grads = [g for _, g in clip(list(zip(self._params, grads)))]
        apply_update(self.optimizer, self._params, grads, lr, states)
        in_grads = [torch.zeros_like(x) if g is None else g for x, g in zip(diff, in_grads)]
        return loss.detach(), in_grads

    def _device(self):
        return self._params[0].device if self._params else torch.device("cpu")

    def __call__(self, *batch):
        device = self._device()
        as_tensors = dispatch.holds_tensor(batch, {})
        batch = [torch.as_tensor(dispatch.unwrap(b)).to(device) for b in batch]
        states = self._states()
        if device.type == "cuda":
            loss, in_grads = self._cuda_step(device, batch, states, as_tensors)
        else:
            lr = torch.tensor(self.optimizer.get_lr(), dtype=torch.float32, device=device)
            loss, in_grads = self._step_fn(batch, lr, states, as_tensors)
        self.optimizer._step_count += 1
        if as_tensors:
            loss, in_grads = dispatch.wrap(loss), dispatch.wrap(list(in_grads))
        if self._grad_input_idx:
            return loss, list(in_grads)
        return loss

    def _cuda_step(self, device, batch, states, as_tensors):
        if self._lr is None:
            self._lr = torch.empty((), dtype=torch.float32, device=device)
        self._lr.fill_(self.optimizer.get_lr())
        sig = (as_tensors,) + tuple((tuple(b.shape), b.dtype, b.device) for b in batch)
        entry = self._captured.setdefault(sig, _Captured())
        if entry.graph is None and entry.eager_steps < WARMUP_STEPS:
            with _random.counting_segments() as seen:
                out = cuda_graphs.warm_up(device, self._step_fn, batch, self._lr, states,
                                          as_tensors)
            entry.segments = seen.count
            entry.eager_steps += 1
            return out
        if entry.graph is None:
            entry.inputs = [b.clone() for b in batch]
            graph = cuda_graphs.Graph(device)
            with graph.capture(segments=entry.segments):
                entry.out = self._step_fn(entry.inputs, self._lr, states, as_tensors)
            entry.graph = graph
        cuda_graphs.copy_in(entry.inputs, batch)
        entry.graph.replay()
        # the static outputs are overwritten by the next replay: hand out copies
        loss, in_grads = entry.out
        return loss.clone(), [g.clone() for g in in_grads]


def compile_train_step(model, loss_fn, optimizer, mesh=None, in_shardings=None,
                       grad_input_idx=(), memory_plan=None):
    """``CompiledTrainStep`` over ``model``; the JAX function's mesh, sharding
    and memory-plan arguments are not ported yet."""
    for given, what in ((mesh is not None, "mesh"), (in_shardings is not None, "in_shardings"),
                        (memory_plan is not None, "memory_plan")):
        if given:
            raise NotImplementedError(
                f"compile_train_step({what}=...) is not ported yet (ROADMAP, open "
                "items, queue 1 items 12 and 13)"
            )
    return CompiledTrainStep(model, loss_fn, optimizer, grad_input_idx)
