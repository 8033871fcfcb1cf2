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

The ops plane: a captured step registers with the attribution registry as
``captured:<sig>``, its IR recorded during the capture, and feeds it each
replay's device ms (the replay's CUDA event pair, read at the next replay).
Under FLAGS_telemetry the update computes the fused telemetry rows
(``apply_update(telemetry=True)``, the rule path) and the step hands them
to the lagged reader (``profiler.attribution.push_telemetry``); the flag
keys the graph.

The memory plan (``memory_plan=``; FLAGS_memory_plan with
FLAGS_memory_budget_mb): a ``analysis.plan.RematPlan`` names the layer calls
of the forward that run as recompute segments; the step applies it around
its forward (``plan.bind``), in the warm-up steps and the capture alike, so
the graph replays the recomputation. ``"auto"`` plans against the budget
after the signature's first step, over that step's recording, and applies
the plan from the next step on; an explicit plan applies from the first
step. A signature's recorded step (``memory_plan()``, ``plan_remat()`` and
the donation gate read it) is its first on the CPU; on the card its capture,
or its first warm-up under a memory plan or FLAGS_check_programs. A plan
whose forward op count differs from the recorded step's is stale: it is
dropped, counted (``memory_plan_failures``) and the step trains unplanned.
Under
FLAGS_check_programs=2 the planned step's recording is certified equivalent
to the unplanned one's (``analysis.equivalence``) before its graph is
captured; under FLAGS_check_programs >= 1 every call scans the parameters
and states the step writes in place for live external aliases
(``analysis.memory.donation_gate``).

Not ported yet (ROADMAP, open items, queue 1 item 13): meshes and input
shardings.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

from ..core import cuda_graphs, dispatch
from ..core import flags as _flags
from ..core import random as _random
from .. import analysis
from ..optimizer.optimizer import apply_update
from ..profiler import attribution as _attribution

__all__ = ["CompiledTrainStep", "compile_train_step"]

WARMUP_STEPS = 2  # eager steps per batch signature before its graph is captured


class _Captured:
    """One batch signature's graph and its static buffers."""

    def __init__(self):
        self.plan = None  # the RematPlan applied to this signature's steps
        self.resolved = False  # whether the plan was resolved
        self.ir = None  # the recorded IR of its first step (analysis.Program)
        self.labels = None  # {value id: label} of that recording's inputs
        self.eager_steps = 0
        self.segments = 0  # recompute segments per step, counted while warming up
        self.graph = None  # a cuda_graphs.Graph
        self.inputs = None
        self.out = None
        self.tele = None  # the graph's fused telemetry vector (FLAGS_telemetry)
        self.key = None  # the attribution key, captured:<sig>
        self.timing = None  # (start, end) CUDA events of the last replay

    @property
    def pairs(self):
        """The recompute segments' generator pairs registered with the graph."""
        return None if self.graph is None else self.graph.pairs


class CompiledTrainStep:
    """Forward, backward and update as one step: one CUDA graph per batch
    signature on a card, eager on the CPU."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 grad_input_idx=(), memory_plan=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._grad_input_idx = tuple(int(i) for i in grad_input_idx)
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._captured: Dict[tuple, _Captured] = {}
        self._lr = None  # the device scalar a captured graph reads
        # None follows FLAGS_memory_plan; "auto" plans against
        # FLAGS_memory_budget_mb; a RematPlan applies as it is
        self._memory_plan_req = memory_plan
        self._unplanned = {}  # signature -> (IR, labels) of an unplanned step
        self._last = None  # the _Captured of the last call
        self._last_sig = None
        self._plan_certificate = None
        self._static_donation_diags = None

    def _states(self):
        return [self.optimizer._state_of(p) for p in self._params]

    def _step_fn(self, batch, lr, states, as_tensors=False, plan=None):
        """The whole step: loss, gradients, then the in-place update. Returns
        the loss and the gradients of the ``grad_input_idx`` batch inputs,
        and the update's fused telemetry rows under FLAGS_telemetry (else
        None). With ``as_tensors`` the model and the loss function get Paddle
        Tensors over the batch's torch tensors; with ``plan`` (a RematPlan)
        its layer calls run as recompute segments."""
        model = self.model
        batch = list(batch)
        for i in self._grad_input_idx:
            batch[i] = batch[i].detach().requires_grad_()
        diff = [batch[i] for i in self._grad_input_idx]
        ins = [dispatch.wrap(b) for b in batch] if as_tensors else batch
        # the parameter list is fixed when the step is built, as in the JAX
        # package: a parameter frozen since keeps being differentiated
        frozen = [p for p in self._params if not p.requires_grad]
        bound = plan.bind(model, self.loss_fn) if plan is not None else contextlib.nullcontext()
        try:
            for p in frozen:
                p.requires_grad_(True)
            with torch.enable_grad():
                with bound:
                    out = model(*ins[:-1]) if len(ins) > 1 else model(ins[0])
                    loss = self.loss_fn(out, ins[-1]) if self.loss_fn is not None else out
                # the model's output dies at the loss function's last read, as
                # the memory planner frees it: held here, it (a 345M step's
                # logits) would stay live through the backward
                del out
                loss = dispatch.unwrap(loss)
                analysis.mark("backward")
                grads = torch.autograd.grad(loss, self._params + diff, allow_unused=True)
        finally:
            for p in frozen:
                p.requires_grad_(False)
        grads, in_grads = list(grads[:len(self._params)]), grads[len(self._params):]
        clip = self.optimizer._grad_clip
        if clip is not None:
            grads = [g for _, g in clip(list(zip(self._params, grads)))]
        analysis.mark("update")
        tele = apply_update(self.optimizer, self._params, grads, lr, states,
                            telemetry=_attribution.telemetry_active())
        in_grads = [torch.zeros_like(x) if g is None else g for x, g in zip(diff, in_grads)]
        return loss.detach(), in_grads, tele

    def _device(self):
        return self._params[0].device if self._params else torch.device("cpu")

    def _labels(self, program, batch, lr, states):
        """{value id: label} of a recorded step's inputs: the parameters, the
        optimizer states, the batch and the learning rate, by position (what
        the equivalence certificate and the donation gate name them by)."""
        named = [(f"param{i}", p) for i, p in enumerate(self._params)]
        named += [(f"state{i}.{k}", st[k]) for i, st in enumerate(states) for k in sorted(st)
                  if isinstance(st[k], torch.Tensor)]
        named += [(f"batch{i}", b) for i, b in enumerate(batch)] + [("lr", lr)]
        out = {}
        for label, t in named:
            vid = program.value_of(t)
            if vid is not None and program.values[vid].producer < 0:
                out.setdefault(vid, label)
                kind = "param" if label.startswith("param") else (
                    "feed" if label.startswith("batch") else "buffer")
                program.roles.setdefault(vid, (kind, label))
        return out

    def _run(self, entry, sig, batch, lr, states, as_tensors, run, record=True):
        """One step of signature ``sig`` through ``run(fn, *args)``, with the
        plan applied: the plan resolved at the signature's first step, and
        the first step recorded (its IR) and its plan checked and certified
        around it. Without ``record`` (the card's warm-ups with neither a
        plan nor FLAGS_check_programs) the capture's recording is the IR."""
        if entry.ir is not None or (entry.resolved and not record):
            return run(self._step_fn, batch, lr, states, as_tensors, entry.plan)
        if not entry.resolved:
            entry.resolved = True
            entry.plan = self._resolve_plan(None)
            if entry.plan is not None and not entry.plan.applies_to(self.model, self.loss_fn):
                from ..analysis import plan as _plan

                _plan.record_failure("compile_train_step", ValueError(
                    "stale memory plan: it recomputes layers this model does not have; "
                    "replan for this model"))
                entry.plan = None
        if not record:
            return run(self._step_fn, batch, lr, states, as_tensors, entry.plan)
        with analysis.recording(f"compile_train_step:{hash(sig) & 0xFFFF:04x}") as rec:
            out = run(self._step_fn, batch, lr, states, as_tensors, entry.plan)
        self._keep_ir(entry, sig, rec.program, batch, lr, states)
        plan = entry.plan
        if plan is None:
            if self._plan_mode() == "auto":  # plan over this step, apply from the next
                entry.plan = self._resolve_plan(sig)
                if entry.plan is not None:
                    entry.ir = None  # the first planned step is recorded again
            return out
        if entry.ir.n_forward_ops != plan.n_eqns:
            from ..analysis import plan as _plan

            _plan.record_failure("compile_train_step", ValueError(
                f"stale memory plan: it indexes {plan.n_eqns} forward ops but this step's "
                f"forward records {entry.ir.n_forward_ops}; replan for these shapes"))
            entry.plan = None
            self._unplanned[sig] = (entry.ir, entry.labels)  # the same function
        elif int(_flags.flag("check_programs")) >= 2:
            self._certify_planned_step(entry, sig)
        return out

    def _keep_ir(self, entry, sig, program, batch, lr, states):
        """The signature's recorded IR and its inputs' labels; an unplanned
        one is what ``plan_remat`` plans over."""
        entry.ir, entry.labels = program, self._labels(program, batch, lr, states)
        program.labels = entry.labels
        if entry.plan is None:
            self._unplanned[sig] = (entry.ir, entry.labels)

    def _plan_mode(self):
        req = self._memory_plan_req
        return req if req is not None else str(_flags.flag("memory_plan"))

    def _resolve_plan(self, sig):
        """The RematPlan for the next step of signature ``sig``, or None: an
        explicit plan as it is; ``"auto"`` planned against
        FLAGS_memory_budget_mb over the signature's recorded unplanned step
        (none before it ran). A failed build is counted
        (``memory_plan_failures``) and the step runs unplanned."""
        from ..analysis import plan as _plan

        mode = self._plan_mode()
        if not mode:
            return None
        try:
            if isinstance(mode, _plan.RematPlan):
                return mode if mode.has_cuts else None
            if mode != "auto":
                raise ValueError(f"memory_plan={mode!r}: expected 'auto' or a RematPlan")
            if float(_flags.flag("memory_budget_mb")) <= 0 or sig not in self._unplanned:
                return None
            plan = self.plan_remat(sig=sig)
            return plan if plan.has_cuts else None
        except Exception as e:  # noqa: BLE001 — the step trains unplanned
            _plan.record_failure("compile_train_step", e)
            return None

    def _certify_planned_step(self, entry, sig):
        """FLAGS_check_programs=2: the planned step's recording against the
        unplanned step's (this step's own, else the one the plan was made
        over): two recordings that happened anyway. Divergent raises; an
        unprovable proof drops the plan, counted."""
        from ..analysis import ProgramVerificationError
        from ..analysis import plan as _plan
        from ..analysis.equivalence import prove_equivalent

        ref, labels = self._unplanned.get(sig, (None, None))
        if ref is None and entry.plan.program is not None:
            ref = entry.plan.program
            labels = getattr(ref, "labels", None)
        try:
            if ref is None:
                raise RuntimeError("no recording of the unplanned step to certify against")
            cert = prove_equivalent(entry.ir, ref, label_a="planned-step",
                                    label_b="unplanned-step", source="compile_train_step",
                                    labels_a=entry.labels, labels_b=labels,
                                    outputs_a=self._outputs(entry.ir, entry.labels),
                                    outputs_b=self._outputs(ref, labels))
        except Exception as e:  # noqa: BLE001 — unprovable is not divergent
            _plan.record_failure("compile_train_step", e)
            _emit_certificate("unprovable", why=type(e).__name__)
            entry.plan = None
            return
        if not cert.equivalent:
            _emit_certificate("divergent")
            raise ProgramVerificationError(
                "planner-guided remat step is not provably equivalent to the unplanned "
                "step: " + cert.summary(), [d for d in [cert.divergence] if d is not None])
        self._plan_certificate = cert
        _emit_certificate("certified", ops=cert.n_ops[0], outputs=cert.outputs_compared)

    @staticmethod
    def _outputs(program, labels):
        """The certificate's outputs: the final versions of the parameters and
        states the step wrote, by label."""
        return [vid for vid, _l in sorted(labels.items(), key=lambda kv: kv[1])
                if program.values[vid].written]

    def plan_remat(self, budget_mb=None, max_evals=8, sig=None):
        """A ``analysis.plan.RematPlan`` for this step's shapes (needs one
        executed unplanned step: the plan is made over its recording).
        Candidates are measured on that recording (``plan.simulate_peak``):
        none of them runs. ``budget_mb=None`` reads FLAGS_memory_budget_mb.
        The plan feeds ``memory_plan=`` of a new step, or applies itself
        under ``"auto"``."""
        from ..analysis import plan as _plan

        sig = sig if sig is not None else self._last_sig
        if sig not in self._unplanned:
            raise RuntimeError("plan_remat() needs one executed unplanned step first (the "
                               "plan is made over its recording)")
        budget_mb = (float(_flags.flag("memory_budget_mb")) if budget_mb is None
                     else float(budget_mb))
        program, _labels = self._unplanned[sig]
        return _plan.build_remat_plan(program, budget_bytes=int(budget_mb * (1 << 20)),
                                      source="compile_train_step", max_evals=max_evals)

    def memory_plan(self, donated=None):
        """The liveness plan (``analysis.memory.MemoryPlan``) of the last
        signature's recorded step. ``donated=()`` plans it without the credit
        of the in-place writes."""
        entry = self._last
        if entry is None or entry.ir is None:
            raise RuntimeError(
                "memory_plan() needs a recorded step: on the CPU the first, on the card the "
                "capture (the third call) or the first under a memory plan or "
                "FLAGS_check_programs")
        from ..analysis import memory as _memory

        return _memory.plan_memory(entry.ir, donated=donated)

    def _check_donation(self, states):
        """FLAGS_check_programs >= 1: scan the parameters and states this step
        writes in place for live external aliases and tied buffers, plus
        (once per recording) the static memory passes over the recorded
        step."""
        from ..analysis import memory as _memory

        entry = self._last
        program = entry.ir if entry is not None else None
        donated = None if program is None else tuple(
            v.vid for v in program.values.values() if v.written)
        self._static_donation_diags = _memory.donation_gate(
            self._params, states, lambda: program, (), donated, "compile_train_step",
            static_diags=self._static_donation_diags)

    def __call__(self, *batch):
        device = self._device()
        as_tensors = dispatch.holds_tensor(batch, {})
        batch = [torch.as_tensor(dispatch.unwrap(b)).to(device) for b in batch]
        states = self._states()
        if int(_flags.flag("check_programs")):
            self._check_donation(states)
        if device.type == "cuda":
            loss, in_grads, tele = self._cuda_step(device, batch, states, as_tensors)
        else:
            lr = torch.tensor(self.optimizer.get_lr(), dtype=torch.float32, device=device)
            sig = (as_tensors, _attribution.telemetry_active()) + tuple(
                (tuple(b.shape), b.dtype, b.device) for b in batch)
            entry = self._captured.setdefault(sig, _Captured())
            self._last, self._last_sig = entry, sig
            loss, in_grads, tele = self._run(entry, sig, batch, lr, states, as_tensors,
                                             lambda fn, *a: fn(*a))
        if tele is not None:  # recorded at the next step (the lagged reader)
            _attribution.push_telemetry(_attribution.group_names(self._params), tele)
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
        # the fused telemetry changes the captured program: it keys the graph
        sig = (as_tensors, _attribution.telemetry_active()) + tuple(
            (tuple(b.shape), b.dtype, b.device) for b in batch)
        entry = self._captured.setdefault(sig, _Captured())
        self._last, self._last_sig = entry, sig
        if entry.graph is None and entry.eager_steps < WARMUP_STEPS:
            def warm(fn, *args):
                return cuda_graphs.warm_up(device, fn, *args)

            # a warm-up is recorded only for a plan or a check: else the
            # capture's own recording is the signature's IR
            record = bool(self._plan_mode()) or bool(int(_flags.flag("check_programs")))
            with _random.counting_segments() as seen:
                out = self._run(entry, sig, batch, self._lr, states, as_tensors, warm, record)
            entry.segments = seen.count
            entry.eager_steps += 1
            return out
        if entry.graph is None:
            entry.inputs = [b.clone() for b in batch]
            graph = cuda_graphs.Graph(device)
            entry.key = f"captured:{hash(sig) & 0xFFFF:04x}"
            # the capture's own run is recorded: the program's IR for the
            # attribution registry
            with graph.capture(segments=entry.segments), analysis.recording(entry.key) as rec:
                entry.out = self._step_fn(entry.inputs, self._lr, states, as_tensors,
                                          entry.plan)
            entry.graph = graph
            _attribution.register(entry.key, "captured",
                                  ir_thunk=lambda _p=rec.program: _p)
            if entry.ir is None:
                self._keep_ir(entry, sig, rec.program, entry.inputs, self._lr, states)
        cuda_graphs.copy_in(entry.inputs, batch)
        # the last replay's device ms (its CUDA events, read here at the next
        # one when done, so the step never waits for them)
        if entry.timing is None:
            entry.timing = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        elif entry.timing[1].query():
            _attribution.note_run(entry.key, "captured",
                                  entry.timing[0].elapsed_time(entry.timing[1]))
        entry.timing[0].record()
        entry.graph.replay()
        entry.timing[1].record()
        # the static outputs are overwritten by the next replay: hand out
        # copies (the lagged reader copies the telemetry behind an event)
        loss, in_grads, tele = entry.out
        return loss.clone(), [g.clone() for g in in_grads], tele


def _emit_certificate(result, **attrs):
    """The flight recorder's event of a planned step's certificate."""
    from ..core import lazy

    lazy._emit("capture", site="jit", phase="equivalence", result=result, **attrs)


def compile_train_step(model, loss_fn, optimizer, mesh=None, in_shardings=None,
                       grad_input_idx=(), memory_plan=None):
    """``CompiledTrainStep`` over ``model``, with the memory plan
    ``memory_plan`` (``"auto"`` or a ``RematPlan``; None follows
    FLAGS_memory_plan); the JAX function's mesh and sharding arguments are
    not ported yet."""
    for given, what in ((mesh is not None, "mesh"), (in_shardings is not None, "in_shardings")):
        if given:
            raise NotImplementedError(
                f"compile_train_step({what}=...) is not ported yet (ROADMAP, open "
                "items, queue 1 item 13)"
            )
    return CompiledTrainStep(model, loss_fn, optimizer, grad_input_idx, memory_plan)
