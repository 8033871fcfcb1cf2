"""The sharding rules and the hybrid-parallel training step
(``paddle_tpu/parallel/sharding.py``).

The JAX package compiles one SPMD program over the mesh and GSPMD inserts
the collectives. The port runs a process per rank and its step calls them
itself, eagerly: the forward and the backward on the rank's rows of the
global batch (the tensor-parallel layers do their own mp collectives), the
gradients averaged over the dp x sharding ranks, the clip, the update, and
the ZeRO collectives. It is not one CUDA graph: a gloo collective cannot be
captured (a step captured over NCCL is ROADMAP queue 1 item 13c).

The layout rules are the JAX package's (``param_spec``, ``_state_spec``):

  - ZeRO-1/2: each rank keeps its shard of every moment along the dim
    ``_state_spec`` picks (the first dim no tensor-parallel axis takes whose
    size the sharding degree divides; a parameter without one keeps whole
    moments). Stage 1 averages whole gradients and updates the rank's slice;
    stage 2 reduce-scatters the gradients onto the shards. Both then
    all-gather the updated parameters.
  - ZeRO-3: at rest each rank holds its 1/n of every parameter
    ``param_spec`` shards (``shard_params``). A step all-gathers them before
    the forward and frees the whole parameters after the update, so the
    step's peak holds whole parameters and gradients beside the
    activations; between steps only the shards and the moment shards stay.

Every collective of a step is one flat buffer per dtype: one all-reduce of
the gradients (or one reduce-scatter over sharding and one all-reduce over
dp), one all-gather of the parameters.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .topology import axis_index, axis_size, get_hcg, get_mesh

ShardingSpec = tuple

__all__ = ["ShardingSpec", "param_spec", "shard_params", "with_sharding_constraint",
           "suppress_sharding_constraints", "ShardedTrainStep", "sharded_train_step",
           "capture_step_shardings"]


def _full_shape(p):
    """The shape of ``p``'s mp shard before any ZeRO-3 cut."""
    return tuple(getattr(p, "zero_shape", None) or p.shape)


def _n_sharding(mesh) -> int:
    if mesh is None:
        return 1
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get("sharding", 1)


def param_spec(p, zero_stage: int = 0, mesh=None) -> tuple:
    """One parameter's layout: its layer's ``dist_spec`` (the mp dim), and
    with ZeRO-3 the first dim it leaves free whose size the sharding
    degree divides, marked "sharding"; else replicated."""
    mesh = mesh or get_mesh()
    shape = _full_shape(p)
    spec = list(getattr(p, "dist_spec", None) or ())
    entries = spec + [None] * (len(shape) - len(spec))
    n = _n_sharding(mesh)
    if zero_stage >= 3 and n > 1:
        for d in range(len(shape)):
            if entries[d] is None and shape[d] % n == 0:
                entries[d] = "sharding"
                break
    return tuple(entries)


def _state_spec(pspec, shape, zero_stage: int, mesh) -> tuple:
    """A moment's layout: the parameter's, and with ZeRO-1/2 the first free
    dim the sharding degree divides marked "sharding" too."""
    entries = list(pspec) + [None] * (len(shape) - len(list(pspec)))
    n = _n_sharding(mesh)
    if zero_stage >= 1 and len(shape) > 0 and n > 1 and "sharding" not in entries:
        for d in range(len(shape)):
            if entries[d] is None and shape[d] % n == 0:
                entries[d] = "sharding"
                break
    return tuple(entries)


def shard_params(model, mesh=None, zero_stage: int = 0):
    """With ZeRO-3 over a sharding degree above 1, cut every parameter
    ``param_spec`` shards to this rank's 1/n (``zero_dim``, ``zero_shape``
    keep the cut); otherwise the parameters stay whole. A parameter already
    cut stays as it is."""
    mesh = mesh or get_mesh()
    n = _n_sharding(mesh)
    if zero_stage < 3 or n == 1:
        return model
    idx = axis_index("sharding")
    with torch.no_grad():
        for p in model.parameters():
            if getattr(p, "zero_dim", None) is not None:
                continue
            spec = param_spec(p, zero_stage, mesh)
            if "sharding" not in spec:
                continue
            d = spec.index("sharding")
            p.zero_shape = tuple(p.shape)
            p.zero_dim = d
            p.data = p.data.chunk(n, dim=d)[idx].clone()
    return model


def capture_step_shardings(params, states, mesh=None):
    raise NotImplementedError(
        "capture_step_shardings (a sharded step captured whole) is not ported yet (ROADMAP, "
        "open items, queue 1 item 13c)"
    )


_constraint_tls = threading.local()


class suppress_sharding_constraints:
    """Scope in which ``with_sharding_constraint`` returns its input unchecked."""

    def __enter__(self):
        self._prev = getattr(_constraint_tls, "off", False)
        _constraint_tls.off = True
        return self

    def __exit__(self, *exc):
        _constraint_tls.off = self._prev
        return False


def with_sharding_constraint(x, *spec):
    """The JAX layout hint. The port's layers do their collectives
    themselves, so a constraint over dp, sharding or mp is the identity; one
    over a ``sep`` axis above 1 (sequence parallelism) raises."""
    if getattr(_constraint_tls, "off", False):
        return x
    axes = set()
    for s in spec:
        axes.update(s if isinstance(s, (tuple, list)) else (s,))
    if "sep" in axes and axis_size("sep") > 1:
        raise NotImplementedError(
            "sequence parallelism over sep is not ported yet (ROADMAP, open items, queue 1 "
            "item 13b)"
        )
    return x


# ---------------------------------------------------------------------------
# flat collectives: one buffer per dtype
# ---------------------------------------------------------------------------
def _by_dtype(items):
    groups = {}
    for i, t in enumerate(items):
        groups.setdefault(t.dtype, []).append(i)
    return groups.values()


def _rows(t, d, n):
    """``t`` as [n, rest]: row r holds its r-th chunk along dim ``d``."""
    return t.movedim(d, 0).reshape(n, -1)


def _from_rows(flat, shape, d, n, keep):
    """Inverse of ``_rows`` for ``keep`` chunks (1: one shard, n: whole)."""
    moved = list(shape)
    moved.insert(0, moved.pop(d))
    moved[0] = moved[0] // n * keep
    return flat.reshape(moved).movedim(0, d)


def _flat_reduce_scatter(tensors, dims, group):
    """Each tensor summed over ``group`` and cut to this member's chunk along
    its dim: the list of shards."""
    from ..distributed import collective as C

    n = group.nranks
    out = [None] * len(tensors)
    for idx in _by_dtype(tensors):
        rows = torch.cat([_rows(tensors[i], dims[i], n) for i in idx], dim=1)
        mine = C.reduce_scatter_dim(rows.reshape(-1), group, 0)
        off = 0
        for i in idx:
            k = tensors[i].numel() // n
            out[i] = _from_rows(mine[off:off + k], tensors[i].shape, dims[i], n, 1)
            off += k
    return out


def _flat_all_gather(shards, dims, shapes, group):
    """The members' shards joined along each one's dim: whole tensors."""
    from ..distributed import collective as C

    n = group.nranks
    out = [None] * len(shards)
    for idx in _by_dtype(shards):
        flat = torch.cat([shards[i].movedim(dims[i], 0).reshape(-1) for i in idx])
        rows = C.all_gather_cat(flat, group, 0).reshape(n, -1)
        off = 0
        for i in idx:
            k = shards[i].numel()
            out[i] = _from_rows(rows[:, off:off + k].reshape(-1), shapes[i], dims[i], n, n)
            off += k
    return out


def _shard(t, d, group):
    return t.chunk(group.nranks, dim=d)[group.rank]


class _Layout:
    """How the step treats one parameter: its mp sharding, the dim its
    moments (and with ZeRO-2/3 its gradient) are cut along, whether it rests
    cut (ZeRO-3)."""

    def __init__(self, p, zero_stage, mesh):
        spec = param_spec(p, zero_stage, mesh)
        self.mp = "mp" in (getattr(p, "dist_spec", None) or ()) and axis_size("mp") > 1
        state = _state_spec(spec, _full_shape(p), max(zero_stage, 1), mesh)
        self.dim = state.index("sharding") if "sharding" in state else None
        self.rests_cut = getattr(p, "zero_dim", None) is not None
        self.shape = _full_shape(p)


class ShardedTrainStep:
    """The hybrid-parallel training step over the installed topology
    (reference: fleet.distributed_model + HybridParallelOptimizer). Each
    call takes the GLOBAL batch, as the JAX step does: every rank keeps its
    rows (the dp x sharding split, dp major) and returns the global batch's
    mean loss. ``accumulate_steps`` splits the global batch into that many
    microbatches first (the JAX step's gradient merge), ``loss_scale``
    multiplies the loss before the backward and divides the gradients
    after, ``grad_input_idx`` returns the gradients of those batch inputs
    (global, gathered over the batch ranks). The optimizer's ``grad_clip``
    sees the logical parameter set: the squared norm of an mp shard is
    summed over mp and a ZeRO shard's over sharding, and a replicated
    gradient counts once. The update is the optimizer's rule
    (``type(opt)._update``), on the rank's shard."""

    def __init__(self, model, loss_fn, optimizer, mesh=None, zero_stage=0,
                 batch_axes=("dp", "sharding"), forward_ctx=None, accumulate_steps=1,
                 loss_scale=1.0, grad_input_idx=()):
        self.grad_input_idx = tuple(int(i) for i in grad_input_idx)
        if self.grad_input_idx and int(accumulate_steps) > 1:
            raise ValueError(
                "grad_input_idx is not supported with gradient merge (the per-microbatch "
                "input grads would need their own accumulation contract)"
            )
        self.accumulate_steps = int(accumulate_steps)
        if self.accumulate_steps < 1:
            raise ValueError("accumulate_steps must be >= 1")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.forward_ctx = forward_ctx
        self.loss_scale = float(loss_scale)
        self.mesh = mesh or get_mesh()
        self.zero_stage = int(zero_stage)
        self.hcg = get_hcg()
        names = self.mesh.axis_names if self.mesh is not None else ()
        self.batch_axes = tuple(a for a in batch_axes if a in names)
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._layouts = None

    # -- groups ----------------------------------------------------------------
    def _group(self, axes):
        hcg = self.hcg
        if hcg is None:
            return None
        axes = tuple(a for a in axes if axis_size(a) > 1)
        if not axes:
            return None
        if set(axes) == {"dp", "sharding"}:
            return hcg.get_batch_group()
        return {"dp": hcg.get_data_parallel_group,
                "sharding": hcg.get_sharding_parallel_group,
                "mp": hcg.get_model_parallel_group}[axes[0]]()

    def _batch_split(self):
        """(number of batch ranks, this rank's index), dp major."""
        n, idx = 1, 0
        for a in self.batch_axes:
            n_a = axis_size(a)
            idx = idx * n_a + axis_index(a)
            n *= n_a
        return n, idx

    # -- the step --------------------------------------------------------------
    def __call__(self, *batch):
        from ..distributed import collective as C
        from ..optimizer.optimizer import _rule_update

        opt = self.optimizer
        params = self._params
        if self._layouts is None:
            self._layouts = [_Layout(p, self.zero_stage, self.mesh) for p in params]
        layouts = self._layouts
        dev = params[0].device if params else torch.device("cpu")
        vals = [_as_torch(b, dev) for b in batch]
        k = self.accumulate_steps
        rows = vals[0].shape[0]
        if rows % k:
            raise ValueError(f"global batch {rows} is not divisible by gradient-merge "
                             f"accumulate_steps={k}")
        n_b, b_idx = self._batch_split()
        if rows % (k * n_b):
            raise ValueError(f"global batch {rows} does not split over {n_b} batch ranks "
                             f"x {k} microbatches")
        shard_g = self._group(("sharding",))
        batch_g = self._group(self.batch_axes)
        cut = [i for i, lay in enumerate(layouts) if lay.rests_cut]
        rest = {}
        if cut:  # ZeRO-3: the whole parameters for this step
            rest = {i: params[i].data for i in cut}
            whole = _flat_all_gather([rest[i] for i in cut], [layouts[i].dim for i in cut],
                                     [layouts[i].shape for i in cut], shard_g)
            for i, w in zip(cut, whole):
                params[i].data = w.contiguous()
        try:
            loss, grads, in_grads = self._forward_backward(vals, k, n_b, b_idx)
            loss = loss.float()
            with torch.no_grad():
                grads = self._reduce(grads, n_b, batch_g, shard_g)
                grads = self._clip(grads)
                lr = torch.tensor(opt.get_lr(), dtype=torch.float32, device=dev)
                hyper = opt._hyper()
                views = []
                for i, (p, lay, g) in enumerate(zip(params, layouts, grads)):
                    if lay.dim is None:
                        target = p
                    elif lay.rests_cut:
                        target = rest[i]
                    else:
                        target = _shard(p.data, lay.dim, shard_g)
                    if lay.dim is not None and self.zero_stage < 2:
                        g = _shard(g, lay.dim, shard_g)
                    st = opt._accumulators.get(id(p))
                    if st is None:
                        st = opt._accumulators[id(p)] = opt._create_state(target)
                    _rule_update(opt, target, g.to(p.dtype), lr, st,
                                 dict(hyper, **opt._per_param_hyper(p)))
                    views.append(target)
                gather = [i for i, lay in enumerate(layouts)
                          if lay.dim is not None and not lay.rests_cut]
                if gather and shard_g is not None:
                    whole = _flat_all_gather([views[i] for i in gather],
                                             [layouts[i].dim for i in gather],
                                             [layouts[i].shape for i in gather], shard_g)
                    for i, w in zip(gather, whole):
                        params[i].data.copy_(w)
                if batch_g is not None:
                    C.all_reduce_(loss, C.ReduceOp.SUM, batch_g)
                    loss.div_(n_b)
        finally:
            for i in cut:  # ZeRO-3: back to the shards
                params[i].data = rest[i]
        opt._step_count += 1
        if self.grad_input_idx:
            return loss, in_grads
        return loss

    def _forward_backward(self, vals, k, n_b, b_idx):
        """The loss of this rank's rows and the gradients (summed in f32 and
        averaged over ``k`` microbatches when k > 1; unscaled)."""
        ctx = self.forward_ctx or contextlib.nullcontext
        params = self._params
        size = vals[0].shape[0] // (k * n_b)
        gidx = self.grad_input_idx
        acc, losses, in_grads = None, [], []
        for m in range(k):
            lo = m * size * n_b + b_idx * size
            ins = [v[lo:lo + size] for v in vals]
            diff = []
            for i in gidx:
                ins[i] = ins[i].detach().requires_grad_()
                diff.append(ins[i])
            with torch.enable_grad(), ctx():
                out = self.model(*ins[:-1]) if len(ins) > 1 else self.model(ins[0])
                loss = self.loss_fn(out, ins[-1]) if self.loss_fn is not None else out
                del out
                loss = _as_torch(loss, None)
                scaled = loss * self.loss_scale if self.loss_scale != 1.0 else loss
                got = torch.autograd.grad(scaled, params + diff, allow_unused=True)
            gs = [torch.zeros_like(p) if g is None else g for p, g in zip(params, got)]
            in_grads = [torch.zeros_like(x) if g is None else g
                        for x, g in zip(diff, got[len(params):])]
            losses.append(loss.detach())
            if k == 1:
                acc = gs
            elif acc is None:
                acc = [g.float() for g in gs]
            else:
                acc = [a + g.float() for a, g in zip(acc, gs)]
        if k > 1:
            acc = [(a / k).to(p.dtype) for a, p in zip(acc, params)]
        loss = losses[0] if k == 1 else torch.stack(losses).mean()
        if self.loss_scale != 1.0:
            acc = [(g.float() / self.loss_scale).to(g.dtype) for g in acc]
            in_grads = [(g.float() / self.loss_scale).to(g.dtype) for g in in_grads]
        if in_grads and n_b > 1:
            from ..distributed import collective as C

            group = self._group(self.batch_axes)
            in_grads = [C.all_gather_cat(g / n_b, group, 0) for g in in_grads]
        return loss, acc, in_grads

    def _reduce(self, grads, n_b, batch_g, shard_g):
        """The gradients averaged over the batch ranks: whole, or with
        ZeRO-2/3 each cut to this rank's shard of its moment dim."""
        from ..distributed import collective as C

        if batch_g is None:
            return grads
        layouts = self._layouts
        grads = list(grads)
        scatter = [i for i, lay in enumerate(layouts)
                   if self.zero_stage >= 2 and lay.dim is not None and shard_g is not None]
        whole = [i for i in range(len(grads)) if i not in set(scatter)]
        C.all_reduce_flat([grads[i] for i in whole], batch_g)
        if scatter:
            shards = _flat_reduce_scatter([grads[i] for i in scatter],
                                          [layouts[i].dim for i in scatter], shard_g)
            dp_g = self._group(("dp",))
            if dp_g is not None:  # None: dp degree 1, nothing to sum
                C.all_reduce_flat(shards, dp_g)
            for i, s in zip(scatter, shards):
                grads[i] = s
        return [g.div_(n_b) for g in grads]

    def _clip(self, grads):
        """The optimizer's clip over the logical parameter set."""
        from ..nn import clip as _clip

        clip = self.optimizer._grad_clip
        if clip is None:
            return grads
        if not _clip._is_builtin(clip):
            raise ValueError(f"the sharded step applies the stock clips only; got "
                             f"{type(clip).__name__}")
        if isinstance(clip, _clip.ClipGradByValue):
            return clip._pure()(grads)
        layouts = self._layouts
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in grads])
        mp_mask = torch.tensor([lay.mp for lay in layouts], device=sq.device)
        cut = [lay.dim is not None and (self.zero_stage >= 2 or lay.rests_cut)
               for lay in layouts]
        sh_mask = torch.tensor(cut, device=sq.device)
        sq = _masked_sum(sq, mp_mask, self._group(("mp",)))
        sq = _masked_sum(sq, sh_mask, self._group(("sharding",)))
        if isinstance(clip, _clip.ClipGradByNorm):
            norms = torch.sqrt(sq)
            cn = clip.clip_norm
            return [g * torch.where(n > cn, n.new_full((), cn) / n, torch.ones_like(n))
                    for g, n in zip(grads, norms)]
        norm = torch.sqrt(sq.sum())
        scale = norm.new_full((), clip.clip_norm) / torch.clamp(norm, min=clip.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]


def _masked_sum(values, mask, group):
    """``values`` with the entries ``mask`` marks summed over ``group``."""
    from ..distributed import collective as C

    if group is None or not bool(mask.any()):
        return values
    part = torch.where(mask, values, torch.zeros_like(values))
    C.all_reduce_(part, C.ReduceOp.SUM, group)
    return torch.where(mask, part, values)


def _as_torch(x, device):
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    if hasattr(x, "_value"):
        v = x._value
        return v if device is None else v.to(device)
    import numpy as np

    return torch.as_tensor(np.asarray(x), device=device)


def sharded_train_step(model, loss_fn, optimizer, mesh=None, zero_stage=0,
                       batch_axes=("dp", "sharding"), forward_ctx=None, accumulate_steps=1,
                       loss_scale=1.0, grad_input_idx=()):
    return ShardedTrainStep(model, loss_fn, optimizer, mesh, zero_stage, batch_axes,
                            forward_ctx, accumulate_steps, loss_scale, grad_input_idx)
