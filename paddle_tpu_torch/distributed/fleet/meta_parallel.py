"""The tensor-parallel layers, the RNG tracker and the parallel wrappers
(``paddle_tpu/distributed/fleet/meta_parallel.py``).

The JAX layers keep their parameters logically global, each with a
``dist_spec``, and GSPMD inserts the collectives. The port runs a process
per rank, as Paddle's ``mp_layers.py`` does: at an mp degree above 1 each
rank holds its shard of a layer's weight and calls the collectives itself,
over the installed topology's mp group (``parallel.topology``):

  - ``VocabParallelEmbedding``: ids outside the rank's rows give zeros, then
    a sum over mp;
  - ``ColumnParallelLinear``: the input enters the mp region (identity
    forward, mp sum of its gradient); ``gather_output`` all-gathers the
    columns;
  - ``RowParallelLinear``: an mp sum of the partial products, then the bias;
    without ``input_is_parallel`` the input is split first;
  - ``ParallelCrossEntropy``: softmax cross-entropy over vocab-sharded
    logits, never gathered: the max, the sum of exps and the target logit
    each reduced over mp, and the local softmax minus the one-hot as the
    gradient.

Every weight keeps the JAX layer's ``dist_spec`` and its global shape
(``global_shape``): it is made whole by its initialiser, so the global
fan-in and fan-out set its scale and one seed gives every mp degree the
same weights, then cut to the rank's shard (``convert.shard_arrays`` cuts
a global array the same way). At mp 1 the layers compute what the JAX
layers compute unsharded, with no collective.

``LayerDesc``, ``SharedLayerDesc``, ``PipelineLayer`` and
``PipelineParallel`` (pipeline parallelism) are ROADMAP queue 1 item 13b.
"""
from __future__ import annotations

import contextlib

import torch

from ...core import random as _random
from ...core.tensor import Parameter
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer.common import param_of
from ...nn.layer_base import Layer
from .. import collective as C

__all__ = [
    "VocabParallelEmbedding",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "ParallelCrossEntropy",
    "LayerDesc",
    "SharedLayerDesc",
    "PipelineLayer",
    "PipelineParallel",
    "TensorParallel",
    "ShardingParallel",
    "get_rng_state_tracker",
    "RNGStatesTracker",
    "model_parallel_random_seed",
    "with_sharding_constraint",
]


def with_sharding_constraint(x, *spec):
    """The JAX sharding hint (``parallel.sharding.with_sharding_constraint``)."""
    from ...parallel.sharding import with_sharding_constraint as wsc

    return wsc(x, *spec)


def mp_group():
    """This rank's mp group, or None when no topology is installed."""
    from ...parallel.topology import axis_group

    return axis_group("mp")


def mp_degree() -> int:
    from ...parallel.topology import axis_size

    return axis_size("mp")


def mp_rank() -> int:
    from ...parallel.topology import axis_index

    return axis_index("mp")


# ---------------------------------------------------------------------------
# the mp region's autograd functions (reference: mp_ops.py _c_identity,
# _mp_allreduce, _c_split, _c_concat)
# ---------------------------------------------------------------------------
class _CopyToMp(torch.autograd.Function):
    """Identity forward; the gradient summed over mp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce_(g.contiguous().clone(), C.ReduceOp.SUM, ctx.group), None


class _ReduceFromMp(torch.autograd.Function):
    """Sum over mp forward; the gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return C.all_reduce_(x.contiguous().clone(), C.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMp(torch.autograd.Function):
    """The members' last dims concatenated; the gradient's own slice back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C.all_gather_cat(x.contiguous(), group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        g = g.chunk(ctx.group.nranks, dim=-1)[ctx.group.rank]
        return g.contiguous(), None


class _ScatterToMp(torch.autograd.Function):
    """This member's slice of the last dim; the gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.chunk(group.nranks, dim=-1)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return C.all_gather_cat(g.contiguous(), ctx.group, dim=-1), None


def copy_to_mp(x):
    g = mp_group()
    return x if g is None or g.nranks == 1 else _CopyToMp.apply(x, g)


def reduce_from_mp(x):
    g = mp_group()
    return x if g is None or g.nranks == 1 else _ReduceFromMp.apply(x, g)


def gather_from_mp(x):
    g = mp_group()
    return x if g is None or g.nranks == 1 else _GatherFromMp.apply(x, g)


def scatter_to_mp(x):
    g = mp_group()
    return x if g is None or g.nranks == 1 else _ScatterToMp.apply(x, g)


def sharded_param(shape, attr, default, device, spec, is_bias=False):
    """A parameter of global ``shape`` made by its initialiser, then cut to
    this rank's mp shard along the dim ``spec`` marks "mp"; it keeps
    ``spec`` (``dist_spec``) and the global shape."""
    full = param_of(shape, attr, default, device, is_bias=is_bias)
    n = mp_degree()
    if n > 1 and "mp" in spec:
        dim = spec.index("mp")
        if full.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(full.shape)} weight does not divide "
                             f"over mp {n}")
        shard = full.detach().chunk(n, dim=dim)[mp_rank()].clone()
        full = Parameter(shard, requires_grad=full.requires_grad, name=full.param_name)
    full.dist_spec = tuple(spec)
    full.global_shape = tuple(int(s) for s in shape)
    return full


class VocabParallelEmbedding(Layer):
    """reference: mp_layers.py:30 — the vocab rows sharded over mp."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.weight = sharded_param([num_embeddings, embedding_dim], weight_attr,
                                    I.XavierNormal(), device, ("mp", None))

    def forward(self, x):
        if mp_degree() == 1:
            return F.embedding(x, self.weight)
        rows = self.weight.shape[0]
        start = mp_rank() * rows
        outside = (x < start) | (x >= start + rows)
        out = F.embedding((x - start).masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return reduce_from_mp(out)


class ColumnParallelLinear(Layer):
    """reference: mp_layers.py:97 — weight ``[in, out]``, the out dim (and
    the bias) sharded over mp."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 gather_output=True, fuse_matmul_bias=False, mp_group=None,
                 name=None, device=None):
        super().__init__()
        self.gather_output = gather_output
        self.weight = sharded_param([in_features, out_features], weight_attr,
                                    I.XavierNormal(), device, (None, "mp"))
        self.bias = (sharded_param([out_features], None, I.Constant(0.0), device, ("mp",),
                                   is_bias=True) if has_bias else None)

    def forward(self, x):
        out = F.linear(copy_to_mp(x), self.weight, self.bias)
        return gather_from_mp(out) if self.gather_output else out


class RowParallelLinear(Layer):
    """reference: mp_layers.py:170 — weight ``[in, out]``, the in dim sharded
    over mp; the bias is added after the mp sum, as
    ``paddle_tpu/distributed/fleet/meta_parallel.py:115-122`` orders it."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=False, fuse_matmul_bias=False, mp_group=None,
                 name=None, device=None):
        super().__init__()
        self.input_is_parallel = input_is_parallel
        self.weight = sharded_param([in_features, out_features], weight_attr,
                                    I.XavierNormal(), device, ("mp", None))
        self.bias = (sharded_param([out_features], None, I.Constant(0.0), device, (None,),
                                   is_bias=True) if has_bias else None)

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_mp(x)
        out = reduce_from_mp(F.linear(x, self.weight, None))
        if self.bias is not None:
            out = out + self.bias
        return out


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        rows = logits.shape[-1]
        start = group.rank * rows
        m = logits.max(dim=-1).values
        C.all_reduce_(m, C.ReduceOp.MAX, group)
        z = logits - m.unsqueeze(-1)
        e = torch.exp(z)
        s = e.sum(dim=-1)
        C.all_reduce_(s, C.ReduceOp.SUM, group)
        inside = (label >= start) & (label < start + rows)
        local = torch.where(inside, label - start, torch.zeros_like(label))
        t = torch.gather(z, -1, local.unsqueeze(-1)).squeeze(-1)
        t = torch.where(inside, t, torch.zeros_like(t))
        C.all_reduce_(t, C.ReduceOp.SUM, group)
        keep = label != ignore_index
        loss = torch.where(keep, torch.log(s) - t, torch.zeros_like(t))
        ctx.save_for_backward(e.div_(s.unsqueeze(-1)), local, inside & keep, keep)
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, local, hit, keep = ctx.saved_tensors
        grad = softmax.clone()
        grad.scatter_add_(-1, local.unsqueeze(-1), -hit.to(grad.dtype).unsqueeze(-1))
        grad = grad * torch.where(keep, g, torch.zeros_like(g)).unsqueeze(-1)
        return grad, None, None, None


class ParallelCrossEntropy(Layer):
    """reference: mp_layers.py:249 (c_softmax_with_cross_entropy): the
    per-token loss of vocab-sharded logits; at mp 1 ``F.cross_entropy``'s."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return parallel_cross_entropy(input, label, self.ignore_index)


def parallel_cross_entropy(input, label, ignore_index=-100):
    """``ParallelCrossEntropy``'s per-token loss, as a function."""
    if mp_degree() == 1:
        return F.cross_entropy(input, label, reduction="none", ignore_index=ignore_index)
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    return _VocabParallelCE.apply(input, label.long(), mp_group(), ignore_index)


# ---------------------------------------------------------------------------
# RNG tracker (reference: parallel_layers/random.py)
# ---------------------------------------------------------------------------
class RNGStatesTracker:
    """Named random streams: inside ``rng_state(name)`` the current device's
    generator draws from the stream ``name`` and advances it, so dropout
    inside the mp region (attention over a rank's heads) differs across mp
    ranks while dropout of replicated activations, drawn from the shared
    default generator, stays equal across them."""

    def __init__(self):
        self._states = {}

    def add(self, name, seed):
        self._states[name] = _random.Generator(int(seed))

    def reset(self):
        self._states = {}

    def get_states_tracker(self):
        return {k: g.get_state() for k, g in self._states.items()}

    def set_states_tracker(self, states):
        for k, s in states.items():
            self._states[k].set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng"):
        stream = self._states.get(name)
        if stream is None:
            yield
            return
        own = _random.generator(stream.device)
        saved = own.get_state()
        own.set_state(stream.get_state())
        try:
            yield
        finally:
            stream.set_state(own.get_state())
            own.set_state(saved)


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None):
    """reference: parallel_layers/random.py — ``seed`` (42 when None) seeds
    the default generators alike on every rank and the "global_seed"
    stream; "model_parallel_rng" is ``seed + 1 + mp rank``, one stream per
    mp rank."""
    seed = 42 if seed is None else int(seed)
    _random.seed(seed)
    _tracker.reset()
    _tracker.add("global_seed", seed)
    _tracker.add("model_parallel_rng", seed + 1 + mp_rank())


def _later(what):
    raise NotImplementedError(
        f"{what} (pipeline parallelism) is not ported yet (ROADMAP, open items, queue 1 "
        "item 13b)"
    )


class LayerDesc:
    """reference: pp_layers.py:49 — ROADMAP queue 1 item 13b."""

    def __init__(self, *args, **kwargs):
        _later("LayerDesc")


class SharedLayerDesc(LayerDesc):
    """reference: pp_layers.py:63 — ROADMAP queue 1 item 13b."""

    def __init__(self, *args, **kwargs):
        _later("SharedLayerDesc")


class PipelineLayer(Layer):
    """reference: pp_layers.py:132 — ROADMAP queue 1 item 13b."""

    def __init__(self, *args, **kwargs):
        _later("PipelineLayer")


class PipelineParallel(Layer):
    """reference: pipeline_parallel.py:30 — ROADMAP queue 1 item 13b."""

    def __init__(self, *args, **kwargs):
        _later("PipelineParallel")


class TensorParallel(Layer):
    """reference: meta_parallel/tensor_parallel.py — the wrapper
    ``fleet.distributed_model`` returns at mp > 1; the layers do the work."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(super().__getattr__("_layers"), name)


class ShardingParallel(TensorParallel):
    pass
