"""Carry weights into a port model from numpy arrays or tensors.

The JAX package's ``state_dict()`` and the port's use the same names and
layouts, so ``{k: v.numpy() for k, v in jax_model.state_dict().items()}``
loads as it is. ``state_dict_from_numpy`` is the strict loader the parity
tests use; ``nn.Layer.set_state_dict`` is Paddle's lenient one. Both check
each value with ``source_for``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, copy=True)  # owned and writable, as torch needs
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def source_for(name: str, value, target: torch.Tensor, cast: bool, who: str) -> torch.Tensor:
    """``value`` (a tensor or anything numpy takes) as a tensor to copy into
    ``target``. A shape other than the target's raises ValueError; so does
    another dtype unless ``cast``, where the copy converts it."""
    src = value if isinstance(value, torch.Tensor) else _to_torch(np.asarray(value))
    if tuple(src.shape) != tuple(target.shape):
        raise ValueError(
            f"{who}: {name} has shape {tuple(src.shape)}, the model expects "
            f"{tuple(target.shape)}"
        )
    if not cast and src.dtype != target.dtype:
        raise ValueError(
            f"{who}: {name} has dtype {src.dtype}, the model expects {target.dtype}"
        )
    return src


def state_dict_from_numpy(model: torch.nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    """Load ``arrays`` (numpy arrays or tensors) into ``model``'s state, in
    place, on the model's devices.

    Every name, shape and dtype must match the model's ``state_dict()``:
    a missing, extra, mis-shaped or mis-typed key raises ValueError and
    nothing is loaded."""
    target = model.state_dict()
    missing = sorted(set(target) - set(arrays))
    extra = sorted(set(arrays) - set(target))
    if missing or extra:
        raise ValueError(
            f"state_dict_from_numpy: missing keys {missing}, unexpected keys {extra}"
        )
    tensors = {name: source_for(name, arrays[name], t, False, "state_dict_from_numpy")
               for name, t in target.items()}
    with torch.no_grad():
        for name, t in target.items():
            t.copy_(tensors[name])


# ---------------------------------------------------------------------------
# sharded weights: a rank's shards of global arrays, and back
# ---------------------------------------------------------------------------
def _degree(axis: str) -> int:
    from .parallel.topology import axis_size

    return axis_size(axis)


def _index(axis: str) -> int:
    from .parallel.topology import axis_index

    return axis_index(axis)


def param_layout(p):
    """(mp dim, ZeRO-3 dim) of a parameter: the dim its layer shards over
    the installed mp degree, and the dim ``parallel.sharding.shard_params``
    cut it along; None for each the parameter does not have."""
    spec = getattr(p, "dist_spec", None) or ()
    mp_dim = spec.index("mp") if "mp" in spec and _degree("mp") > 1 else None
    return mp_dim, getattr(p, "zero_dim", None)


def model_layout(model) -> Dict[str, tuple]:
    """``{state name: (mp dim, ZeRO-3 dim)}`` of every parameter and buffer."""
    out = {}
    params = dict(model.named_parameters())
    for name in model.state_dict():
        out[name] = param_layout(params[name]) if name in params else (None, None)
    return out


def _chunk(a, n, dim, i):
    if isinstance(a, torch.Tensor):
        return a.chunk(n, dim=dim)[i]
    return np.split(np.asarray(a), n, axis=dim)[i]


def shard_arrays(model, arrays: Dict[str, object]) -> Dict[str, object]:
    """This rank's shards of the global ``arrays`` (numpy or torch, the JAX
    package's names and layouts): each cut along its parameter's mp dim at
    this rank's mp index, then along its ZeRO-3 dim at its sharding index."""
    out = {}
    for name, (mp_dim, zero_dim) in model_layout(model).items():
        a = arrays[name]
        if mp_dim is not None:
            a = _chunk(a, _degree("mp"), mp_dim, _index("mp"))
        if zero_dim is not None:
            a = _chunk(a, _degree("sharding"), zero_dim, _index("sharding"))
        out[name] = a
    return out


def load_global_state(model, arrays: Dict[str, object]) -> None:
    """Load global ``arrays`` into a sharded ``model``, in place: the strict
    ``state_dict_from_numpy`` of this rank's ``shard_arrays``."""
    state_dict_from_numpy(model, shard_arrays(model, arrays))


def shard_moment(array, p):
    """This rank's shard of a global optimizer moment of parameter ``p``:
    cut along ``p``'s mp dim, then along the dim the sharded step keeps its
    moments cut (``parallel.sharding._state_spec``: the same dim at every
    ZeRO stage)."""
    from .parallel.sharding import _Layout
    from .parallel.topology import get_mesh

    mp_dim, _ = param_layout(p)
    if mp_dim is not None:
        array = _chunk(array, _degree("mp"), mp_dim, _index("mp"))
    dim = _Layout(p, 1, get_mesh()).dim
    if dim is not None:
        array = _chunk(array, _degree("sharding"), dim, _index("sharding"))
    return array


def gather_arrays(per_rank, layout: Dict[str, tuple], degrees: Dict[str, int]):
    """The global arrays of ``per_rank`` (the ranks' ``{name: numpy array}``
    of one model, indexed by global rank) for a topology of ``degrees``
    (``dp``, ``mp``, ``sharding``, ``pp``, ``sep``; 1 where absent):
    ``layout`` is ``model_layout`` of the model; the inverse of
    ``shard_arrays``."""
    from .parallel.topology import CommunicateTopology

    dims = [int(degrees.get(a, 1)) for a in ("pp", "dp", "sharding", "sep", "mp")]
    topo = CommunicateTopology(["pipe", "data", "sharding", "sep", "model"], dims)
    out = {}
    for name, (mp_dim, zero_dim) in layout.items():
        parts = []
        for m in range(dims[4]):
            shards = [np.asarray(per_rank[topo.get_rank(pipe=0, data=0, sharding=s, sep=0,
                                                        model=m)][name])
                      for s in range(dims[2])]
            parts.append(np.concatenate(shards, axis=zero_dim) if zero_dim is not None
                         else shards[0])
        out[name] = np.concatenate(parts, axis=mp_dim) if mp_dim is not None else parts[0]
    return out


def gather_model_state(model, optimizer=None) -> Dict[str, np.ndarray]:
    """The global state of a sharded ``model`` (its ``state_dict`` names), or
    with ``optimizer`` the global optimizer state (its ``state_dict`` keys),
    as numpy arrays on every rank: each shard all-gathered over sharding,
    then over mp. Every rank calls it."""
    from .distributed import collective as C
    from .parallel.sharding import _Layout
    from .parallel.topology import axis_group, get_mesh

    def whole(t, mp_dim, dim):
        if dim is not None:
            t = C.all_gather_cat(t.contiguous(), axis_group("sharding"), dim)
        if mp_dim is not None:
            t = C.all_gather_cat(t.contiguous(), axis_group("mp"), mp_dim)
        return t

    def host(t):
        from .framework.io_utils import to_numpy

        return to_numpy(t.detach().cpu())

    with torch.no_grad():
        if optimizer is None:
            layout = model_layout(model)
            return {name: host(whole(t, *layout[name]))
                    for name, t in model.state_dict().items()}
        state = optimizer.state_dict()
        out = {k: v for k, v in state.items() if not isinstance(v, torch.Tensor)}
        from .optimizer.optimizer import param_name

        for i, p in enumerate(optimizer._param_list()):
            prefix = f"{param_name(p) or i}."
            mp_dim, _ = param_layout(p)
            dim = _Layout(p, 1, get_mesh()).dim
            for key, v in state.items():
                if isinstance(key, str) and key.startswith(prefix) \
                        and isinstance(v, torch.Tensor):
                    out[key] = host(whole(v, mp_dim, dim) if v.dim() else v)
        return out
