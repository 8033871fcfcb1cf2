"""``paddle.distributed``'s collective API over ``torch.distributed``
(``paddle_tpu/distributed/collective.py``).

The JAX package runs one controller over a mesh: a ``Group`` names a mesh
axis and a collective lowers to an XLA collective inside a traced region.
The port runs one process per rank, as Paddle and torch do: a ``Group``
holds the global ranks of its members and, where it spans more than one
rank, the ``torch.distributed`` process group every member made with it.
Each rank holds its own tensor and calls the collective itself.

A collective over a group of one rank, or before any process group
exists, is the identity (``tests/test_distributed.py:243-252``): a script
runs unchanged on one process. Once ``init_parallel_env`` made the default
group, its collectives run on the backend even at world size 1. ``src`` and ``dst`` are global ranks, as in
Paddle; ``ppermute`` and ``shift`` take group-local indices, as the JAX
functions do.

The backend is the group's own and never changes on its own: NCCL for the
card's tensors, gloo for the CPU's, or gloo for the card's when ranks
share a card (``new_group(backend="gloo")``, or ``PADDLE_DISTRI_BACKEND``
for the default group), where NCCL refuses. torch's gloo (2.11 on an H100,
``chip_smoke.py`` phase 18a) takes CUDA tensors for ``all_reduce``,
``broadcast``, ``all_gather``, ``reduce_scatter_tensor`` and
``all_to_all_single`` and stages them through the host itself; for ``scatter`` and the point-to-point sends a gloo group
copies a CUDA tensor to the host, runs gloo there and copies the result
back. It has no list all-to-all, on the host either, so ``alltoall`` is one
``all_to_all_single`` of the stacked inputs on both backends. The results
are the same over both backends.
"""
from __future__ import annotations

import warnings
from typing import List, Optional

import torch

__all__ = [
    "ReduceOp",
    "Group",
    "new_group",
    "get_group",
    "is_initialized",
    "destroy_process_group",
    "all_reduce",
    "all_gather",
    "all_gather_object",
    "broadcast",
    "reduce",
    "scatter",
    "reduce_scatter",
    "alltoall",
    "alltoall_single",
    "ppermute",
    "shift",
    "send",
    "recv",
    "isend",
    "irecv",
    "barrier",
    "wait",
]

class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


def _dist():
    import torch.distributed as dist

    return dist


def _torch_op(op):
    dist = _dist()
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.PROD: dist.ReduceOp.PRODUCT,
            ReduceOp.AVG: dist.ReduceOp.SUM}[op]


class Group:
    """A set of global ranks, and its process group where it has one.

    ``pg`` is None before ``init_parallel_env``, for a group of one rank
    other than the default one, and on a rank outside the group;
    ``backend`` is "nccl" or "gloo" (None without a process group)."""

    _next_id = [0]

    def __init__(self, ranks: List[int], axis_name: Optional[str] = None, pg=None,
                 backend: Optional[str] = None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.axis_name = axis_name
        self.pg = pg
        self.backend = backend
        self.id = Group._next_id[0]
        Group._next_id[0] += 1

    @property
    def rank(self):
        """This process's index in the group, or -1 outside it."""
        from .parallel import get_rank

        return self.get_group_rank(get_rank())

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self):
        return self.rank >= 0

    @property
    def process_group(self):
        return self.pg

    def __repr__(self):
        return (f"Group(id={self.id}, nranks={self.nranks}, axis={self.axis_name}, "
                f"backend={self.backend})")


_groups = {}
_default_group: Optional[Group] = None


def _ensure_default() -> Group:
    """The default group: every rank of the world, over the default process
    group once ``init_parallel_env`` made it."""
    global _default_group
    dist = _dist()
    if _default_group is None or (_default_group.pg is None and dist.is_initialized()):
        if dist.is_initialized():
            world, pg, backend = dist.get_world_size(), dist.group.WORLD, dist.get_backend()
        else:
            from .parallel import get_world_size

            world, pg, backend = get_world_size(), None, None
        _default_group = Group(list(range(world)), pg=pg, backend=backend)
        _groups[0] = _default_group
    return _default_group


def get_group(gid: int = 0) -> Group:
    _ensure_default()
    return _groups.get(gid)


def new_group(ranks=None, backend=None, timeout=None, axis_name=None) -> Group:
    """A group of ``ranks`` (every rank when None). Every rank of the world
    calls it, members or not, in the same order (torch's rule, and
    Paddle's). ``backend`` is the default group's when None."""
    dist = _dist()
    default = _ensure_default()
    ranks = sorted(int(r) for r in ranks) if ranks is not None else list(default.ranks)
    pg = None
    backend = backend or default.backend
    if dist.is_initialized() and len(ranks) > 1:
        if backend == "nccl":
            _check_nccl_devices()
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(ranks, backend=backend, **kw)
        if pg is dist.GroupMember.NON_GROUP_MEMBER:
            pg = None
    g = Group(ranks, axis_name=axis_name, pg=pg, backend=backend if len(ranks) > 1 else None)
    _groups[g.id] = g
    return g


def _check_nccl_devices():
    from .parallel import _nccl_shares_a_card

    reason = _nccl_shares_a_card()
    if reason:
        raise RuntimeError(reason)


def is_initialized() -> bool:
    return _dist().is_initialized()


def destroy_process_group(group=None):
    """Tear down ``group``'s process group, or every group and the default
    one when None."""
    global _default_group
    dist = _dist()
    if group is None:
        _groups.clear()
        _default_group = None
        if dist.is_initialized():
            dist.destroy_process_group()
        return
    if group.pg is not None and dist.is_initialized():
        dist.destroy_process_group(group.pg)
    group.pg = None
    _groups.pop(group.id, None)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _raw(t):
    """The torch tensor of a Paddle Tensor (its value cell), or ``t``."""
    return t._value if hasattr(t, "_value") and not isinstance(t, torch.Tensor) else t


def _set_raw(t, value):
    """Write ``value`` into ``t`` in place (a Paddle Tensor's cell is rebound
    when the shape changes)."""
    raw = _raw(t)
    if isinstance(raw, torch.Tensor) and raw.shape == value.shape:
        with torch.no_grad():
            raw.copy_(value)
        return t
    t._value = value
    return t


def _group(group) -> Group:
    return group if group is not None else _ensure_default()


def _active(g: Group) -> bool:
    """Whether a collective over ``g`` runs on a process group: the default
    group's always once one exists (NCCL or gloo runs it even over one
    rank), another group's where it has more than one rank."""
    return g.pg is not None


def _staged(g: Group, t: torch.Tensor) -> bool:
    """Whether ``scatter`` or a point-to-point send stages ``t`` through the
    host: torch's gloo runs those on CPU tensors only."""
    return g.backend == "gloo" and t.is_cuda


def _host(t):
    return t.detach().cpu() if t.is_cuda else t


def _wrap_like(template, value):
    """``value`` as the kind of ``template``: a Paddle Tensor for a Tensor."""
    if isinstance(template, torch.Tensor) or template is None:
        return value
    from ..core.tensor import Tensor

    return Tensor(value, stop_gradient=True)


# ---------------------------------------------------------------------------
# collectives on torch tensors (the layers' autograd functions call these)
# ---------------------------------------------------------------------------
def all_reduce_(t: torch.Tensor, op=ReduceOp.SUM, group=None) -> torch.Tensor:
    g = _group(group)
    if not _active(g):
        return t
    dist = _dist()
    dist.all_reduce(t, op=_torch_op(op), group=g.pg)
    if op == ReduceOp.AVG:
        t.div_(g.nranks)
    return t


def all_reduce_flat(tensors, group=None, average=False) -> None:
    """Sum (or average) ``tensors`` over ``group`` in place: one flat
    all-reduce per dtype."""
    g = _group(group)
    if not _active(g) or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, ReduceOp.SUM, g)
        if average:
            flat.div_(g.nranks)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The members' ``t`` concatenated along ``dim``, in group order."""
    g = _group(group)
    if not _active(g):
        return t
    dist = _dist()
    parts = [torch.empty_like(t) for _ in range(g.nranks)]
    dist.all_gather(parts, t.contiguous(), group=g.pg)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(t: torch.Tensor, group=None, dim: int = 0,
                       op=ReduceOp.SUM) -> torch.Tensor:
    """This member's chunk, along ``dim``, of the members' reduced ``t``."""
    g = _group(group)
    if not _active(g):
        return t
    dist = _dist()
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // g.nranks,) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():  # torch 2.13 names it reduce_scatter_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, op=_torch_op(op), group=g.pg)
    if op == ReduceOp.AVG:
        out.div_(g.nranks)
    return out.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# the Paddle API
# ---------------------------------------------------------------------------
def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None, sync_op=True):
    """In place on ``tensor``; returns it."""
    with torch.no_grad():
        all_reduce_(_raw(tensor), op, group)
    return tensor


def all_gather(tensor_list, tensor, group: Optional[Group] = None, sync_op=True):
    """Appends each member's ``tensor`` to ``tensor_list`` (group order) and
    returns them stacked; over one rank, ``tensor`` itself."""
    g = _group(group)
    t = _raw(tensor)
    if not _active(g):
        if isinstance(tensor_list, list):
            tensor_list.append(_wrap_like(tensor, t.clone()))
        return tensor
    with torch.no_grad():
        stacked = all_gather_cat(t.unsqueeze(0), g, 0)
    if isinstance(tensor_list, list):
        tensor_list.extend(_wrap_like(tensor, s) for s in stacked.unbind(0))
    return _wrap_like(tensor, stacked)


def all_gather_object(object_list, obj, group=None):
    g = _group(group)
    if not _active(g):
        object_list.append(obj)
        return object_list
    out = [None] * g.nranks
    _dist().all_gather_object(out, obj, group=g.pg)
    object_list.extend(out)
    return object_list


def broadcast(tensor, src: int = 0, group: Optional[Group] = None, sync_op=True):
    """``src``'s ``tensor`` written into every member's, in place."""
    g = _group(group)
    t = _raw(tensor)
    if _active(g):
        with torch.no_grad():
            _dist().broadcast(t, src=int(src), group=g.pg)
    return tensor


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group: Optional[Group] = None,
           sync_op=True):
    """The members' reduction in ``dst``'s ``tensor``; the others' keep their
    values. An all-reduce of a copy, whose result only ``dst`` keeps."""
    g = _group(group)
    if not _active(g):
        return tensor
    t = _raw(tensor)
    with torch.no_grad():
        out = all_reduce_(t.clone(), op, g)
        from .parallel import get_rank

        if get_rank() == int(dst):
            t.copy_(out)
    return tensor


def scatter(tensor, tensor_list=None, src: int = 0, group: Optional[Group] = None,
            sync_op=True):
    """Member i of the group takes ``tensor_list[i]`` of ``src``."""
    g = _group(group)
    if not _active(g):
        if tensor_list:
            _set_raw(tensor, _raw(tensor_list[0]).clone())
        return tensor
    t = _raw(tensor)
    with torch.no_grad():
        from .parallel import get_rank

        mine = get_rank() == int(src)
        if _staged(g, t):
            out = torch.empty_like(_host(t))
            parts = [_host(_raw(x)).contiguous() for x in tensor_list] if mine else None
            _dist().scatter(out, parts, src=int(src), group=g.pg)
            t.copy_(out)
        else:
            parts = [_raw(x).contiguous() for x in tensor_list] if mine else None
            _dist().scatter(t, parts, src=int(src), group=g.pg)
    return tensor


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group: Optional[Group] = None, sync_op=True):
    """``tensor`` takes this member's chunk (along dim 0) of the members'
    reduced input: a list is concatenated along dim 0 first."""
    inp = tensor_or_tensor_list
    val = (torch.cat([_raw(x) for x in inp], dim=0) if isinstance(inp, (list, tuple))
           else _raw(inp))
    with torch.no_grad():
        out = reduce_scatter_dim(val, group, 0, op)
    return _set_raw(tensor, out)


def alltoall(in_tensor_list, out_tensor_list=None, group: Optional[Group] = None,
             sync_op=True):
    """Member j's ``out[i]`` is member i's ``in[j]``; returns the outputs."""
    g = _group(group)
    ins = [_raw(x) for x in in_tensor_list] if isinstance(in_tensor_list, (list, tuple)) \
        else list(_raw(in_tensor_list).unbind(0))
    template = in_tensor_list[0] if isinstance(in_tensor_list, (list, tuple)) \
        else in_tensor_list
    if not _active(g):
        res = [_wrap_like(template, x.clone()) for x in ins]
    else:
        # one all_to_all_single over the stacked inputs: gloo has no list form
        # in every torch version (2.11's refuses it)
        with torch.no_grad():
            out = alltoall_single(torch.stack(ins), group=g)
        res = [_wrap_like(template, o) for o in out.unbind(0)]
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(res)
    return res


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None, out_split_sizes=None,
                    group: Optional[Group] = None, sync_op=True):
    """Dim 0 of ``in_tensor`` split among the members (``in_split_sizes``,
    equal chunks when None); the received chunks concatenated in group
    order."""
    g = _group(group)
    val = _raw(in_tensor)
    if not _active(g):
        out = val.clone()
    else:
        with torch.no_grad():
            src = val.contiguous()
            if out_split_sizes is None:
                shape = src.shape
            else:
                shape = (int(sum(out_split_sizes)),) + tuple(src.shape[1:])
            out = torch.empty(shape, dtype=src.dtype, device=src.device)
            _dist().all_to_all_single(out, src, out_split_sizes, in_split_sizes, group=g.pg)
    if out_tensor is not None:
        return _set_raw(out_tensor, out)
    return _wrap_like(in_tensor, out)


def ppermute(tensor, perm, group: Optional[Group] = None):
    """A permutation over the group: ``perm`` holds (src, dst) pairs of group
    indices, each source and each destination at most once. A member named
    as no destination receives zeros. Returns the received tensor."""
    g = _group(group)
    t = _raw(tensor)
    pairs = [(int(a), int(b)) for a, b in perm]
    if not _active(g):
        out = t.clone() if (0, 0) in pairs else torch.zeros_like(t)
        return _wrap_like(tensor, out)
    dist = _dist()
    me = g.rank
    staged = _staged(g, t)
    src_t = (_host(t) if staged else t).contiguous()
    out = torch.zeros_like(src_t)
    ops = []
    for a, b in pairs:
        if a == me and b == me:
            out.copy_(src_t)
        elif a == me:
            ops.append(dist.P2POp(dist.isend, src_t, g.ranks[b], group=g.pg))
        elif b == me:
            ops.append(dist.P2POp(dist.irecv, out, g.ranks[a], group=g.pg))
    with torch.no_grad():
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
    return _wrap_like(tensor, out.to(t.device))


def shift(tensor, offset: int = 1, group: Optional[Group] = None, wrap: bool = False):
    """Member i's tensor to member i + ``offset``; without ``wrap`` the edge
    members receive zeros."""
    n = _group(group).nranks
    if wrap:
        perm = [(i, (i + offset) % n) for i in range(n)]
    else:
        perm = [(i, i + offset) for i in range(n) if 0 <= i + offset < n]
    return ppermute(tensor, perm, group)


class _Task:
    """What ``isend`` / ``irecv`` return: ``wait()`` blocks until done."""

    def __init__(self, work=None, after=None):
        self._work = work
        self._after = after

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
            if self._after is not None:
                self._after()
        return True

    def is_completed(self):
        return self._work is None


def _p2p(tensor, peer, group, send_it: bool, wait: bool):
    g = _group(group)
    if not _active(g):
        return _Task() if not wait else tensor
    dist = _dist()
    t = _raw(tensor)
    staged = _staged(g, t)
    buf = _host(t).contiguous() if staged else t
    fn = dist.isend if send_it else dist.irecv
    work = fn(buf, int(peer), group=g.pg)
    after = (lambda: t.copy_(buf)) if staged and not send_it else None
    task = _Task(work, after)
    if wait:
        task.wait()
        return tensor
    return task


def send(tensor, dst: int = 0, group: Optional[Group] = None, sync_op=True):
    return _p2p(tensor, dst, group, True, True)


def recv(tensor, src: int = 0, group: Optional[Group] = None, sync_op=True):
    return _p2p(tensor, src, group, False, True)


def isend(tensor, dst: int = 0, group: Optional[Group] = None):
    return _p2p(tensor, dst, group, True, False)


def irecv(tensor, src: int = 0, group: Optional[Group] = None):
    return _p2p(tensor, src, group, False, False)


def barrier(group: Optional[Group] = None):
    """Every member waits for the others: an all-reduce of one element on
    the group backend's device."""
    g = _group(group)
    if not _active(g):
        return
    dev = torch.device("cuda", torch.cuda.current_device()) if g.backend == "nccl" \
        else torch.device("cpu")
    all_reduce_(torch.zeros(1, device=dev), ReduceOp.SUM, g)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the work queued on ``tensor``'s device is done."""
    t = _raw(tensor)
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return tensor
