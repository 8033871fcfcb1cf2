"""The hybrid topology: ranks laid out over named axes
(``paddle_tpu/parallel/topology.py``).

The JAX package's topology is a ``jax.sharding.Mesh`` of devices driven by
one controller. The port runs a process per rank, so the "mesh" here is the
grid of global ranks (``RankMesh``: ``axis_names`` and ``devices``, the
ranks array, as a Mesh has them) and ``HybridCommunicateGroup`` makes one
real process group per axis and coordinate, in ``AXIS_ORDER``: every rank
makes every group, in the same order, as torch requires. The rank of a
coordinate and the groups of an axis (``get_comm_list``) are the JAX
topology's, so the same degrees give the same lists.
"""
from __future__ import annotations

import collections
import itertools
from typing import Dict, Optional

import numpy as np

# outermost first; mp is innermost, so an mp group is ranks next to each other
AXIS_ORDER = ("pp", "dp", "sharding", "sep", "mp")
_NAMES = {"pp": "pipe", "dp": "data", "sharding": "sharding", "sep": "sep", "mp": "model"}

_global = {"hcg": None, "mesh": None}


class CommunicateTopology:
    """reference: fleet/base/topology.py:52 — named hybrid dims and rank math."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = collections.namedtuple("Coordinate", self._parallel_names)
        self._coord2rank = {}
        self._rank2coord = {}
        for rank, coord in enumerate(itertools.product(*[range(d) for d in self._dims])):
            c = self.coordinate(*coord)
            self._coord2rank[c] = rank
            self._rank2coord[rank] = c

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs):
        return self._coord2rank[self.coordinate(**kwargs)]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on ``axis_name`` equals ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items() if c[axis] == index)

    def get_comm_list(self, axis_name):
        """The rank groups that vary only along ``axis_name``."""
        return self.get_comm_list_of((axis_name,))

    def get_comm_list_of(self, axis_names):
        """The rank groups that vary only along the axes ``axis_names``."""
        axes = {self._parallel_names.index(a) for a in axis_names}
        groups = collections.defaultdict(list)
        for c, r in sorted(self._coord2rank.items(), key=lambda kv: kv[1]):
            key = tuple(v for i, v in enumerate(c) if i not in axes)
            groups[key].append(r)
        return [sorted(v) for _, v in sorted(groups.items())]


class RankMesh:
    """The grid of global ranks over ``AXIS_ORDER``: ``axis_names``, and
    ``devices``, the ranks array of that shape (a ``jax.sharding.Mesh``'s
    two attributes the sharding rules read)."""

    def __init__(self, shape: Dict[str, int]):
        self.axis_names = tuple(AXIS_ORDER)
        dims = [int(shape.get(a, 1)) for a in AXIS_ORDER]
        self.devices = np.arange(int(np.prod(dims))).reshape(dims)
        self.shape = dict(zip(self.axis_names, dims))

    def __repr__(self):
        return f"RankMesh({self.shape})"


class HybridCommunicateGroup:
    """reference: fleet/base/topology.py:133 — the degrees, this rank's
    coordinates and one group per axis (plus ``get_batch_group``, the dp x
    sharding ranks that share a batch split, and the check group, the
    world)."""

    def __init__(self, topology: CommunicateTopology):
        from ..distributed.parallel import get_rank, get_world_size

        self._topo = topology
        self.nranks = topology.world_size()
        world = get_world_size()
        if self.nranks not in (1, world):
            raise ValueError(
                f"the topology {dict(zip(topology.get_hybrid_group_names(), topology._dims))} "
                f"needs {self.nranks} ranks; the world has {world}"
            )
        self.global_rank = get_rank() if self.nranks > 1 else 0
        names = topology.get_hybrid_group_names()

        def dim(name):
            return topology.get_dim(name) if name in names else 1

        self._dp_degree = dim("data")
        self._mp_degree = dim("model")
        self._pp_degree = dim("pipe")
        self._sharding_degree = dim("sharding")
        self._sep_degree = dim("sep")
        self._groups = {}
        for axis in ("pipe", "data", "sharding", "sep", "model"):
            self._groups[axis] = self._make((axis,))
        self._groups["batch"] = self._make(("data", "sharding"))
        from ..distributed import collective as C

        self._check = C._ensure_default() if self.nranks > 1 else C.Group([0])

    def _make(self, axes):
        """This rank's group along ``axes``; every rank makes every group."""
        from ..distributed import collective as C

        names = self._topo.get_hybrid_group_names()
        axes = tuple(a for a in axes if a in names)
        label = "+".join({"data": "dp", "model": "mp", "pipe": "pp"}.get(a, a) for a in axes)
        if not axes:
            return C.Group([self.global_rank], axis_name=label)
        mine = None
        for ranks in self._topo.get_comm_list_of(axes):
            if len(ranks) == 1:
                g = C.Group(ranks, axis_name=label)
            else:
                g = C.new_group(ranks, axis_name=label)
            if self.global_rank in ranks:
                mine = g
        return mine

    # degrees (reference: topology.py:139-142)
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def _coord(self):
        return self._topo.get_coord(self.global_rank)

    def _index(self, name):
        return getattr(self._coord(), name) if name in self._topo.get_hybrid_group_names() \
            else 0

    def get_data_parallel_rank(self):
        return self._index("data")

    def get_model_parallel_rank(self):
        return self._index("model")

    def get_stage_id(self):
        return self._index("pipe")

    def get_sharding_parallel_rank(self):
        return self._index("sharding")

    def get_sep_parallel_rank(self):
        return self._index("sep")

    def get_data_parallel_group(self):
        return self._groups["data"]

    def get_model_parallel_group(self):
        return self._groups["model"]

    def get_pipe_parallel_group(self):
        return self._groups["pipe"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sep_parallel_group(self):
        return self._groups["sep"]

    def get_batch_group(self):
        """The dp x sharding ranks of this rank's (pp, sep, mp) coordinate:
        those that split one batch and average their gradients."""
        return self._groups["batch"]

    def get_batch_rank(self):
        """This rank's index in the batch split: dp major, as the JAX
        package's ``P(("dp", "sharding"))`` orders the rows."""
        return self.get_data_parallel_rank() * self._sharding_degree \
            + self.get_sharding_parallel_rank()

    def get_check_parallel_group(self):
        return self._check

    def get_data_parallel_group_src_rank(self):
        return self._groups["data"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["model"].ranks[0]

    def topology(self):
        return self._topo

    def mesh_shape(self) -> Dict[str, int]:
        return {"pp": self._pp_degree, "dp": self._dp_degree,
                "sharding": self._sharding_degree, "sep": self._sep_degree,
                "mp": self._mp_degree}


def init_mesh(dp=1, mp=1, pp=1, sharding=1, sep=1, devices=None) -> RankMesh:
    """Install the topology of these degrees and its groups; returns the
    rank grid. Every rank calls it with the same degrees. ``devices`` is
    accepted for the JAX signature: a rank's card is bound by
    ``init_parallel_env``."""
    topo = CommunicateTopology(
        ["pipe", "data", "sharding", "sep", "model"], [pp, dp, sharding, sep, mp]
    )
    hcg = HybridCommunicateGroup(topo)
    mesh = RankMesh(hcg.mesh_shape())
    _global["hcg"] = hcg
    _global["mesh"] = mesh
    return mesh


def get_mesh() -> Optional[RankMesh]:
    return _global["mesh"]


def axis_size(name: str, mesh=None) -> int:
    """The degree of a named axis (1 when absent or nothing is installed)."""
    mesh = mesh or _global["mesh"]
    if mesh is None:
        return 1
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name, 1)


def axis_index(name: str) -> int:
    """This rank's coordinate on a named axis (0 when nothing is installed)."""
    hcg = _global["hcg"]
    if hcg is None:
        return 0
    return hcg._index(_NAMES[name])


def axis_group(name: str):
    """This rank's group along a named axis, or None when nothing is
    installed."""
    hcg = _global["hcg"]
    if hcg is None:
        return None
    return hcg._groups[_NAMES.get(name, name)]


def set_mesh(mesh, hcg=None) -> None:
    _global["mesh"] = mesh
    _global["hcg"] = hcg


class use_mesh:
    """Install ``mesh`` (and ``hcg``) for the block, then restore the previous."""

    def __init__(self, mesh, hcg=None):
        self._mesh = mesh
        self._hcg = hcg

    def __enter__(self):
        self._prev = (_global["mesh"], _global["hcg"])
        set_mesh(self._mesh, self._hcg)
        return self._mesh

    def __exit__(self, *exc):
        _global["mesh"], _global["hcg"] = self._prev
        return False


def get_hcg() -> Optional[HybridCommunicateGroup]:
    return _global["hcg"]


def _set_hcg(hcg):
    _global["hcg"] = hcg


def global_mesh() -> RankMesh:
    """The installed grid; a data-parallel one over the world when none is."""
    m = _global["mesh"]
    if m is None:
        from ..distributed.parallel import get_world_size

        m = init_mesh(dp=get_world_size())
    return m
