"""Parameter-server sparse path of the port: host-RAM embedding tables and the
layer that feeds their rows to the card (``paddle_tpu/distributed/ps``).

Reference analogue:
  - paddle/fluid/distributed/ps/table/memory_sparse_table.cc: a sharded
    host-RAM embedding store whose accessor applies the optimizer on push;
  - paddle/fluid/operators/pscore/distributed_lookup_table_op.cc: the lookup
    trainers call.

The tables are the JAX package's C++ (``csrc/``, a copy: host code is
re-bound, not rewritten), built with g++ at first use by
``utils.cpp_extension`` into ``paddle_tpu_torch/_build/`` and bound over
ctypes, which releases the GIL during each call. The card never holds the
table: each step pulls the minibatch's rows, uploads them as one block,
computes densely, and pushes the rows' gradients back to the host, where
the C++ accessor applies SGD, AdaGrad or Adam per feature.

``SparseEmbedding`` is a ``torch.autograd.Function`` over that round trip.
Deliberate differences from the JAX layer: it refuses to run while a CUDA
graph is capturing (the JAX layer refuses a jit trace), because a pull is a
host read of the ids and a replay would reuse stale rows; under lazy
dispatch (``core/lazy.py``) its host read ends the pending segment, so it is
never deferred nor captured.

``TheOnePSRuntime`` (and ``the_one_ps.py``, ``ps/utils/ps_factory.py``)
needs ``fleet.init`` in PS mode: ROADMAP, open items, queue 1 item 13c.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from ...nn.layer_base import Layer

__all__ = [
    "CtrAccessorConfig", "MemorySparseTable", "GraphTable", "SparseEmbedding",
    "TheOnePSRuntime", "PsServer", "PsClient", "DistributedSparseTable",
    "GeoDistributedSparseTable", "DenseTableHandle", "Communicator", "SparsePipeline",
]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

_lib = None

# (symbol, restype, argtypes) of the table library's C functions
_P, _I64, _F, _U64, _INT, _STR = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                                  ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p)
_TABLE_SIGNATURES = [
    ("ps_table_create", _P, [_INT, _INT, _INT, _F, _F, _U64]),
    ("ps_table_destroy", None, [_P]),
    ("ps_table_pull", None, [_P, _P, _I64, _P, _INT]),
    ("ps_table_push", None, [_P, _P, _I64, _P]),
    ("ps_table_push_raw", None, [_P, _P, _I64, _P]),
    ("ps_table_size", _I64, [_P]),
    ("ps_table_save", _INT, [_P, _STR]),
    ("ps_table_load", _INT, [_P, _STR]),
    ("ps_table_set_lr", None, [_P, _F]),
    ("ps_table_set_ctr", None, [_P] + [_F] * 5),
    ("ps_table_push_ctr", None, [_P, _P, _I64, _P, _P, _P]),
    ("ps_table_shrink", _I64, [_P]),
    ("ps_table_ctr_stats", _INT, [_P, _I64, _P]),
    ("ps_table_enable_ssd", _INT, [_P, _STR, _I64]),
    ("ps_table_ram_size", _I64, [_P]),
    ("ps_table_disk_size", _I64, [_P]),
    ("ps_graph_create", _P, [_INT, _INT, _U64]),
    ("ps_graph_destroy", None, [_P]),
    ("ps_graph_add_edges", None, [_P, _P, _P, _P, _I64]),
    ("ps_graph_set_node_feat", None, [_P, _P, _I64, _P]),
    ("ps_graph_get_node_feat", _I64, [_P, _P, _I64, _P]),
    ("ps_graph_degree", _I64, [_P, _I64]),
    ("ps_graph_sample_neighbors", None, [_P, _P, _I64, _INT, _INT, _U64, _P, _P]),
    ("ps_graph_random_sample_nodes", _I64, [_P, _I64, _U64, _P]),
    ("ps_graph_node_count", _I64, [_P]),
    ("ps_graph_edge_count", _I64, [_P]),
    ("ps_graph_save", _INT, [_P, _STR]),
    ("ps_graph_load", _INT, [_P, _STR]),
]


def bind(lib, signatures):
    """Set the restype and argtypes of each C function of ``lib``."""
    for symbol, restype, argtypes in signatures:
        fn = getattr(lib, symbol)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _load_lib():
    """The table library (``csrc/memory_sparse_table.cc``), built at first
    use; a build that fails raises."""
    global _lib
    if _lib is None:
        from ...utils import cpp_extension

        lib = cpp_extension.load(
            "ps_table", [os.path.join(CSRC, "memory_sparse_table.cc")],
            depends=[os.path.join(CSRC, "ps_sparse_table.h"),
                     os.path.join(CSRC, "graph_table.h")],
        )
        _lib = bind(lib, _TABLE_SIGNATURES)
    return _lib


_OPT_IDS = {"sgd": 0, "adagrad": 1, "adam": 2}


def _keys(keys) -> np.ndarray:
    return np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)


def _rows(values, n, dim) -> np.ndarray:
    return np.ascontiguousarray(values, dtype=np.float32).reshape(n, dim)


class CtrAccessorConfig:
    """CTR semantics on a sparse table (reference: ps/table/ctr_accessor.h
    CtrCommonAccessor): show and click counters folded in on push, time
    decay, and eviction by score = show_coeff * (show - click) + click_coeff
    * click."""

    def __init__(self, show_coeff: float = 0.25, click_coeff: float = 1.0,
                 decay_rate: float = 0.98, delete_threshold: float = 0.8,
                 delete_after_unseen_days: float = 30.0):
        self.show_coeff = float(show_coeff)
        self.click_coeff = float(click_coeff)
        self.decay_rate = float(decay_rate)
        self.delete_threshold = float(delete_threshold)
        self.delete_after_unseen_days = float(delete_after_unseen_days)

    def as_floats(self):
        return (self.show_coeff, self.click_coeff, self.decay_rate, self.delete_threshold,
                self.delete_after_unseen_days)


class MemorySparseTable:
    """The sharded host table of one embedding: a row per int64 feature id,
    made on first pull from a per-key seeded init, updated on push by the
    table's optimizer. With ``ssd_path`` entries past ``ram_budget`` spill
    to a slot file there and are promoted on demand (reference:
    ps/table/ssd_sparse_table.h)."""

    def __init__(self, emb_dim: int, shard_num: int = 16, optimizer: str = "adagrad",
                 learning_rate: float = 0.05, init_range: float = 0.01, seed: int = 0,
                 ctr: Optional[CtrAccessorConfig] = None, ssd_path: Optional[str] = None,
                 ram_budget: Optional[int] = None):
        if optimizer not in _OPT_IDS:
            raise ValueError(f"optimizer must be one of {sorted(_OPT_IDS)}")
        self.emb_dim = emb_dim
        self._lib = _load_lib()
        self._h = self._lib.ps_table_create(
            emb_dim, shard_num, _OPT_IDS[optimizer], ctypes.c_float(learning_rate),
            ctypes.c_float(init_range), ctypes.c_uint64(seed),
        )
        self.ctr = ctr
        if ctr is not None:
            self._lib.ps_table_set_ctr(self._h, *[ctypes.c_float(v) for v in ctr.as_floats()])
        self.ssd_path = ssd_path
        if ssd_path is not None:
            if ram_budget is None:
                raise ValueError("ssd_path requires ram_budget (max RAM entries)")
            rc = self._lib.ps_table_enable_ssd(self._h, str(ssd_path).encode(),
                                               ctypes.c_int64(ram_budget))
            if rc != 0:
                raise OSError(f"cannot create SSD slot file at {ssd_path}")

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ps_table_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def pull(self, keys, create: bool = True) -> np.ndarray:
        """The rows of ``keys`` as an [n, emb_dim] f32 array; a missing key
        is made (``create``) or read as zeros."""
        keys = _keys(keys)
        out = np.empty((keys.size, self.emb_dim), np.float32)
        self._lib.ps_table_pull(self._h, keys.ctypes.data, keys.size, out.ctypes.data,
                                1 if create else 0)
        return out

    def push(self, keys, grads):
        """Apply the table's optimizer to the rows of ``keys`` with ``grads``."""
        keys = _keys(keys)
        grads = _rows(grads, keys.size, self.emb_dim)
        self._lib.ps_table_push(self._h, keys.ctypes.data, keys.size, grads.ctypes.data)

    def push_raw(self, keys, deltas):
        """Add ``deltas`` to the rows, with no optimizer: the geo-async merge."""
        keys = _keys(keys)
        deltas = _rows(deltas, keys.size, self.emb_dim)
        self._lib.ps_table_push_raw(self._h, keys.ctypes.data, keys.size, deltas.ctypes.data)

    def set_lr(self, lr: float):
        self._lib.ps_table_set_lr(self._h, ctypes.c_float(lr))

    def push_ctr(self, keys, shows, clicks, grads):
        """CTR push: fold the show and click counts in, reset the unseen
        clock, apply the SGD rule (reference ctr_accessor.cc Update)."""
        keys = _keys(keys)
        shows = np.ascontiguousarray(shows, np.float32).reshape(-1)
        clicks = np.ascontiguousarray(clicks, np.float32).reshape(-1)
        grads = _rows(grads, keys.size, self.emb_dim)
        self._lib.ps_table_push_ctr(self._h, keys.ctypes.data, keys.size, shows.ctypes.data,
                                    clicks.ctypes.data, grads.ctypes.data)

    def shrink(self) -> int:
        """One decay and eviction pass (one day); returns how many were evicted."""
        return int(self._lib.ps_table_shrink(self._h))

    def ctr_stats(self, key: int):
        """(show, click, unseen_days, score) of ``key``, or None when absent."""
        out = np.zeros(4, np.float32)
        if self._lib.ps_table_ctr_stats(self._h, int(key), out.ctypes.data) != 0:
            return None
        return tuple(float(v) for v in out)

    def __len__(self):
        return int(self._lib.ps_table_size(self._h))

    def ram_size(self) -> int:
        """Entries resident in RAM (``len()`` without SSD overflow)."""
        return int(self._lib.ps_table_ram_size(self._h))

    def disk_size(self) -> int:
        """Entries spilled to the SSD slot file."""
        return int(self._lib.ps_table_disk_size(self._h))

    def save(self, path: str):
        if self._lib.ps_table_save(self._h, str(path).encode()) != 0:
            raise IOError(f"saving sparse table to {path} failed")

    def load(self, path: str):
        if self._lib.ps_table_load(self._h, str(path).encode()) != 0:
            raise IOError(f"loading sparse table from {path} failed")


class GraphTable:
    """A sharded host graph store with neighbour sampling (reference:
    ps/table/common_graph_table.h)."""

    def __init__(self, shard_num: int = 16, feat_dim: int = 0, seed: int = 0):
        self.feat_dim = int(feat_dim)
        self._lib = _load_lib()
        self._h = self._lib.ps_graph_create(int(shard_num), self.feat_dim,
                                            ctypes.c_uint64(seed))
        self._calls = 0

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ps_graph_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def add_edges(self, src, dst, weights=None):
        src, dst = _keys(src), _keys(dst)
        if src.size != dst.size:
            raise ValueError("src/dst length mismatch")
        wp = 0
        if weights is not None:
            weights = np.ascontiguousarray(weights, np.float32).reshape(-1)
            if weights.size != src.size:
                raise ValueError("weights length mismatch")
            wp = weights.ctypes.data
        self._lib.ps_graph_add_edges(self._h, src.ctypes.data, dst.ctypes.data, wp, src.size)

    def set_node_feat(self, ids, feats):
        if self.feat_dim <= 0:
            raise ValueError("GraphTable built with feat_dim=0")
        ids = _keys(ids)
        feats = _rows(feats, ids.size, self.feat_dim)
        self._lib.ps_graph_set_node_feat(self._h, ids.ctypes.data, ids.size, feats.ctypes.data)

    def get_node_feat(self, ids) -> np.ndarray:
        ids = _keys(ids)
        out = np.empty((ids.size, self.feat_dim), np.float32)
        self._lib.ps_graph_get_node_feat(self._h, ids.ctypes.data, ids.size, out.ctypes.data)
        return out

    def degree(self, node: int) -> int:
        return int(self._lib.ps_graph_degree(self._h, int(node)))

    def sample_neighbors(self, ids, k: int, weighted: bool = False):
        """(neighbours [n, k] padded with -1, counts [n]). Uniform sampling
        is without replacement (k at or above the degree gives the whole
        neighbourhood); weighted sampling draws by edge weight with
        replacement."""
        ids = _keys(ids)
        nbrs = np.empty((ids.size, int(k)), np.int64)
        cnt = np.empty(ids.size, np.int32)
        self._calls += 1
        self._lib.ps_graph_sample_neighbors(
            self._h, ids.ctypes.data, ids.size, int(k), 1 if weighted else 0,
            ctypes.c_uint64(self._calls), nbrs.ctypes.data, cnt.ctypes.data,
        )
        return nbrs, cnt

    def random_sample_nodes(self, count: int) -> np.ndarray:
        out = np.empty(int(count), np.int64)
        self._calls += 1
        m = self._lib.ps_graph_random_sample_nodes(self._h, int(count),
                                                   ctypes.c_uint64(self._calls), out.ctypes.data)
        return out[:m]

    def node_count(self) -> int:
        return int(self._lib.ps_graph_node_count(self._h))

    def edge_count(self) -> int:
        return int(self._lib.ps_graph_edge_count(self._h))

    def save(self, path: str):
        if self._lib.ps_graph_save(self._h, str(path).encode()) != 0:
            raise IOError(f"saving graph table to {path} failed")

    def load(self, path: str):
        """Replace the whole graph with a saved one of the same feat_dim."""
        if self._lib.ps_graph_load(self._h, str(path).encode()) != 0:
            raise IOError(f"loading graph table from {path} failed")


def merged_push(table, keys: np.ndarray, grads: np.ndarray, pad_idx=None):
    """Push ``grads`` of ``keys`` with duplicates summed first (one optimizer
    update per feature per step, the trainer-side merge of the reference)
    and ``pad_idx`` rows dropped."""
    if pad_idx is not None:
        keep = keys != pad_idx
        keys, grads = keys[keep], grads[keep]
    if keys.size == 0:
        return
    uniq, inv = np.unique(keys, return_inverse=True)
    merged = np.zeros((uniq.size, grads.shape[1]), np.float32)
    np.add.at(merged, inv, grads)
    table.push(uniq, merged)


class _SparseLookup(torch.autograd.Function):
    """Forward: the pulled rows, uploaded as one block to ``device``.
    Backward: the block's gradient read back to the host, merged and pushed
    into the table; no gradient flows further (the ids are ints, the anchor
    is a zero-element stand-in that makes autograd call this backward)."""

    @staticmethod
    def forward(ctx, anchor, rows, shape, device, push):
        ctx.push = push
        return torch.from_numpy(rows).to(device).reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        ctx.push(grad.detach().to("cpu", torch.float32).numpy())
        return None, None, None, None, None


class SparseEmbedding(Layer):
    """An embedding whose weights live in a host PS table, not on the card
    (reference: paddle.static.nn.sparse_embedding, lowering to
    distributed_lookup_table / distributed_push_sparse).

    The forward pulls the minibatch's rows (made on a miss in training),
    zeroes the ``padding_idx`` rows and uploads one [..., dim] block to the
    ids' device; the backward pushes the block's gradient into the table,
    where the C++ accessor applies the per-feature optimizer, so
    ``optimizer.step()`` never sees these weights."""

    def __init__(self, size, shard_num: int = 16, optimizer: str = "adagrad",
                 learning_rate: float = 0.05, init_range: float = 0.01, seed: int = 0,
                 table=None, padding_idx: Optional[int] = None):
        super().__init__()
        # size = [vocab, emb_dim]; the vocab is advisory: the table is a hash map
        self.emb_dim = int(size[1])
        self.padding_idx = padding_idx
        # `is not None`, not truthiness: an empty table has len() 0
        self.table = (table if table is not None else MemorySparseTable(
            self.emb_dim, shard_num, optimizer, learning_rate, init_range, seed))

    def forward(self, ids):
        from torch._subclasses.fake_tensor import FakeTensor

        if isinstance(ids, FakeTensor) or (ids.device.type == "cuda"
                                           and torch.cuda.is_current_stream_capturing()):
            raise NotImplementedError(
                "SparseEmbedding pulls rows from the host table: a host read of the ids "
                "that cannot be deferred or captured in a CUDA graph; keep the sparse "
                "lookup in eager code and compile only the dense part"
            )
        ids_np = ids.detach().cpu().numpy().astype(np.int64, copy=False)
        flat = ids_np.reshape(-1)
        rows = self.table.pull(flat, create=self.training)
        if self.padding_idx is not None:
            # padding rows embed to zeros and never train
            rows[flat == self.padding_idx] = 0.0
        shape = (*ids_np.shape, self.emb_dim)
        if not (torch.is_grad_enabled() and self.training):
            return torch.from_numpy(rows).to(ids.device).reshape(shape)
        table, pad_idx, dim = self.table, self.padding_idx, self.emb_dim

        def push(grad: np.ndarray):
            merged_push(table, flat, grad.reshape(flat.size, dim), pad_idx)

        anchor = torch.empty(0, requires_grad=True)
        return _SparseLookup.apply(anchor, rows, shape, ids.device, push)


class TheOnePSRuntime:
    """The PS runtime's roles and table lifecycle (reference
    the_one_ps.py:816): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TheOnePSRuntime (and the_one_ps, ps.utils.ps_factory) needs fleet.init in PS "
            "mode, which is not ported yet (ROADMAP, open items, queue 1 item 13c); use "
            "MemorySparseTable, or PsServer / PsClient / DistributedSparseTable directly"
        )


from . import service  # noqa: E402,F401
from .service import (  # noqa: E402,F401
    Communicator, DenseTableHandle, DistributedSparseTable, GeoDistributedSparseTable,
    PsClient, PsServer, SparsePipeline,
)
