"""The parameter-server service of the port: servers, the client, and the
tables and loops over them (``paddle_tpu/distributed/ps/service.py``).

Reference analogue:
  - paddle/fluid/distributed/ps/service/brpc_ps_server.h: the PsService RPC
    server dispatching pull, push, barrier, save and load onto table shards;
  - paddle/fluid/distributed/ps/service/brpc_ps_client.h: a channel per
    server, keys partitioned by hash, fan-out and reassembly;
  - ps/service/communicator/communicator.h: sync, async and geo pushes.

The servers and the client are the JAX package's C++ (``csrc/ps_server.cc``,
``csrc/ps_client.cc``, a copy), speaking a framed binary protocol over TCP,
built by ``utils.cpp_extension`` and bound over ctypes. ctypes releases the
GIL during each call, so a trainer's device step overlaps the wire.

``DenseTableHandle`` copies pulled values into its parameters in place
(``copy_`` under ``no_grad``), so a captured step keeps its ``data_ptr()``s;
the JAX handle rebinds each parameter's value.
"""
from __future__ import annotations

import ctypes
import os
import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import _F, _I64, _INT, _OPT_IDS, _P, _STR, _U64, CSRC, bind

__all__ = [
    "PsServer",
    "PsClient",
    "DistributedSparseTable",
    "GeoDistributedSparseTable",
    "DenseTableHandle",
    "Communicator",
    "SparsePipeline",
]

_DEPENDS = [os.path.join(CSRC, h) for h in ("ps_net.h", "ps_sparse_table.h", "ps_dense_table.h")]
_U32 = ctypes.c_uint32

_SERVER_SIGNATURES = [
    ("ps_server_create", _P, [_INT] * 4),
    ("ps_server_port", _INT, [_P]),
    ("ps_server_wait", None, [_P]),
    ("ps_server_stop", None, [_P]),
    ("ps_server_destroy", None, [_P]),
]
_CLIENT_SIGNATURES = [
    ("ps_client_create", _P, [_STR]),
    ("ps_client_destroy", None, [_P]),
    ("ps_client_n_servers", _INT, [_P]),
    ("ps_client_ping", _INT, [_P]),
    ("ps_client_create_sparse", _INT, [_P, _U32, _INT, _INT, _INT, _F, _F, _U64]),
    ("ps_client_create_dense", _INT, [_P, _U32, _I64, _INT, _F, _P]),
    ("ps_client_pull_sparse", _INT, [_P, _U32, _P, _I64, _INT, _P, _INT]),
    ("ps_client_push_sparse", _INT, [_P, _U32, _P, _I64, _INT, _P, _INT]),
    ("ps_client_pull_dense", _INT, [_P, _U32, _P, _I64]),
    ("ps_client_push_dense", _INT, [_P, _U32, _P, _I64]),
    ("ps_client_set_dense", _INT, [_P, _U32, _P, _I64]),
    ("ps_client_push_pull_dense", _INT, [_P, _U32, _P, _P, _I64]),
    ("ps_client_barrier", _INT, [_P, _INT]),
    ("ps_client_save", _INT, [_P, _STR]),
    ("ps_client_load", _INT, [_P, _STR]),
    ("ps_client_stat", _I64, [_P, _U32]),
    ("ps_client_set_lr", _INT, [_P, _U32, _F]),
    ("ps_client_stop_servers", _INT, [_P]),
    ("ps_client_set_ctr", _INT, [_P, _U32] + [_F] * 5),
    ("ps_client_push_ctr", _INT, [_P, _U32, _P, _I64, _INT, _P, _P, _P]),
    ("ps_client_shrink", _I64, [_P, _U32]),
    ("ps_client_ctr_stats", _INT, [_P, _U32, _I64, _P]),
    ("ps_client_kv_put", _INT, [_P, _STR, _STR, _I64]),
    ("ps_client_kv_lease", _INT, [_P, _STR, _STR, _I64, _I64]),
    ("ps_client_kv_get", _I64, [_P, _STR, _P, _I64]),
    ("ps_client_kv_del", _INT, [_P, _STR]),
    ("ps_client_kv_alive", _I64, [_P, _STR, _P, _I64]),
]

_libs: Dict[str, ctypes.CDLL] = {}


def _load(name: str, signatures) -> ctypes.CDLL:
    """``csrc/<name>.cc`` built at first use and bound; a failed build raises."""
    lib = _libs.get(name)
    if lib is None:
        from ...utils import cpp_extension

        lib = cpp_extension.load(name, [os.path.join(CSRC, f"{name}.cc")], depends=_DEPENDS)
        lib = _libs[name] = bind(lib, signatures)
    return lib


def _load_server_lib():
    return _load("ps_server", _SERVER_SIGNATURES)


def _load_client_lib():
    return _load("ps_client", _CLIENT_SIGNATURES)


def _host(x) -> np.ndarray:
    """A parameter, gradient, Tensor or array as a host f32 array."""
    if hasattr(x, "_value"):  # a Paddle Tensor
        x = x._value
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


_DENSE_OPT_IDS = {"sgd": 0, "adam": 1, "sum": 2}


class PsServer:
    """One parameter-server process (reference: BrpcPsServer)."""

    def __init__(self, port: int = 0, server_id: int = 0, n_servers: int = 1,
                 n_trainers: int = 1):
        self._lib = _load_server_lib()
        self._h = self._lib.ps_server_create(
            int(port), int(server_id), int(n_servers), int(n_trainers)
        )
        if not self._h:
            raise RuntimeError(f"PsServer failed to bind port {port}")
        self.server_id = server_id

    @property
    def port(self) -> int:
        return self._lib.ps_server_port(self._h)

    def wait(self):
        """Block until a STOP arrives (fleet.run_server loop)."""
        self._lib.ps_server_wait(self._h)

    def stop(self):
        if self._h:
            self._lib.ps_server_stop(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ps_server_destroy(self._h)
                self._h = None
        except Exception:
            pass


class PsClient:
    """Trainer-side stub for the whole server fleet (reference: BrpcPsClient)."""

    def __init__(self, endpoints: Sequence[str], trainer_id: int = 0):
        self._lib = _load_client_lib()
        self.endpoints = list(endpoints)
        self.trainer_id = trainer_id
        self._h = self._lib.ps_client_create(",".join(self.endpoints).encode())
        if not self._h:
            raise RuntimeError(f"PsClient: bad endpoints {endpoints}")
        self._dense_meta: Dict[int, int] = {}  # table_id -> length

    # -- lifecycle -----------------------------------------------------------
    def ping(self):
        if self._lib.ps_client_ping(self._h) != 0:
            raise ConnectionError(f"ping failed for {self.endpoints}")

    # -- KV / lease (the etcd replacement: elastic membership + launch
    # master endpoint discovery; all keys live on server 0) -------------------
    def kv_put(self, key: str, value: str):
        v = value.encode()
        if self._lib.ps_client_kv_put(self._h, key.encode(), v,
                                      len(v)) != 0:
            raise ConnectionError(f"kv_put({key}) failed")

    def kv_lease(self, key: str, value: str, ttl_s: float):
        """Register key with a TTL; re-lease to refresh (etcd lease)."""
        v = value.encode()
        if self._lib.ps_client_kv_lease(
                self._h, key.encode(), v, len(v),
                int(ttl_s * 1000)) != 0:
            raise ConnectionError(f"kv_lease({key}) failed")

    def kv_get(self, key: str, cap: int = 1 << 16):
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.ps_client_kv_get(self._h, key.encode(), buf, cap)
        if n == -1:
            return None  # absent or lease expired
        if n < 0:
            raise ConnectionError(f"kv_get({key}) failed ({n})")
        return buf.raw[:n].decode()

    def kv_del(self, key: str):
        if self._lib.ps_client_kv_del(self._h, key.encode()) != 0:
            raise ConnectionError(f"kv_del({key}) failed")

    def kv_alive(self, prefix: str, cap: int = 1 << 20):
        """{key: value} for every unexpired key under prefix."""
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.ps_client_kv_alive(self._h, prefix.encode(), buf, cap)
        if n < 0:
            raise ConnectionError(f"kv_alive({prefix}) failed ({n})")
        parts = buf.raw[:n].split(b"\0")
        out = {}
        for i in range(0, len(parts) - 1, 2):
            out[parts[i].decode()] = parts[i + 1].decode()
        return out

    def stop_servers(self):
        self._lib.ps_client_stop_servers(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ps_client_destroy(self._h)
                self._h = None
        except Exception:
            pass

    # -- tables --------------------------------------------------------------
    def create_sparse_table(self, table_id: int, emb_dim: int,
                            shard_num: int = 16, optimizer: str = "adagrad",
                            learning_rate: float = 0.05,
                            init_range: float = 0.01, seed: int = 0):
        if self._lib.ps_client_create_sparse(
            self._h, table_id, emb_dim, shard_num, _OPT_IDS[optimizer],
            ctypes.c_float(learning_rate), ctypes.c_float(init_range),
            ctypes.c_uint64(seed),
        ) != 0:
            raise RuntimeError("create_sparse_table failed")

    def create_dense_table(self, table_id: int, length: int,
                           optimizer: str = "sgd", learning_rate: float = 0.01,
                           init: Optional[np.ndarray] = None):
        buf = None
        if init is not None:
            buf = np.ascontiguousarray(init, np.float32).reshape(-1)
            if buf.size != length:
                raise ValueError("init length mismatch")
        if self._lib.ps_client_create_dense(
            self._h, table_id, length, _DENSE_OPT_IDS[optimizer],
            ctypes.c_float(learning_rate),
            buf.ctypes.data if buf is not None else None,
        ) != 0:
            raise RuntimeError("create_dense_table failed")
        self._dense_meta[table_id] = length

    # -- sparse verbs --------------------------------------------------------
    def pull_sparse(self, table_id: int, keys: np.ndarray, emb_dim: int,
                    create: bool = True) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        out = np.empty((keys.size, emb_dim), np.float32)
        if self._lib.ps_client_pull_sparse(
            self._h, table_id, keys.ctypes.data, keys.size, emb_dim,
            out.ctypes.data, 1 if create else 0,
        ) != 0:
            raise ConnectionError("pull_sparse failed")
        return out

    def push_sparse(self, table_id: int, keys: np.ndarray,
                    grads: np.ndarray, raw: bool = False):
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, np.float32)
        emb_dim = grads.size // max(keys.size, 1)
        if self._lib.ps_client_push_sparse(
            self._h, table_id, keys.ctypes.data, keys.size, emb_dim,
            grads.ctypes.data, 1 if raw else 0,
        ) != 0:
            raise ConnectionError("push_sparse failed")

    # -- dense verbs ---------------------------------------------------------
    def pull_dense(self, table_id: int, length: Optional[int] = None) -> np.ndarray:
        length = length or self._dense_meta[table_id]
        out = np.empty(length, np.float32)
        if self._lib.ps_client_pull_dense(
            self._h, table_id, out.ctypes.data, length
        ) != 0:
            raise ConnectionError("pull_dense failed")
        return out

    def push_dense(self, table_id: int, grads: np.ndarray):
        grads = np.ascontiguousarray(grads, np.float32).reshape(-1)
        if self._lib.ps_client_push_dense(
            self._h, table_id, grads.ctypes.data, grads.size
        ) != 0:
            raise ConnectionError("push_dense failed")

    def set_dense(self, table_id: int, values: np.ndarray):
        values = np.ascontiguousarray(values, np.float32).reshape(-1)
        if self._lib.ps_client_set_dense(
            self._h, table_id, values.ctypes.data, values.size
        ) != 0:
            raise ConnectionError("set_dense failed")

    def push_pull_dense(self, table_id: int, grads: np.ndarray) -> np.ndarray:
        """Fused round trip: apply grads server-side, return the updated
        values — half the wire latency of push_dense + pull_dense."""
        grads = np.ascontiguousarray(grads, np.float32).reshape(-1)
        out = np.empty(grads.size, np.float32)
        if self._lib.ps_client_push_pull_dense(
            self._h, table_id, grads.ctypes.data, out.ctypes.data, grads.size
        ) != 0:
            raise ConnectionError("push_pull_dense failed")
        return out

    # -- coordination --------------------------------------------------------
    def barrier(self):
        if self._lib.ps_client_barrier(self._h, self.trainer_id) != 0:
            raise ConnectionError("barrier failed")

    def save(self, dirname: str):
        os.makedirs(dirname, exist_ok=True)
        if self._lib.ps_client_save(self._h, dirname.encode()) != 0:
            raise IOError(f"distributed save to {dirname} failed")

    def load(self, dirname: str):
        if self._lib.ps_client_load(self._h, dirname.encode()) != 0:
            raise IOError(f"distributed load from {dirname} failed")

    def stat(self, table_id: int = 0) -> int:
        """Row count of one sparse table, or of the whole fleet (id 0)."""
        n = self._lib.ps_client_stat(self._h, table_id)
        if n < 0:
            raise ConnectionError("stat failed")
        return int(n)

    def set_lr(self, lr: float, table_id: int = 0):
        """Set the optimizer lr of one table, or of every table (id 0)."""
        self._lib.ps_client_set_lr(self._h, table_id, ctypes.c_float(lr))

    # -- CTR accessor (reference: ctr_accessor.h over the wire) --------------
    def set_ctr(self, table_id: int, ctr) -> None:
        """Enable the CTR accessor on a fleet table (CtrAccessorConfig)."""
        if self._lib.ps_client_set_ctr(
            self._h, table_id,
            *[ctypes.c_float(v) for v in ctr.as_floats()],
        ) != 0:
            raise ConnectionError("set_ctr failed")

    def push_ctr(self, table_id: int, keys: np.ndarray, shows: np.ndarray,
                 clicks: np.ndarray, grads: np.ndarray):
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        shows = np.ascontiguousarray(shows, np.float32).reshape(-1)
        clicks = np.ascontiguousarray(clicks, np.float32).reshape(-1)
        grads = np.ascontiguousarray(grads, np.float32)
        emb_dim = grads.size // max(keys.size, 1)
        if self._lib.ps_client_push_ctr(
            self._h, table_id, keys.ctypes.data, keys.size, emb_dim,
            shows.ctypes.data, clicks.ctypes.data, grads.ctypes.data,
        ) != 0:
            raise ConnectionError("push_ctr failed")

    def shrink(self, table_id: int) -> int:
        """Fleet-wide decay+eviction pass; returns total evicted."""
        n = self._lib.ps_client_shrink(self._h, table_id)
        if n < 0:
            raise ConnectionError("shrink failed")
        return int(n)

    def ctr_stats(self, table_id: int, key: int):
        out = np.zeros(4, np.float32)
        if self._lib.ps_client_ctr_stats(
            self._h, table_id, int(key), out.ctypes.data
        ) != 0:
            return None
        return tuple(float(v) for v in out)


class DistributedSparseTable:
    """MemorySparseTable-compatible facade over the server fleet, so
    SparseEmbedding(table=...) works unchanged across hosts (reference:
    distributed_lookup_table on the worker side)."""

    def __init__(self, client: PsClient, table_id: int, emb_dim: int,
                 shard_num: int = 16, optimizer: str = "adagrad",
                 learning_rate: float = 0.05, init_range: float = 0.01,
                 seed: int = 0, create: bool = True, ctr=None):
        self.client = client
        self.table_id = table_id
        self.emb_dim = emb_dim
        self.ctr = ctr
        if create:
            client.create_sparse_table(
                table_id, emb_dim, shard_num, optimizer, learning_rate,
                init_range, seed,
            )
        if ctr is not None:
            client.set_ctr(table_id, ctr)

    def pull(self, keys: np.ndarray, create: bool = True) -> np.ndarray:
        return self.client.pull_sparse(self.table_id, keys, self.emb_dim, create)

    def push_ctr(self, keys, shows, clicks, grads):
        self.client.push_ctr(self.table_id, keys, shows, clicks, grads)

    def shrink(self) -> int:
        return self.client.shrink(self.table_id)

    def ctr_stats(self, key: int):
        return self.client.ctr_stats(self.table_id, key)

    def push(self, keys: np.ndarray, grads: np.ndarray):
        self.client.push_sparse(self.table_id, keys, grads)

    def set_lr(self, lr: float):
        self.client.set_lr(lr, table_id=self.table_id)

    def __len__(self):
        return self.client.stat(table_id=self.table_id)

    def save(self, dirname: str):
        self.client.save(dirname)

    def load(self, dirname: str):
        self.client.load(dirname)


class GeoDistributedSparseTable(DistributedSparseTable):
    """Geo-async sparse table (reference: GeoSparseTable +
    communicator GeoCommunicator): the trainer reads AND optimizes a local
    replica; every `geo_steps` pushes the accumulated local deltas
    (raw-added server-side) and refreshes touched rows from the server.
    Deterministic per-key init makes replicas agree on never-synced rows.
    """

    def __init__(self, client: PsClient, table_id: int, emb_dim: int,
                 shard_num: int = 16, optimizer: str = "adagrad",
                 learning_rate: float = 0.05, init_range: float = 0.01,
                 seed: int = 0, geo_steps: int = 10, create: bool = True):
        super().__init__(client, table_id, emb_dim, shard_num, optimizer,
                         learning_rate, init_range, seed, create)
        from . import MemorySparseTable

        self.local = MemorySparseTable(
            emb_dim, shard_num=shard_num, optimizer=optimizer,
            learning_rate=learning_rate, init_range=init_range, seed=seed,
        )
        self.geo_steps = geo_steps
        self._step = 0
        # base snapshot of keys touched SINCE THE LAST SYNC only — entries
        # are evicted after each sync, so host memory and per-sync cost are
        # bounded by the inter-sync working set, not the whole history
        self._base: Dict[int, np.ndarray] = {}

    def pull(self, keys: np.ndarray, create: bool = True) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        rows = self.local.pull(keys, create=create)
        if create:
            for k, row in zip(keys.tolist(), rows):
                if k not in self._base:
                    self._base[k] = row.copy()
        return rows

    def push(self, keys: np.ndarray, grads: np.ndarray):
        # record bases for keys pushed without a prior pull this interval
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        fresh = [k for k in keys.tolist() if k not in self._base]
        if fresh:
            fk = np.asarray(fresh, np.int64)
            for k, row in zip(fresh, self.local.pull(fk, create=True)):
                self._base[k] = row.copy()
        self.local.push(keys, grads)
        self._step += 1
        if self._step % self.geo_steps == 0:
            self.sync()

    def sync(self):
        """Push local deltas (raw add), adopt the merged server rows, and
        evict the synced bases (next touch re-snapshots)."""
        if not self._base:
            return
        ks = np.fromiter(self._base.keys(), np.int64, len(self._base))
        cur = self.local.pull(ks, create=True)
        base = np.stack([self._base[int(k)] for k in ks])
        delta = cur - base
        touched = np.abs(delta).sum(axis=1) > 0
        if touched.any():
            self.client.push_sparse(
                self.table_id, ks[touched], delta[touched], raw=True
            )
        merged = super(GeoDistributedSparseTable, self).pull(ks, create=True)
        # overwrite the local replica with the authoritative merged rows
        self.local.push_raw(ks, merged - cur)
        self._base.clear()

    def refresh(self, keys: np.ndarray):
        """Adopt the authoritative merged server rows for `keys` without
        pushing anything — the reference geo trainers' periodic pull of
        rows they read but did not recently update."""
        ks = np.ascontiguousarray(keys, np.int64).reshape(-1)
        cur = self.local.pull(ks, create=True)
        merged = super(GeoDistributedSparseTable, self).pull(ks, create=True)
        self.local.push_raw(ks, merged - cur)
        for k in ks.tolist():
            self._base.pop(k, None)  # re-snapshot on next touch


class DenseTableHandle:
    """Server-resident dense parameters for PS-mode training (reference:
    MemoryDenseTable and the pull_dense / push_dense_grad worker loop).

    Registers a list of parameters; ``init()`` seeds the servers from
    trainer 0; each step ``push_pull(grads)`` sends the flat gradient and
    copies the updated values back into the parameters in place: the server
    is the optimizer and trainers stay stateless."""

    def __init__(self, client: PsClient, table_id: int, params: List,
                 optimizer: str = "sgd", learning_rate: float = 0.01):
        self.client = client
        self.table_id = table_id
        self.params = list(params)
        self.shapes = [tuple(p.shape) for p in self.params]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.total = sum(self.sizes)
        self.optimizer = optimizer
        self.learning_rate = learning_rate

    def _flat(self, arrays) -> np.ndarray:
        return np.concatenate(
            [_host(a).reshape(-1) for a in arrays]
        ) if arrays else np.zeros(0, np.float32)

    def init(self, is_first_trainer: bool):
        vals = self._flat(self.params)
        self.client.create_dense_table(
            self.table_id, self.total, self.optimizer, self.learning_rate,
            init=vals if is_first_trainer else None,
        )
        if is_first_trainer:
            # idempotent overwrite in case the table pre-existed (restart)
            self.client.set_dense(self.table_id, vals)

    def pull_into_params(self):
        flat = self.client.pull_dense(self.table_id, self.total)
        self._scatter(flat)

    def _scatter(self, flat: np.ndarray):
        """Copy ``flat``'s chunks into the parameters in place."""
        off = 0
        with torch.no_grad():
            for p, size, shape in zip(self.params, self.sizes, self.shapes):
                dst = p._value if hasattr(p, "_value") else p
                chunk = torch.from_numpy(flat[off:off + size].reshape(shape))
                dst.copy_(chunk)
                off += size

    def push(self, grads: Optional[List] = None):
        """Push this trainer's grads (server applies the optimizer). In
        sync-SGD, barrier between push and pull_into_params so every
        trainer's contribution lands before anyone reads."""
        if grads is None:
            grads = [p.grad for p in self.params]
        self.client.push_dense(self.table_id, self._flat(grads))

    def push_pull(self, grads: Optional[List] = None):
        """Push and pull in one round trip per server chunk: the fully
        asynchronous single-trainer path; multi-trainer sync loops should
        push, barrier, then pull so every contribution lands first."""
        if grads is None:
            grads = [p.grad for p in self.params]
        out = self.client.push_pull_dense(self.table_id, self._flat(grads))
        self._scatter(out)


class Communicator:
    """Sparse-push communicator with sync / async modes (reference:
    ps/service/communicator/communicator.h AsyncCommunicator). In async
    mode pushes enqueue to a background flusher so the trainer never
    blocks on the wire; flush() drains (the reference's barrier point)."""

    def __init__(self, table: DistributedSparseTable, mode: str = "sync",
                 max_queue: int = 64):
        if mode not in ("sync", "async"):
            raise ValueError("mode must be sync|async")
        self.table = table
        self.mode = mode
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._err: Optional[BaseException] = None
        self._thread = None
        if mode == "async":
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                try:
                    self.table.push(*item)
                except BaseException as e:  # surfaced on next push/flush
                    self._err = e
            finally:
                self._q.task_done()

    def push(self, keys: np.ndarray, grads: np.ndarray):
        if self._err:
            raise self._err
        if self.mode == "sync":
            self.table.push(keys, grads)
        else:
            self._q.put((np.array(keys, np.int64), np.array(grads, np.float32)))

    def flush(self):
        if self.mode == "async":
            self._q.join()
        if self._err:
            raise self._err

    def stop(self):
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None


class SparsePipeline:
    """Overlap host PS traffic with device compute — the training-loop
    half of the reference's async Communicator (communicator.h: pulls for
    the NEXT minibatch and queued pushes run while the accelerator
    executes the current step; the PSGPU trainer pipelines the same way,
    framework/trainer.h:253).

    Semantics: async-PS — a prefetched pull may miss pushes still in
    flight (staleness ≤ `queue` steps), exactly the reference's async
    mode. `flush()` drains pushes (the barrier point, e.g. before eval
    or checkpoint).

    Works over any table with pull(keys)/push(keys, grads) — the
    in-process MemorySparseTable (SSD-backed or not) or the wire-backed
    DistributedSparseTable."""

    def __init__(self, table, max_queue: int = 8):
        from concurrent.futures import ThreadPoolExecutor

        self.table = table
        # one worker per direction: pulls must not queue behind pushes
        self._pull_pool = ThreadPoolExecutor(1)
        self._push = Communicator(table, mode="async", max_queue=max_queue)

    def prefetch(self, keys: np.ndarray):
        """Start pulling rows for a FUTURE step; returns a future whose
        .result() is the [n, dim] row block."""
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        return self._pull_pool.submit(self.table.pull, keys)

    def push_async(self, keys: np.ndarray, grads: np.ndarray):
        self._push.push(keys, grads)

    def flush(self):
        self._push.flush()

    def stop(self):
        self._push.stop()
        self._pull_pool.shutdown(wait=True)
