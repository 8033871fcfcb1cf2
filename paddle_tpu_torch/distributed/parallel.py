"""The parallel environment, ``DataParallel`` and ``spawn``
(``paddle_tpu/distributed/parallel.py``).

One process per rank: ``init_parallel_env`` reads the launcher's env
contract, binds the rank's card and makes the default process group. The
env contract is Paddle's: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_MASTER`` (``host:port`` for a TCP store, or a ``file://`` path),
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``FLAGS_selected_gpus`` (the rank's card) and ``PADDLE_DISTRI_BACKEND``
(the default group's backend: ``nccl`` or ``gloo``; NCCL when the current
device is a card, gloo when it is the CPU). Ranks that share one card must
name gloo: NCCL refuses two ranks on one device, and ``init_parallel_env``
raises saying so before NCCL would.
"""
from __future__ import annotations

import contextlib
import os
import socket
import tempfile
from typing import Optional

import torch

from ..nn.layer_base import Layer

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "DataParallel", "spawn"]

_state = {"store": None}


class ParallelEnv:
    """reference: parallel.py ParallelEnv — the launch's env contract."""

    def __init__(self):
        self._rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._device_id = int(os.getenv("FLAGS_selected_gpus", "0").split(",")[0])
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    @property
    def current_endpoint(self):
        return self._current_endpoint

    local_rank = rank
    nranks = world_size
    dev_id = device_id


def _dist():
    import torch.distributed as dist

    return dist


def get_rank(group=None) -> int:
    """This process's global rank (its index in ``group`` when given)."""
    dist = _dist()
    rank = dist.get_rank() if dist.is_initialized() else int(os.getenv("PADDLE_TRAINER_ID", "0"))
    return rank if group is None else group.get_group_rank(rank)


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    dist = _dist()
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.getenv("PADDLE_TRAINERS_NUM", "1"))


def default_backend() -> str:
    """``PADDLE_DISTRI_BACKEND``, else NCCL on the card and gloo on the CPU."""
    from ..core.place import device_of

    named = os.getenv("PADDLE_DISTRI_BACKEND", "").strip().lower()
    if named:
        if named not in ("nccl", "gloo"):
            raise ValueError(f"PADDLE_DISTRI_BACKEND={named!r}: the port has nccl and gloo")
        return named
    return "nccl" if device_of(None).type == "cuda" else "gloo"


def _make_store(master: str, rank: int, world: int):
    """The rendezvous store: ``file://PATH`` or ``host:port`` (rank 0 serves
    the TCP store)."""
    dist = _dist()
    if master.startswith("file://"):
        return dist.FileStore(master[len("file://"):], world)
    host, port = master.rsplit(":", 1)
    return dist.TCPStore(host, int(port), world, rank == 0)


def _card_identity(index: int) -> str:
    props = torch.cuda.get_device_properties(index)
    return f"{socket.gethostname()}:{getattr(props, 'uuid', index)}"


def _nccl_shares_a_card(store=None, world=None) -> Optional[str]:
    """Why NCCL cannot run over the world, or None: two ranks on one card
    (each rank wrote its card's identity to the store)."""
    dist = _dist()
    store = store or _state["store"]
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if store is None or world == 1:
        return None
    seen = {}
    for r in range(world):
        seen.setdefault(store.get(f"paddle/card/{r}").decode(), []).append(r)
    shared = [ranks for ranks in seen.values() if len(ranks) > 1]
    if not shared:
        return None
    return (f"NCCL cannot run ranks {shared[0]} on one card (NCCL refuses two ranks on "
            "one device: 'Duplicate GPU detected'); give each rank a card of its own, or "
            "name gloo for ranks that share a card (PADDLE_DISTRI_BACKEND=gloo, or "
            "new_group(backend='gloo'))")


def init_parallel_env():
    """reference: parallel.py:91 — the env contract read, the rank's card
    bound (``FLAGS_selected_gpus``) unless the current device is the CPU,
    the default process group made over the store at ``PADDLE_MASTER``, and
    a data-parallel topology over the world installed. Returns the
    ``ParallelEnv``."""
    from ..core import place
    from ..parallel.topology import init_mesh
    from . import collective as C

    env = ParallelEnv()
    dist = _dist()
    backend = default_backend()
    on_card = place.device_of(None).type == "cuda"
    if on_card:
        place.set_device(f"gpu:{env.device_id}")
        torch.cuda.set_device(env.device_id)
    if not dist.is_initialized():
        world, rank = env.world_size, env.rank
        master = os.getenv("PADDLE_MASTER", "")
        if master:
            store = _make_store(master, rank, world)
        elif world == 1:
            store = dist.HashStore()
        else:
            raise RuntimeError(
                f"PADDLE_TRAINERS_NUM={world} but PADDLE_MASTER is not set: start the ranks "
                "with python -m paddle_tpu_torch.distributed.launch, or paddle.distributed.spawn"
            )
        _state["store"] = store
        ident = _card_identity(torch.cuda.current_device()) if on_card \
            else f"{socket.gethostname()}:cpu:{rank}"
        store.set(f"paddle/card/{rank}", ident)
        if backend == "nccl":
            if not on_card:
                raise RuntimeError("the NCCL backend needs the card: the current device is "
                                   "the CPU")
            reason = _nccl_shares_a_card(store, world)
            if reason:
                raise RuntimeError(reason)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    C._default_group = None
    C._ensure_default()
    init_mesh(dp=get_world_size())
    return ParallelEnv()


class DataParallel(Layer):
    """reference: fluid/dygraph/parallel.py:413. The wrapped layer's
    gradients are averaged over ``group`` (the world when None) at the end
    of every backward that runs outside ``no_sync()``: one flat all-reduce
    per dtype of every trainable parameter's gradient (zeros where a
    parameter got none, so every rank reduces the same buffer)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False, group=None):
        super().__init__()
        from . import collective as C

        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._group = group or C._ensure_default()
        self._sync = True
        self._queued = False
        self._params = [p for p in layers.parameters() if p.requires_grad]
        if self._group.nranks > 1:
            for p in self._params:
                p.register_hook(self._on_grad)

    def _on_grad(self, grad):
        if self._sync and not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(self._reduce)
        return grad

    @torch.no_grad()
    def _reduce(self):
        from . import collective as C

        self._queued = False
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        C.all_reduce_flat([p.grad for p in self._params], self._group, average=True)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    set_dict = set_state_dict
    load_dict = set_state_dict

    def scale_loss(self, loss):
        """The loss as it is: the gradients are averaged, not summed."""
        return loss

    @property
    def parameters_(self):
        return self._layers.parameters()

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside the block accumulate without averaging; the next
        backward outside it averages the accumulated gradients."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev


# ---------------------------------------------------------------------------
# spawn
# ---------------------------------------------------------------------------
class _SpawnContext:
    def __init__(self, processes, directory):
        self.processes = processes
        self._dir = directory

    def join(self, timeout=None):
        """Wait for every process; raise if one failed."""
        bad = []
        for rank, p in enumerate(self.processes):
            p.join(timeout)
            if p.exitcode not in (0, None):
                bad.append((rank, p.exitcode))
        if bad:
            for p in self.processes:
                if p.is_alive():
                    p.terminate()
            raise RuntimeError(f"spawn: ranks exited with codes {bad}")
        return True


def _spawn_entry(rank, env, func, args):
    os.environ.update(env)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_CURRENT_ENDPOINT"] = env["PADDLE_TRAINER_ENDPOINTS"].split(",")[rank]
    if "PADDLE_SPAWN_GPUS" in env:
        os.environ["FLAGS_selected_gpus"] = env["PADDLE_SPAWN_GPUS"].split(",")[rank]
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """reference: distributed/spawn.py — ``nprocs`` fresh processes (the
    visible cards when -1, one without a card), each with the env contract
    of its rank, each calling ``func(*args)``; ``func`` calls
    ``init_parallel_env``. The rendezvous is a file store in a fresh
    directory. Options: ``gpus`` ("0,0,1,1": each rank's card), ``backend``
    (``PADDLE_DISTRI_BACKEND``). Processes start by the ``spawn`` method, never
    by forking this one."""
    import multiprocessing as mp

    if nprocs == -1:
        nprocs = max(1, torch.cuda.device_count())
    directory = tempfile.mkdtemp(prefix="paddle_spawn_")
    env = {
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_MASTER": "file://" + os.path.join(directory, "store"),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(f"127.0.0.1:{6170 + i}" for i in range(nprocs)),
    }
    gpus = options.get("gpus") or options.get("selected_devices")
    if gpus:
        env["PADDLE_SPAWN_GPUS"] = ",".join(str(g) for g in str(gpus).split(","))
    else:
        env["PADDLE_SPAWN_GPUS"] = ",".join(str(i) for i in range(nprocs))
    if options.get("backend"):
        env["PADDLE_DISTRI_BACKEND"] = str(options["backend"])
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_spawn_entry, args=(rank, env, func, tuple(args)), daemon=daemon)
        p.start()
        procs.append(p)
    context = _SpawnContext(procs, directory)
    if join:
        context.join()
    return context
