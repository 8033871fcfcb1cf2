"""Decode-mode capture for the serving engine: the serve part of
``paddle_tpu/core/lazy.py`` (``serve_program``, ``reset_serve_programs``,
``serve_capture_state``).

A serving engine knows its step boundaries exactly, so each prefill and
decode step is a pure step function keyed by its bucket signature,
captured ONCE and replayed from an LRU cache bounded by
FLAGS_serving_capture_cache_size. On the card a program is one
``torch.cuda.CUDAGraph`` over the KV pool tensors and static input
buffers; the JAX package's is one donated XLA program. The engine runs
each step through two rungs of a program and an eager floor:

  captured  ``run(args, donate=True)``: the graph, which writes the pool
            tensors it was captured over in place (the analogue of
            donation); on a CPU tensor the function runs eagerly, in place;
  retained  ``run(args, donate=False)``: the function on copies of the pool
            tensors, copied back on success, so a failure leaves the pool
            intact (the JAX rung with the inputs retained);
  eager     the engine calls the function itself.

A step function takes ``(k_pools, v_pools, *feeds)``: two tuples of pool
tensors, then int64 feed tensors on the host (block tables, lengths,
token ids), and returns ``(k_pools, v_pools, row, nxt)``. The feeds are
packed into one pinned host buffer and reach the device in one copy; the
graph reads them from its static device buffer, whose values the host
replaces before each replay. ``row`` and ``nxt`` of a graph are its static
outputs: the next replay overwrites them, so the caller reads them first.

The first call of a key counts one ``serve_capture_builds``, each later
call one ``serve_capture_replays`` (``profiler.dispatch_counters()``).

Not ported: the equivalence certificate between the rungs
(``_certify_rungs``, FLAGS_check_programs=2) and the attribution registry
(ROADMAP queue 1 item 12), and the rest of the JAX module: lazy dispatch
and whole-step capture of training (item 9).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Tuple

import torch

from . import flags

__all__ = ["reset_serve_programs", "serve_capture_state", "serve_program", "stage_feeds"]

_serve_cache: "OrderedDict[Tuple, _ServeProgram]" = OrderedDict()
# one memory pool for every serve graph on a device: the graphs run one
# after another on one stream and nothing of one graph is live when another
# replays (their outputs are read before the next step), so they can share
# it instead of each keeping a private pool. Each entry is [pool handle,
# live graphs]: once its last graph is reset, the caching allocator refuses
# a new capture into that pool until its memory is returned, so the next
# capture starts a new pool
_graph_pools: Dict[torch.device, list] = {}


def stage_feeds(feeds, device):
    """The host feed tensors on ``device`` in one copy (views of one buffer)."""
    if device.type != "cuda":
        return tuple(feeds)
    flat = torch.cat([f.reshape(-1) for f in feeds]).to(device)
    return _views(flat, feeds)


def _views(flat, feeds):
    out, at = [], 0
    for f in feeds:
        out.append(flat[at:at + f.numel()].view(f.shape))
        at += f.numel()
    return tuple(out)


class _ServeProgram:
    """One captured serving program (a prefill or decode bucket signature)."""

    __slots__ = ("key", "fn", "_built_donate", "_built_plain", "_graph", "_host", "_dev",
                 "_inputs", "_out")

    def __init__(self, key, fn):
        self.key = key
        self.fn = fn
        self._built_donate = False
        self._built_plain = False
        self._graph = None
        self._host = self._dev = self._inputs = self._out = None

    def built(self, donate: bool = True) -> bool:
        return self._built_donate if donate else self._built_plain

    def run(self, args, donate: bool = True):
        """Run the program (building it on first use): ``donate=True`` is
        the captured rung, ``donate=False`` the retained one."""
        from .. import profiler

        k_pools, v_pools, feeds = args[0], args[1], args[2:]
        fresh = not self.built(donate)
        if donate:
            out = self._captured(k_pools, v_pools, feeds)
            self._built_donate = True
        else:
            out = self._retained(k_pools, v_pools, feeds)
            self._built_plain = True
        profiler.count("serve_capture_builds" if fresh else "serve_capture_replays")
        return out

    def _captured(self, k_pools, v_pools, feeds):
        device = k_pools[0].device
        if device.type != "cuda":
            return self.fn(k_pools, v_pools, *feeds)
        if self._graph is None:
            self._capture(k_pools, v_pools, feeds, device)
        else:
            self._load(feeds)
        self._graph.replay()
        return (k_pools, v_pools) + self._out

    def _load(self, feeds):
        # the pinned buffer is free to overwrite: the caller read the last
        # step's output, which waited for that step's copy
        torch.cat([f.reshape(-1) for f in feeds], out=self._host)
        self._dev.copy_(self._host, non_blocking=True)

    def _capture(self, k_pools, v_pools, feeds, device):
        n = sum(f.numel() for f in feeds)
        self._host = torch.empty(n, dtype=torch.int64, pin_memory=True)
        self._dev = torch.empty(n, dtype=torch.int64, device=device)
        self._inputs = _views(self._dev, feeds)
        self._load(feeds)
        # warm-up on a side stream, as torch.cuda.graphs asks. It writes the
        # chunk's K/V at lens..lens+s-1, the same values at the same places
        # the replay below writes, so running the step twice is harmless
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.fn(k_pools, v_pools, *self._inputs)
        current.wait_stream(side)
        pool = _graph_pools.get(device)
        if pool is None:
            pool = _graph_pools[device] = [torch.cuda.graph_pool_handle(), 0]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool[0]):
                _, _, row, nxt = self.fn(k_pools, v_pools, *self._inputs)
        except BaseException:
            if not pool[1]:
                del _graph_pools[device]
            raise
        self._graph, self._out = graph, (row, nxt)
        pool[1] += 1

    def _retained(self, k_pools, v_pools, feeds):
        device = k_pools[0].device
        k_copy = tuple(t.clone() for t in k_pools)
        v_copy = tuple(t.clone() for t in v_pools)
        _, _, row, nxt = self.fn(k_copy, v_copy, *stage_feeds(feeds, device))
        for dst, src in zip(k_pools + v_pools, k_copy + v_copy):
            dst.copy_(src)
        return k_pools, v_pools, row, nxt

    def release(self):
        """Drop the graph and its buffers (eviction, engine close)."""
        if self._graph is not None:
            self._graph.reset()
            pool = _graph_pools[self._dev.device]
            pool[1] -= 1
            if not pool[1]:
                del _graph_pools[self._dev.device]
        self._graph = self._host = self._dev = self._inputs = self._out = None


def serve_program(key: Tuple, fn: Callable) -> _ServeProgram:
    """The decode-mode capture cache: one ``_ServeProgram`` per bucket
    signature, LRU-bounded by FLAGS_serving_capture_cache_size. A re-used
    key returns the cached handle with its graph intact, so a steady-state
    decode loop replays without re-capturing — verified by the
    serve_capture_builds counter staying flat."""
    from .. import profiler

    prog = _serve_cache.get(key)
    if prog is not None:
        _serve_cache.move_to_end(key)
        return prog
    prog = _ServeProgram(key, fn)
    _serve_cache[key] = prog
    cap = int(flags.flag("serving_capture_cache_size"))
    while cap > 0 and len(_serve_cache) > cap:
        _, old = _serve_cache.popitem(last=False)
        old.release()
        profiler.count("serve_capture_evictions")
    return prog


def reset_serve_programs(owner=None):
    """Drop captured serving programs: all of them (test isolation), or —
    with ``owner`` set — only the ones whose key belongs to that engine uid
    (``Engine.close()``: a closed engine's step functions hold the model)."""
    for key in [k for k in _serve_cache
                if owner is None or (len(k) > 1 and k[1] == owner)]:
        _serve_cache.pop(key).release()


def serve_capture_state() -> Dict[str, Any]:
    """Snapshot of the decode-mode capture cache (the engine's stats read
    this). ``cuda_graphs`` counts the programs captured as a CUDA graph."""
    return {
        "cached_programs": len(_serve_cache),
        "built_programs": sum(
            1 for p in _serve_cache.values()
            if p._built_donate or p._built_plain
        ),
        "cuda_graphs": sum(1 for p in _serve_cache.values() if p._graph is not None),
    }
