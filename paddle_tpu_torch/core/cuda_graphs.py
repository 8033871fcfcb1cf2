"""How the port captures and replays a CUDA graph: one helper for every
capture site (``jit.CompiledTrainStep``, the lazy segment graphs and the
whole-step capture of ``core/lazy.py``, the serving engine's programs).

A capture runs inside ``Graph.capture()``:

  - the port's generators of the device are registered with the graph
    (``core.random.register_generator_state``), with the generator pairs of
    ``segments`` recompute segments, so a replay draws new random numbers;
  - Python's cyclic garbage collector is paused: a collection that frees an
    older graph inside a capture resets that graph there, which CUDA
    refuses, and which spoils the capture (``torch.cuda.graph`` collects
    once just before its capture begins);
  - the capture goes into ``pool`` when one is given (graphs that run one
    after another can share one), else into a private pool.

``Graph.replay()`` reseeds the segment pairs and replays. ``warm_up`` runs
a function on the device's one side stream, as ``torch.cuda.graphs`` asks
of the eager runs before a capture; ``copy_in`` loads new inputs into a
graph's static buffers.
"""
from __future__ import annotations

import contextlib
import gc

import torch

from . import random as _random

__all__ = ["Graph", "copy_in", "gc_paused", "side_stream", "warm_up"]


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic garbage collector off for the block."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


_side_streams: dict = {}


def side_stream(device) -> "torch.cuda.Stream":
    """The one side stream of ``device`` that every warm-up runs on. Each
    stream the process runs a matrix product on keeps a cuBLAS workspace of
    its own allocated for good (PyTorch's default is 32 MiB on Hopper), so
    a new stream per warm-up grew the process by a workspace per captured
    program."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = _side_streams.get(device)
    if side is None:
        side = _side_streams[device] = torch.cuda.Stream(device=device)
    return side


def warm_up(device, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on the device's side stream, ordered after
    and before the device's current stream's work; returns its result."""
    current = torch.cuda.current_stream(device)
    side = side_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn(*args, **kwargs)
    current.wait_stream(side)
    return out


def copy_in(static, values):
    """Copy each of ``values`` into its static buffer, unless it is that
    buffer's own storage."""
    with torch.no_grad():
        for s, v in zip(static, values):
            if s.data_ptr() != v.data_ptr():
                s.copy_(v)


class Graph:
    """One CUDA graph on ``device`` and the generator pairs it was captured
    with."""

    __slots__ = ("graph", "device", "pairs")

    def __init__(self, device):
        self.graph = torch.cuda.CUDAGraph()
        self.device = torch.device(device)
        self.pairs = None

    @contextlib.contextmanager
    def capture(self, pool=None, segments: int = 0):
        """Capture what runs inside the block into this graph."""
        with gc_paused(), _random.register_generator_state(
                self.graph, self.device, segments) as self.pairs, \
                torch.cuda.graph(self.graph, pool=pool):
            yield self

    def replay(self):
        self.pairs.reseed()
        self.graph.replay()

    def reset(self):
        self.graph.reset()

    def pool_bytes(self) -> int:
        """The bytes the caching allocator keeps in this graph's memory pool:
        its segments, reserved between replays (a replay's
        ``max_memory_allocated`` does not count them)."""
        pool = tuple(self.graph.pool())
        return sum(int(s["total_size"]) for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id") or ()) == pool)
