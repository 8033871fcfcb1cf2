"""Paged KV cache: a shared block pool + per-layer batch views, the port of
``paddle_tpu/serving/cache.py``.

Instead of one private ``[b, max_seq_len, h, d]`` K/V buffer per sequence
(``models/gpt.py`` dict caches), every sequence's context is a chain of
fixed-size blocks drawn from ONE shared pool per layer. Device memory is
bounded by the pool, and the scheduler refuses admission when no blocks
are free instead of running out of memory mid-decode. Completed sequences
recycle their blocks without re-capturing anything: a decode program is a
function of the block TABLE, not of which physical blocks a sequence owns.

The pool tensors live on the engine's device for the engine's whole life
and are written in place: a captured CUDA graph holds their addresses.

The attention math lives in ``ops/nn_ops.py paged_decode_attention`` and is
``cached_attention``'s, so paged decode is bitwise equal to the fixed-shape
cache path over the same context length.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..core import flags
from ..core.dtype import to_torch_dtype

__all__ = ["BlockPool", "PagedCacheView", "default_num_blocks"]


class BlockPool:
    """The shared K/V block storage plus its free-list.

    One *logical* block spans every layer: ``alloc`` hands out physical ids
    valid across all ``layers`` pool tensors, so a sequence's block table is
    layer-independent (the vLLM layout). Ids ``0..scratch_slots-1`` are
    reserved scratch blocks — one per decode-batch slot — that padded batch
    rows write into, each slot its own block so no two rows ever write into
    the same physical block.
    """

    def __init__(self, *, layers: int, heads: int, head_dim: int,
                 block_size: int, num_blocks: int, scratch_slots: int,
                 dtype: str = "float32", device=None):
        if num_blocks < 1:
            raise ValueError(
                f"BlockPool needs at least 1 allocatable block, got "
                f"{num_blocks} — raise FLAGS_serving_num_blocks"
            )
        self.layers = int(layers)
        self.block_size = int(block_size)
        self.scratch_slots = int(scratch_slots)
        self._num_blocks = int(num_blocks)
        total = self._num_blocks + self.scratch_slots
        shape = (total, self.block_size, int(heads), int(head_dim))
        self.dtype = to_torch_dtype(dtype)
        self.k: List[torch.Tensor] = [torch.zeros(shape, dtype=self.dtype, device=device)
                                      for _ in range(layers)]
        self.v: List[torch.Tensor] = [torch.zeros(shape, dtype=self.dtype, device=device)
                                      for _ in range(layers)]
        self._free = list(range(self.scratch_slots, total))
        self._peak_used = 0

    # -- bookkeeping --------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        """Allocatable blocks (excluding scratch)."""
        return self._num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self._num_blocks - len(self._free)

    def occupancy(self) -> float:
        return self.used_blocks / max(1, self._num_blocks)

    @property
    def peak_occupancy(self) -> float:
        return self._peak_used / max(1, self._num_blocks)

    # -- alloc/free ---------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """n physical block ids, or None when the pool is momentarily full
        (backpressure — the scheduler waits for a completion). A request
        that could NEVER fit raises CacheOverflow — the request-level
        reject, not an out-of-memory."""
        from ..models.gpt import CacheOverflow  # deferred: import-cycle safe

        if n > self._num_blocks:
            raise CacheOverflow(
                n, self._num_blocks,
                detail="blocks needed exceed the block pool",
            )
        if n > len(self._free):
            return None
        ids, self._free = self._free[:n], self._free[n:]
        self._peak_used = max(self._peak_used, self.used_blocks)
        return ids

    def free(self, ids: Sequence[int]):
        for i in ids:
            if i < self.scratch_slots:
                raise ValueError(f"block {i} is a reserved scratch slot")
        self._free.extend(int(i) for i in ids)

    def reset_storage(self):
        """Zero every pool tensor IN PLACE (shapes and free-list untouched):
        the recovery after a real fault mid-step, when the pool's contents
        can no longer be trusted. The tensors stay the same objects, so the
        captured graphs that write them stay valid."""
        for t in self.k + self.v:
            t.zero_()

    def reclaim_all(self) -> int:
        """Rebuild the free-list as if nothing were allocated; returns how
        many blocks were still outstanding. This is the repair half of the
        pool-leak tripwire: at engine idle (no active sequences) every
        block must be free — a nonzero return is an engine bug
        (``serve_block_leaks``), and reclaiming keeps the pool serviceable
        instead of slowly starving admission."""
        leaked = self.used_blocks
        total = self._num_blocks + self.scratch_slots
        self._free = list(range(self.scratch_slots, total))
        return leaked


class _BatchState:
    """Per-forward holder threading the pool tensors through the layer stack:
    each layer's view reads its pool entry and writes back the one
    ``paged_decode_attention`` returns (the same tensor: it writes in
    place)."""

    __slots__ = ("k_pools", "v_pools", "tables", "lens", "prefill")

    def __init__(self, k_pools, v_pools, tables, lens, prefill: bool):
        self.k_pools = list(k_pools)
        self.v_pools = list(v_pools)
        self.tables = tables
        self.lens = lens
        self.prefill = prefill


class PagedCacheView:
    """What ``GPTAttention.forward`` sees as its ``cache``: a per-layer
    handle onto the shared :class:`_BatchState`. ``append_attend`` writes
    this chunk's K/V into the pool at each row's next positions and attends
    over the gathered block view (``ops.nn_ops.paged_decode_attention``)."""

    __slots__ = ("_state", "layer", "block_size")

    def __init__(self, state: _BatchState, layer: int, block_size: int):
        self._state = state
        self.layer = int(layer)
        self.block_size = int(block_size)

    def append_attend(self, q, k, v, *, scale):
        from ..ops import nn_ops as _ops

        st = self._state
        out, nk, nv = _ops.paged_decode_attention(
            q, st.k_pools[self.layer], st.v_pools[self.layer],
            st.tables, st.lens, k, v,
            scale=scale, block_size=self.block_size, prefill=st.prefill,
        )
        st.k_pools[self.layer] = nk
        st.v_pools[self.layer] = nv
        return out


def default_num_blocks() -> int:
    """Pool size when FLAGS_serving_num_blocks is 0 and no memory budget is
    configured."""
    n = int(flags.flag("serving_num_blocks"))
    return n if n > 0 else 256
