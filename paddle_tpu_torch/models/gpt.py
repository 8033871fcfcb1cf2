"""GPT, the decoder-only LM of ``paddle_tpu/models/gpt.py``, in PyTorch.

Same configuration, parameter names and layouts as the JAX model, so a
``state_dict`` carries across (``convert.state_dict_from_numpy``):

  - attention and MLP are built from the fleet tensor-parallel layers at
    world size 1, with ``[in, out]`` weights;
  - the fused qkv projection is heads-major: ``[b, s, H, 3, hd]``, unbound
    on axis 3;
  - the full-sequence forward goes through ``F.scaled_dot_product_attention``,
    which launches the flash kernel on the card;
  - ``generate()`` decodes over a preallocated KV cache per layer
    (``ops/nn_ops.cached_attention``); a non-dict cache is the serving
    engine's paged view (``serving.PagedCacheView``,
    ``ops/nn_ops.paged_decode_attention``);
  - the LM head is tied to the word embeddings: ``h @ W_embᵀ``.

``GPTPretrainingCriterion`` is the training loss: token cross-entropy,
masked mean.

With ``use_recompute`` each decoder layer without a cache is one recompute
segment (``incubate.recompute``), as in the JAX model.

Not ported yet: ring and ulysses sequence parallelism (multi-GPU); it raises
NotImplementedError when asked for.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import amp as _amp
from .. import nn
from ..core import random as _random
from ..core.place import torch_device
from ..distributed.fleet.meta_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..incubate.recompute import recompute
from ..nn import functional as F
from ..nn import initializer as I
from ..ops import nn_ops as _ops


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden_size: Optional[int] = None
    max_seq_len: int = 1024
    dropout: float = 0.1
    attn_dropout: float = 0.1
    initializer_range: float = 0.02
    sequence_parallel: bool = False
    sequence_parallel_mode: str = "gspmd"
    use_recompute: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size


class CacheOverflow(ValueError):
    """A generation step would write past the KV cache's capacity."""

    def __init__(self, need: int, capacity: int, detail: str = ""):
        self.need = int(need)
        self.capacity = int(capacity)
        suffix = f" ({detail})" if detail else ""
        super().__init__(
            f"KV cache overflow: need {need} positions > capacity {capacity}{suffix}"
        )


class GPTAttention(nn.Layer):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        init = I.Normal(0.0, cfg.initializer_range)
        self.qkv_proj = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, weight_attr=init,
            gather_output=False, device=device,
        )
        self.out_proj = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, weight_attr=init,
            input_is_parallel=True, device=device,
        )

    def forward(self, x, cache=None):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x)
        # heads-major fused layout: 3h splits as H x 3 x hd
        q, k, v = qkv.reshape(b, s, self.num_heads, 3, self.head_dim).unbind(dim=3)
        scale = 1.0 / math.sqrt(self.head_dim)
        if cache is not None and not isinstance(cache, dict):
            # the serving engine's paged view (serving.PagedCacheView): the
            # block pool, tables and per-row lengths live in the view
            out = cache.append_attend(q, k, v, scale=scale)
            return self.out_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        if cache is not None:
            if cache.get("k") is None:
                shape = (b, cfg.max_seq_len, self.num_heads, self.head_dim)
                cache["k"] = torch.zeros(shape, dtype=k.dtype, device=k.device)
                cache["v"] = torch.zeros(shape, dtype=v.dtype, device=v.device)
                cache["len"] = 0
            if cache["len"] + s > cfg.max_seq_len:
                raise CacheOverflow(
                    cache["len"] + s, cfg.max_seq_len,
                    detail=f"cached {cache['len']} + new {s} > max_seq_len",
                )
            out, cache["k"], cache["v"] = _ops.cached_attention(
                q, cache["k"], cache["v"], k, v, cache["len"], scale=scale
            )
            cache["len"] += s
            return self.out_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        if cfg.sequence_parallel and cfg.sequence_parallel_mode in ("ring", "ulysses"):
            raise NotImplementedError(
                f"{cfg.sequence_parallel_mode} attention is not ported yet: it "
                "comes with the multi-GPU work"
            )
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=cfg.attn_dropout if self.training else 0.0,
            training=self.training,
        )
        return self.out_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class GPTMLP(nn.Layer):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        init = I.Normal(0.0, cfg.initializer_range)
        out_init = I.Normal(0.0, cfg.initializer_range / math.sqrt(2.0 * cfg.num_layers))
        self.fc1 = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_hidden_size, weight_attr=init,
            gather_output=False, device=device,
        )
        self.fc2 = RowParallelLinear(
            cfg.ffn_hidden_size, cfg.hidden_size, weight_attr=out_init,
            input_is_parallel=True, device=device,
        )

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTDecoderLayer(nn.Layer):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = nn.LayerNorm(cfg.hidden_size, device=device)
        self.attn = GPTAttention(cfg, device=device)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, device=device)
        self.mlp = GPTMLP(cfg, device=device)
        self.dropout = nn.Dropout(cfg.dropout)

    def _block(self, x, cache=None):
        x = x + self.dropout(self.attn(self.ln1(x), cache=cache))
        return x + self.dropout(self.mlp(self.ln2(x)))

    def forward(self, x, cache=None):
        if self.cfg.use_recompute and cache is None:
            return recompute(self._block, x)
        return self._block(x, cache=cache)


class GPTEmbeddings(nn.Layer):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        init = I.Normal(0.0, cfg.initializer_range)
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, weight_attr=init, device=device
        )
        self.position_embeddings = nn.Embedding(
            cfg.max_seq_len, cfg.hidden_size, weight_attr=init, device=device
        )
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, pos_offset=0):
        """``pos_offset``: an int, or a ``[b]`` tensor of per-row offsets."""
        s = input_ids.shape[1]
        pos = torch.arange(s, dtype=torch.int64, device=input_ids.device).unsqueeze(0)
        if isinstance(pos_offset, torch.Tensor):
            pos = pos + pos_offset.to(torch.int64).unsqueeze(-1)
        else:
            pos = pos + pos_offset
        h = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        return self.dropout(h)


class GPTModel(nn.Layer):
    """Decoder-only transformer trunk."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg, device=device)
        self.layers = nn.LayerList([GPTDecoderLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers)])
        self.final_ln = nn.LayerNorm(cfg.hidden_size, device=device)

    def forward(self, input_ids, caches=None, pos_offset=0):
        h = self.embeddings(input_ids, pos_offset=pos_offset)
        for i, layer in enumerate(self.layers):
            h = layer(h, cache=None if caches is None else caches[i])
        return self.final_ln(h)


class GPTForPretraining(nn.Layer):
    """Trunk + weight-tied LM head.

    ``device``: where the parameters live; the current device when None
    (the card by default, which raises without CUDA)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        device = torch_device(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=device)

    def forward(self, input_ids, caches=None, pos_offset=0):
        if caches is not None:
            return self._tied_head(self.gpt(input_ids, caches=caches, pos_offset=pos_offset))
        h = self.gpt.embeddings(input_ids)
        for layer in self.gpt.layers:
            h = layer(h)
        return self._tied_head(self.gpt.final_ln(h))

    def _tied_head(self, h):
        # paddle.matmul in the JAX head: the O1 "matmul" cast
        h, w = _amp.maybe_cast_inputs("matmul", (h, self.gpt.embeddings.word_embeddings.weight))
        return torch.matmul(h, w.t())

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 1.0,
                 top_k: Optional[int] = None, eos_token_id: Optional[int] = None):
        """Autoregressive decoding: greedy, or top-k sampling when ``top_k`` is set.

        Prefills a KV cache per layer over the prompt, then runs one
        single-token forward per new token. Sampling draws from the port's
        generator of the model's device, so ``seed()`` reproduces a run.
        Rows that emitted ``eos_token_id`` repeat their last token; decoding
        stops early when every row has. Returns the ``[b, total]`` int64
        buffer (prompt and new tokens) on the model's device."""
        was_training = self.training
        self.eval()
        try:
            if isinstance(input_ids, torch.Tensor):
                input_ids = input_ids.cpu().numpy()
            ids = np.asarray(input_ids, np.int64)
            if ids.ndim == 1:
                ids = ids[None, :]
            b, prompt_len = ids.shape
            if prompt_len >= self.cfg.max_seq_len:
                raise ValueError(
                    f"prompt length {prompt_len} leaves no room to generate "
                    f"within max_seq_len={self.cfg.max_seq_len}; truncate the "
                    "prompt (keep its most recent tokens) before calling"
                )
            device = self.gpt.embeddings.word_embeddings.weight.device
            total = min(prompt_len + max_new_tokens, self.cfg.max_seq_len)
            buf = np.zeros((b, total), np.int64)
            buf[:, :prompt_len] = ids[:, :total]
            done = np.zeros((b,), bool)
            caches = [{"k": None, "v": None} for _ in self.gpt.layers]
            for cur in range(prompt_len, total):
                if cur == prompt_len:  # prefill the whole prompt
                    feed = torch.as_tensor(buf[:, :prompt_len], device=device)
                    step_t = self(feed, caches=caches, pos_offset=0)[:, -1, :]
                else:  # one new token
                    feed = torch.as_tensor(buf[:, cur - 1:cur], device=device)
                    step_t = self(feed, caches=caches, pos_offset=cur - 1)[:, 0, :]
                if top_k is not None:
                    t = max(float(temperature), 1e-6)
                    k_eff = min(int(top_k), step_t.shape[-1])
                    vals, idx = torch.topk(step_t / t, k_eff, dim=-1)
                    probs = F.softmax(vals.float(), axis=-1)
                    choice = torch.multinomial(
                        probs, num_samples=1, generator=_random.generator(device)
                    )
                    nxt = torch.gather(idx, -1, choice)[:, 0].cpu().numpy()
                else:
                    nxt = step_t.argmax(dim=-1).cpu().numpy()
                nxt = np.where(done, buf[:, cur - 1], nxt)
                buf[:, cur] = nxt
                if eos_token_id is not None:
                    done |= nxt == eos_token_id
                    if done.all():
                        buf = buf[:, :cur + 1]
                        break
            return torch.as_tensor(buf, device=device)
        finally:
            if was_training:
                self.train()


class GPTPretrainingCriterion(nn.Layer):
    """Cross-entropy of the LM logits against the shifted labels; with a
    ``loss_mask``, the mean over the positions it keeps."""

    def __init__(self, cfg: Optional[GPTConfig] = None):
        super().__init__()

    def forward(self, logits, labels, loss_mask=None):
        loss = F.cross_entropy(logits, labels, reduction="none")
        if loss_mask is not None:
            loss = loss * loss_mask
            # the JAX Tensor.sum and Tensor.mean: the O1 "sum" and "mean" casts
            loss, loss_mask = _amp.maybe_cast_inputs("sum", (loss, loss_mask))
            return loss.sum() / loss_mask.sum().clamp(min=1.0)
        (loss,) = _amp.maybe_cast_inputs("mean", (loss,))
        return loss.mean()


def gpt2_small(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt2_medium(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def gpt2_345m(**kw) -> GPTConfig:
    """GPT-2 345M: 24 layers, hidden 1024, 16 heads, vocab 50304, seq 1024."""
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)
