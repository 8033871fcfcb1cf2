"""BERT, the MLM + NSP pretraining model of ``paddle_tpu/models/bert.py``, in
PyTorch.

Same configuration, parameter names and layouts as the JAX model, so a
``state_dict`` carries across (``convert.state_dict_from_numpy``):

  - the encoder is built from the fleet tensor-parallel layers at world
    size 1, with ``[in, out]`` weights;
  - the fused qkv projection is projection-major: ``[b, s, 3, H, hd]``,
    unbound on axis 2 (GPT's is heads-major). The q, k and v views keep a
    sequence stride of 3·H·hd and lie H·hd and 2·H·hd elements into the
    buffer; the flash kernels read them as they are, with no copy;
  - attention goes through ``F.scaled_dot_product_attention``: with no mask
    and no attention dropout the flash route, non-causal, which launches the
    flash kernels on the card; with an ``attention_mask``, or attention
    dropout in training, the dense route, as the JAX selector picks;
  - the MLM head is tied to the word embeddings: ``h @ W_embᵀ + mlm_bias``.

``attention_mask`` is ``[b, s]`` with 1 for a token and 0 for padding; it
becomes an additive f32 ``[b, 1, 1, s]`` mask of -1e9 at the padding. Under
AMP O2 that f32 mask promotes the bf16 logits, and from there the model runs
in f32, as the JAX model does (``ops/nn_ops.promoted``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import amp as _amp
from .. import nn
from ..core.place import torch_device
from ..distributed.fleet.meta_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..nn import functional as F
from ..nn import initializer as I
from ..ops import nn_ops as _ops


@dataclass
class BertConfig:
    vocab_size: int = 30528
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden_size: Optional[int] = None
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    attn_dropout: float = 0.1
    initializer_range: float = 0.02

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        init = I.Normal(0.0, cfg.initializer_range)
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, weight_attr=init, device=device
        )
        self.position_embeddings = nn.Embedding(
            cfg.max_seq_len, cfg.hidden_size, weight_attr=init, device=device
        )
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, weight_attr=init, device=device
        )
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, device=device)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, dtype=torch.int64, device=input_ids.device).unsqueeze(0)
        h = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            h = h + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(h))


class BertEncoderLayer(nn.Layer):
    def __init__(self, cfg: BertConfig, device=None):
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
        self.fc1 = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_hidden_size, weight_attr=init,
            gather_output=False, device=device,
        )
        self.fc2 = RowParallelLinear(
            cfg.ffn_hidden_size, cfg.hidden_size, weight_attr=init,
            input_is_parallel=True, device=device,
        )
        self.ln1 = nn.LayerNorm(cfg.hidden_size, device=device)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, device=device)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        # projection-major fused layout: 3h splits as 3 x H x hd
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        attn = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.cfg.attn_dropout if self.training else 0.0,
            training=self.training,
        )
        attn = attn.reshape(b, s, self.num_heads * self.head_dim)
        x = self.ln1(x + self.dropout(self.out_proj(attn)))
        h = self.fc2(F.gelu(self.fc1(x), approximate=True))
        return self.ln2(x + self.dropout(h))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device=device)
        self.layers = nn.LayerList([BertEncoderLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers)])
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, device=device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        mask = None
        if attention_mask is not None:
            # [b, s] 1/0 → additive [b, 1, 1, s]
            mask = ((1.0 - attention_mask.float()) * -1e9)[:, None, None, :]
        h = self.embeddings(input_ids, token_type_ids)
        for layer in self.layers:
            h = layer(h, mask)
        pooled = F.tanh(self.pooler(h[:, 0]))
        return h, pooled


class BertForPretraining(nn.Layer):
    """Trunk + MLM head (tied to the word embeddings) + NSP head.

    ``device``: where the parameters live; the current device when None
    (the card by default, which raises without CUDA)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        device = torch_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, device=device)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size, device=device)
        self.mlm_ln = nn.LayerNorm(cfg.hidden_size, device=device)
        self.mlm_bias = self.create_parameter([cfg.vocab_size], is_bias=True)
        self.nsp = nn.Linear(cfg.hidden_size, 2, device=device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_ln(F.gelu(self.mlm_transform(seq), approximate=True))
        # paddle.matmul in the JAX head: the O1 "matmul" cast, and jnp's
        # promotion of an f32 h (the masked O2 path) against the bf16 table
        h, w = _amp.maybe_cast_inputs("matmul", (h, self.bert.embeddings.word_embeddings.weight))
        h, w = _ops.promoted(h, w)
        mlm_logits = torch.matmul(h, w.t()) + self.mlm_bias
        nsp_logits = self.nsp(pooled)
        return mlm_logits, nsp_logits


class BertPretrainingCriterion(nn.Layer):
    """MLM cross-entropy (labels of -100 ignored; with ``mlm_mask``, the mean
    over the positions it keeps) plus NSP cross-entropy."""

    def __init__(self, vocab_size=None):
        super().__init__()

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels, mlm_mask=None):
        mlm_loss = F.cross_entropy(mlm_logits, mlm_labels, reduction="none", ignore_index=-100)
        if mlm_mask is not None:
            mlm_loss = mlm_loss * mlm_mask
            # the JAX Tensor.sum and Tensor.mean: the O1 "sum" and "mean" casts
            mlm_loss, mlm_mask = _amp.maybe_cast_inputs("sum", (mlm_loss, mlm_mask))
            mlm_loss = mlm_loss.sum() / mlm_mask.sum().clamp(min=1.0)
        else:
            (mlm_loss,) = _amp.maybe_cast_inputs("mean", (mlm_loss,))
            mlm_loss = mlm_loss.mean()
        nsp_loss = F.cross_entropy(nsp_logits, nsp_labels)
        return mlm_loss + nsp_loss
