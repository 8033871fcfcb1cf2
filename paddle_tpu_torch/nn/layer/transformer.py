"""Transformer layers (``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention`` with its ``Cache`` / ``StaticCache``, the encoder and
decoder layers and stacks, and ``Transformer``.

Attention goes through ``nn.functional.scaled_dot_product_attention`` over
``[batch, seq, heads, head_dim]``, so without a mask it takes the port's
flash kernels (sm90 in bf16/fp16, tf32x3 in f32, non-causal) where the
shape is eligible, and the dense route with a mask. As in the JAX layer,
``MultiHeadAttention``'s ``dropout`` applies to its output projection, not
to the attention probabilities.
"""
from __future__ import annotations

import collections
import copy

import torch

from ...core import dispatch
from ...core.place import torch_device
from .. import functional as F
from ..layer_base import Layer
from .common import Dropout, LayerList, Linear
from .norm import LayerNorm


def _convert_attention_mask(attn_mask, dtype):
    """An additive mask of ``dtype``: a bool mask gives 0 where True and
    -1e9 where False; any other mask is cast."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        zero = torch.zeros((), dtype=dtype, device=attn_mask.device)
        return torch.where(attn_mask, zero, torch.full((), -1e9, dtype=dtype,
                                                       device=attn_mask.device))
    return attn_mask.to(dtype)


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, device=device)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr, bias_attr, device=device)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr, bias_attr, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, device=device)

    def _heads(self, proj, x):
        return proj(x).reshape(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        """Returns the output, then (``need_weights``) None for the weights
        and (a ``Cache``) the cache extended by this step's keys and values."""
        key = query if key is None else key
        value = query if value is None else value
        b, qlen = query.shape[0], query.shape[1]
        q = self._heads(self.q_proj, query)
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k, v = self._heads(self.k_proj, key), self._heads(self.v_proj, value)
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k.to(k.dtype), k], dim=1)
                v = torch.cat([cache.v.to(v.dtype), v], dim=1)
                cache = self.Cache(k, v)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        out = self.out_proj(out.reshape(b, qlen, self.embed_dim))
        if self.dropout and self.training:
            out = F.dropout(out, self.dropout, training=True)
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if isinstance(cache, self.Cache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)

    @dispatch.accepts_tensors
    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key``'s (and ``value``'s) projections, or an
        empty ``Cache`` for incremental decoding."""
        if type == MultiHeadAttention.StaticCache:
            return self.StaticCache(self._heads(self.k_proj, key),
                                    self._heads(self.v_proj, key if value is None else value))
        k = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim, device=key.device)
        return self.Cache(k, k)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False, weight_attr=None,
                 bias_attr=None, device=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout if attn_dropout is not None else dropout,
            weight_attr=weight_attr, bias_attr=bias_attr, device=device)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None else dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(getattr(F, self.activation)(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself, the rest deep copies, so all start equal), then ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [copy.deepcopy(encoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, src_mask)
            else:
                out, c = layer(out, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False, weight_attr=None,
                 bias_attr=None, device=None):
        super().__init__()
        self.normalize_before = normalize_before
        attn_p = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=attn_p, device=device)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=attn_p, device=device)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = residual + self.dropout1(self.self_attn(tgt, tgt, tgt, tgt_mask))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = residual + self.dropout2(self.cross_attn(tgt, memory, memory, memory_mask))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout3(getattr(F, self.activation)(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [copy.deepcopy(decoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, activation="relu", attn_dropout=None,
                 act_dropout=None, normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None):
        super().__init__()
        self.encoder = custom_encoder or TransformerEncoder(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout, activation,
                                    attn_dropout, act_dropout, normalize_before, device=device),
            num_encoder_layers,
            LayerNorm(d_model, device=device) if normalize_before else None)
        self.decoder = custom_decoder or TransformerDecoder(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout, activation,
                                    attn_dropout, act_dropout, normalize_before, device=device),
            num_decoder_layers,
            LayerNorm(d_model, device=device) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """A bool ``[length, length]`` mask, True on and below the diagonal."""
        return dispatch.wrap(torch.tril(torch.ones(length, length, dtype=torch.bool,
                                                   device=torch_device(None))))
