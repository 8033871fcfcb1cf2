"""BASELINE config 5 on the port: ERNIE-style sparse CTR training
(``examples/ernie_ctr.py`` of the JAX package).

Billions of sparse CTR features live in host parameter-server tables, a
dense text encoder runs on the card, and every step goes host pull ->
device dense step -> host push (reference: the PSGPU trainer flow,
paddle/fluid/framework/trainer.h:253, and the_one_ps.py:816):

  - sparse side: a ``MemorySparseTable`` (the C++ sharded host table,
    optionally with SSD overflow) holds one row per feature id; the
    minibatch's rows are pulled (made on a miss), uploaded as one
    [batch, slots, dim] block, and their gradients come back from the
    compiled step (``compile_train_step(..., grad_input_idx=(0,))``) to be
    pushed into the table, whose C++ accessor applies AdaGrad per feature;
  - dense side: a small ERNIE-like transformer encoder over the token ids,
    a slot projector and a CTR head, trained by Adam inside the compiled
    step: one CUDA graph a step on the card (the rows are copied into its
    static input buffer), eager on the CPU. In f32 at head dim 32 its
    attention runs on the tf32x3 flash kernels.

Run: ``python -m paddle_tpu_torch.examples.ernie_ctr [steps]``
"""
from __future__ import annotations

import sys
import time

import numpy as np

import paddle_tpu_torch as paddle
from paddle_tpu_torch.distributed.ps import MemorySparseTable, SparsePipeline

__all__ = ["ErnieCtrConfig", "ErnieCtrDense", "build", "synthetic_batch", "train_step",
           "train_pipelined"]


class ErnieCtrConfig:
    def __init__(self, vocab_size=8000, hidden=256, layers=4, heads=8, seq_len=128, slots=16,
                 sparse_dim=64, dropout=0.0):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.seq_len = seq_len
        self.slots = slots
        self.sparse_dim = sparse_dim
        self.dropout = dropout


class ErnieCtrDense(paddle.nn.Layer):
    """The dense half on the card: takes the PULLED sparse rows as an input
    (their gradient goes back to the table), encodes the text with a
    transformer, and scores the click probability."""

    def __init__(self, cfg: ErnieCtrConfig):
        super().__init__()
        self.cfg = cfg
        self.tok = paddle.nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.pos = paddle.nn.Embedding(cfg.seq_len, cfg.hidden)
        layer = paddle.nn.TransformerEncoderLayer(
            cfg.hidden, cfg.heads, cfg.hidden * 4, dropout=cfg.dropout, activation="gelu",
            normalize_before=True,
        )
        self.encoder = paddle.nn.TransformerEncoder(layer, cfg.layers)
        self.slot_proj = paddle.nn.Linear(cfg.slots * cfg.sparse_dim, cfg.hidden)
        self.head = paddle.nn.Linear(2 * cfg.hidden, 1)

    def forward(self, sparse_rows, token_ids):
        b = token_ids.shape[0]
        pos = paddle.arange(self.cfg.seq_len, dtype="int64").unsqueeze(0)
        h = self.tok(token_ids) + self.pos(pos)
        h = self.encoder(h)
        text_feat = paddle.mean(h, axis=1)  # [b, hidden]
        slot_feat = paddle.nn.functional.relu(self.slot_proj(sparse_rows.reshape([b, -1])))
        fused = paddle.concat([text_feat, slot_feat], axis=-1)
        return self.head(fused).squeeze(-1)  # the CTR logit [b]


def build(cfg: ErnieCtrConfig, sparse_lr=0.05, dense_lr=1e-3, ssd_path=None, ram_budget=None,
          seed=0):
    """(table, model, compiled step). The step returns (loss, [the sparse
    rows' gradient]); the caller pushes the gradient."""
    paddle.seed(seed)
    table = MemorySparseTable(
        cfg.sparse_dim, shard_num=16, optimizer="adagrad", learning_rate=sparse_lr,
        init_range=0.01, seed=seed, ssd_path=ssd_path, ram_budget=ram_budget,
    )
    model = ErnieCtrDense(cfg)
    opt = paddle.optimizer.Adam(learning_rate=dense_lr, parameters=model.parameters())
    bce = paddle.nn.BCEWithLogitsLoss()
    step = paddle.jit.compile_train_step(model, lambda logit, y: bce(logit, y), opt,
                                         grad_input_idx=(0,))
    return table, model, step


def synthetic_batch(cfg: ErnieCtrConfig, batch, rng):
    """(slot feature ids, token ids, click labels) with a learnable
    structure: the label depends on both a slot feature and the tokens."""
    slot_ids = rng.integers(0, 200_000, (batch, cfg.slots)).astype(np.int64)
    tokens = rng.integers(0, cfg.vocab_size, (batch, cfg.seq_len)).astype(np.int64)
    click = ((slot_ids[:, 0] % 5) > 2) ^ ((tokens[:, 0] % 3) > 1)
    return slot_ids, tokens, click.astype(np.float32)


def train_step(table, step, cfg, slot_ids, tokens, labels):
    """One SYNC PS round trip: pull -> compiled dense step -> push. Returns
    the loss."""
    flat = slot_ids.reshape(-1)
    rows = table.pull(flat).reshape(slot_ids.shape[0], cfg.slots, cfg.sparse_dim)
    loss, (row_grads,) = step(paddle.to_tensor(rows), paddle.to_tensor(tokens),
                              paddle.to_tensor(labels))
    table.push(flat, row_grads.numpy().reshape(-1, cfg.sparse_dim))
    return float(loss)


def train_pipelined(table, step, cfg, batches):
    """The async-communicator loop (reference:
    ps/service/communicator/communicator.h and the PSGPU trainer pipeline):
    the NEXT batch's pull and the queued pushes run on host threads while
    the card runs the current step. Staleness is at most one step, the
    reference's async mode. Returns the losses."""
    pipe = SparsePipeline(table)
    losses = []
    try:
        rows_f = pipe.prefetch(batches[0][0].reshape(-1))
        for i, (slot_ids, tokens, labels) in enumerate(batches):
            flat = slot_ids.reshape(-1)
            rows = rows_f.result().reshape(slot_ids.shape[0], cfg.slots, cfg.sparse_dim)
            if i + 1 < len(batches):
                rows_f = pipe.prefetch(batches[i + 1][0].reshape(-1))
            loss, (row_grads,) = step(paddle.to_tensor(rows), paddle.to_tensor(tokens),
                                      paddle.to_tensor(labels))
            pipe.push_async(flat, row_grads.numpy().reshape(-1, cfg.sparse_dim))
            losses.append(float(loss))
        pipe.flush()
    finally:
        pipe.stop()
    return losses


def main(steps=30, batch=32):
    cfg = ErnieCtrConfig()
    table, model, step = build(cfg)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(cfg, batch, rng) for _ in range(steps)]
    t0 = time.time()
    train_step(table, step, cfg, *batches[0])
    warm_s = time.time() - t0
    t0 = time.time()
    losses = train_pipelined(table, step, cfg, batches)
    dt = time.time() - t0
    tps = batch * cfg.seq_len * steps / dt
    print(f"ernie-ctr: loss {losses[0]:.4f} -> {losses[-1]:.4f}; {len(table)} sparse features; "
          f"{tps:,.0f} tokens/s pipelined (first step {warm_s:.1f} s)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 30)
