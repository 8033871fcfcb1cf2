"""The cases the ranks of ``tests/torch_dist_pool.RankPool`` run: the port
alone (torch, numpy), on the CPU, over gloo. Inputs come from the test
process as numpy arrays (the JAX side's weights and batches, or seeds);
results go back as numpy arrays and plain values."""
from __future__ import annotations

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import fleet


def ready():
    return pt.distributed.get_rank()


def _np(t):
    return t.detach().cpu().numpy().copy()


def rank_inputs(seed, rank, shape):
    """Rank ``rank``'s input of a collective case (the test makes the same)."""
    return np.random.default_rng(seed + rank).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def collectives(seed, shape):
    """Every collective of the world group on this rank's input; the results."""
    rank, world = pt.distributed.get_rank(), pt.distributed.get_world_size()
    x = torch.as_tensor(rank_inputs(seed, rank, shape))
    out = {}
    for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                     ("min", C.ReduceOp.MIN), ("prod", C.ReduceOp.PROD),
                     ("avg", C.ReduceOp.AVG)):
        t = x.clone()
        C.all_reduce(t, op)
        out[f"all_reduce_{name}"] = _np(t)
    t = pt.to_tensor(x.numpy())  # a Paddle Tensor, in place
    C.all_reduce(t)
    out["all_reduce_tensor"] = t.numpy()
    got = []
    C.all_gather(got, x)
    out["all_gather"] = np.stack([_np(g) for g in got])
    t = x.clone()
    C.broadcast(t, src=world - 1)
    out["broadcast"] = _np(t)
    t = x.clone()
    C.reduce(t, dst=0)
    out["reduce"] = _np(t)
    t = torch.empty(shape)
    parts = [torch.as_tensor(rank_inputs(seed, 100 + i, shape)) for i in range(world)]
    C.scatter(t, parts, src=0)
    out["scatter"] = _np(t)
    t = torch.empty((shape[0] // world,) + tuple(shape[1:]))
    C.reduce_scatter(t, x)
    out["reduce_scatter"] = _np(t)
    chunks = list(x.chunk(world, dim=0))
    out["alltoall"] = np.stack([_np(o) for o in C.alltoall(chunks)])
    out["alltoall_single"] = _np(C.alltoall_single(x))
    out["shift"] = _np(C.shift(x, 1))
    out["shift_wrap"] = _np(C.shift(x, 1, wrap=True))
    out["ppermute"] = _np(C.ppermute(x, [(i, world - 1 - i) for i in range(world)]))
    t = x.clone()
    if rank == 0:
        C.send(t, dst=world - 1)
    elif rank == world - 1:
        C.recv(t, src=0)
    out["send_recv"] = _np(t)
    t = x.clone()
    task = C.isend(t, dst=(rank + 1) % world) if rank % 2 == 0 else \
        C.irecv(t, src=(rank - 1) % world)
    task.wait()
    out["isend_irecv"] = _np(t)
    out["all_gather_object"] = C.all_gather_object([], {"rank": rank})
    C.barrier()
    sub = C.new_group([r for r in range(world) if r % 2 == 0])
    t = x.clone()
    C.all_reduce(t, group=sub)
    out["subgroup_sum"] = _np(t)
    out["subgroup_rank"] = sub.rank
    return out


def hcg_groups(degrees):
    """This rank's group ranks along every axis under ``degrees``."""
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    return {
        "data": hcg.get_data_parallel_group().ranks,
        "model": hcg.get_model_parallel_group().ranks,
        "sharding": hcg.get_sharding_parallel_group().ranks,
        "pipe": hcg.get_pipe_parallel_group().ranks,
        "coord": (hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank(),
                  hcg.get_sharding_parallel_rank()),
        "comm_model": hcg.topology().get_comm_list("model"),
        "comm_data": hcg.topology().get_comm_list("data"),
        "comm_sharding": hcg.topology().get_comm_list("sharding"),
    }


# ---------------------------------------------------------------------------
# the tensor-parallel layers
# ---------------------------------------------------------------------------
class TPBlock(pt.nn.Layer):
    """The JAX test's TP MLP (tests/test_distributed.py:98-110), both
    ColumnParallelLinear forms and both RowParallelLinear forms, and the
    vocab-parallel cross-entropy of a tied head."""

    def __init__(self, vocab, hidden, ffn):
        super().__init__()
        mp = fleet.meta_parallel
        self.emb = mp.VocabParallelEmbedding(vocab, hidden, device="cpu")
        self.fc1 = mp.ColumnParallelLinear(hidden, ffn, gather_output=False, device="cpu")
        self.fc2 = mp.RowParallelLinear(ffn, hidden, input_is_parallel=True, device="cpu")
        self.fc3 = mp.ColumnParallelLinear(hidden, ffn, gather_output=True, device="cpu")
        self.fc4 = mp.RowParallelLinear(ffn, hidden, input_is_parallel=False, device="cpu")
        self.ce = mp.ParallelCrossEntropy()

    def forward(self, ids):
        h = self.emb(ids)
        h = self.fc2(torch.relu(self.fc1(h)))
        h = self.fc4(torch.tanh(self.fc3(h)))
        w = self.emb.weight
        logits = torch.matmul(fleet.meta_parallel.copy_to_mp(h), w.t())
        return h, logits


def tp_layers(degrees, weights, ids, labels, cot, vocab, hidden, ffn):
    """The TP block at ``degrees`` on the global ``weights``: its output, the
    mean CE of its tied-head logits, and every gradient of (output * cot).sum()
    + CE (this rank's shards)."""
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=strategy)
    pt.seed(0)
    m = TPBlock(vocab, hidden, ffn)
    convert.load_global_state(m, weights)
    h, logits = m(torch.as_tensor(ids))
    ce = m.ce(logits, torch.as_tensor(labels)).mean()
    loss = (h * torch.as_tensor(cot)).sum() + ce
    loss.backward()
    return {"out": _np(h), "ce": float(ce),
            "grads": {n: _np(p.grad) for n, p in m.named_parameters()},
            "layout": convert.model_layout(m)}


# ---------------------------------------------------------------------------
# the hybrid GPT step
# ---------------------------------------------------------------------------
def gpt_step(degrees, stage, cfg, weights, batches, lr, moments=None, clip=None, k_steps=1,
             amp=False):
    """GPT through fleet at ``degrees`` and ZeRO ``stage``: the losses of the
    global ``batches``, this rank's parameters after them, and, given the
    JAX run's global ``moments`` ({param name: {key: array}}), the largest
    difference between this rank's moment shards and their slices."""
    from paddle_tpu_torch.models import gpt

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    if stage:
        strategy.sharding = True
        strategy.sharding_configs = {"stage": stage}
    if k_steps > 1:
        strategy.gradient_merge = True
        strategy.gradient_merge_configs = {"k_steps": k_steps, "avg": True}
    if amp:
        strategy.amp = True
        strategy.amp_configs = {"use_pure_bf16": True}
    fleet.init(is_collective=True, strategy=strategy)
    pt.seed(0)
    model = gpt.GPTForPretraining(gpt.GPTConfig(**cfg), device="cpu")
    convert.load_global_state(model, weights)
    model = fleet.distributed_model(model)
    crit = gpt.GPTPretrainingCriterion()
    grad_clip = pt.nn.ClipGradByGlobalNorm(clip) if clip else None
    opt = pt.optimizer.AdamW(learning_rate=lr, parameters=model.parameters(),
                             weight_decay=0.01, grad_clip=grad_clip)
    opt = fleet.distributed_optimizer(opt)
    step = fleet.distributed_train_step(model, crit, opt)
    losses = [float(step(torch.as_tensor(x), torch.as_tensor(y))) for x, y in batches]
    out = {"losses": losses, "params": {n: _np(p) for n, p in model.state_dict().items()},
           "layout": convert.model_layout(model),
           "sizes": {n: int(p.numel()) for n, p in model.named_parameters()}}
    inner = getattr(opt, "_inner", opt)
    if moments is not None:
        worst, counted = 0.0, 0
        for name, p in model.named_parameters():
            st = inner._accumulators[id(p)]
            for key, glob in moments[name].items():
                want = np.asarray(convert.shard_moment(glob, p) if np.ndim(glob) else glob)
                got = _np(st[key])
                assert got.shape == want.shape, (name, key, got.shape, want.shape)
                worst = max(worst, float(np.max(np.abs(got - want))))
                counted += 1
        out["moment_diff"] = worst
        out["moments_checked"] = counted
        out["moment_numel"] = {n: int(inner._accumulators[id(p)]["moment1"].numel())
                               for n, p in model.named_parameters()}
    return out


def spawned_rank(out_dir):
    """A rank ``paddle.distributed.spawn`` starts: joins the others over
    gloo, sums its rank over the world, and writes what it saw and the
    top-level packages it loaded to ``out_dir/rank<r>.json``."""
    import json
    import os
    import sys

    pt.set_device("cpu")
    env = pt.distributed.init_parallel_env()
    t = torch.tensor([float(env.rank + 1)])
    pt.distributed.all_reduce(t)
    loaded = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "paddle_tpu"))
    with open(os.path.join(out_dir, f"rank{env.rank}.json"), "w") as f:
        json.dump({"rank": env.rank, "world": env.world_size, "sum": float(t[0]),
                   "loaded": loaded}, f)


# ---------------------------------------------------------------------------
# DataParallel and the eager meta-optimizers
# ---------------------------------------------------------------------------
def _linear(weights):
    m = pt.nn.Linear(weights["weight"].shape[0], weights["weight"].shape[1])
    convert.state_dict_from_numpy(m, weights)
    return m


def data_parallel(weights, x, y, lr):
    """One SGD step of a DataParallel Linear on this rank's rows of (x, y);
    then two backwards, the first under ``no_sync``: the gradients each rank
    held after the first, and all after the second."""
    rank, world = pt.distributed.get_rank(), pt.distributed.get_world_size()
    rows = x.shape[0] // world
    xs = torch.as_tensor(x[rank * rows:(rank + 1) * rows])
    ys = torch.as_tensor(y[rank * rows:(rank + 1) * rows])
    m = _linear(weights)
    dp = pt.DataParallel(m)
    opt = pt.optimizer.SGD(learning_rate=lr, parameters=dp.parameters())
    loss = dp.scale_loss(pt.nn.functional.mse_loss(dp(xs), ys))
    loss.backward()
    opt.step()
    opt.clear_grad()
    out = {"params": {n: _np(p) for n, p in m.named_parameters()},
           "keys": sorted(dp.state_dict()) == sorted(m.state_dict())}
    with dp.no_sync():
        pt.nn.functional.mse_loss(dp(xs), ys).backward()
    out["local"] = {n: _np(p.grad) for n, p in m.named_parameters()}
    pt.nn.functional.mse_loss(dp(xs * 2.0), ys).backward()
    # this rank's own second gradient: the accumulated one less the first
    out["synced"] = {n: _np(p.grad) for n, p in m.named_parameters()}
    m2 = _linear({n: out["params"][n] for n in out["params"]})
    pt.nn.functional.mse_loss(m2(xs * 2.0), ys).backward()
    out["second"] = {n: _np(p.grad) for n, p in m2.named_parameters()}
    return out


def local_sgd(weights, x, y, lr, k, steps):
    """``steps`` SGD steps of a Linear on this rank's (x[rank], y[rank]) under
    LocalSGD(k): the parameters after each step."""
    rank = pt.distributed.get_rank()
    m = _linear(weights)
    opt = fleet.LocalSGDOptimizer(pt.optimizer.SGD(learning_rate=lr,
                                                   parameters=m.parameters()), k_steps=k)
    out = []
    for _ in range(steps):
        pt.nn.functional.mse_loss(m(torch.as_tensor(x[rank])), torch.as_tensor(y[rank])).backward()
        opt.step()
        opt.clear_grad()
        out.append({n: _np(p) for n, p in m.named_parameters()})
    return out


def dgc(weights, x, y, lr, momentum, sparsity, rampup_begin_step, steps):
    """``steps`` DGCMomentumOptimizer steps of a Linear on this rank's
    (x[rank], y[rank]): the parameters after each step."""
    rank = pt.distributed.get_rank()
    m = _linear(weights)
    opt = fleet.DGCMomentumOptimizer(learning_rate=lr, momentum=momentum, sparsity=sparsity,
                                     rampup_begin_step=rampup_begin_step,
                                     parameters=m.parameters())
    out = []
    for _ in range(steps):
        pt.nn.functional.mse_loss(m(torch.as_tensor(x[rank])), torch.as_tensor(y[rank])).backward()
        opt.step()
        opt.clear_grad()
        out.append({n: _np(p) for n, p in m.named_parameters()})
    return out


def card_collectives(out_dir):
    """A rank on the card (``spawn`` gives it its card and backend): an
    all-reduce, all-gather, reduce-scatter and all-to-all of card tensors,
    written with the backend to ``out_dir/rank<r>.json``."""
    import json
    import os

    env = pt.distributed.init_parallel_env()
    r, n = env.rank, env.world_size
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.arange(4 * n, dtype=torch.float32, device=dev) + 100 * r
    t = x.clone()
    C.all_reduce(t)
    got = []
    C.all_gather(got, x)
    rs = torch.empty(4, device=dev)
    C.reduce_scatter(rs, x)
    a2a = C.alltoall_single(x)
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump({"backend": pt.distributed.get_group().backend, "device": str(t.device),
                   "all_reduce": t.tolist(), "all_gather": torch.stack(got).tolist(),
                   "reduce_scatter": rs.tolist(), "alltoall_single": a2a.tolist()}, f)


def group_sharded_save(degrees, cfg, weights, out_dir):
    """GPT at ``degrees`` cut by ``group_sharded_parallel(level="p_g_os")``
    (ZeRO-3), then ``save_group_sharded_model``: rank 0 writes the whole
    state. Returns this rank's parameter sizes."""
    from paddle_tpu_torch.distributed.sharding import (group_sharded_parallel,
                                                       save_group_sharded_model)
    from paddle_tpu_torch.models import gpt

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=strategy)
    model = gpt.GPTForPretraining(gpt.GPTConfig(**cfg), device="cpu")
    convert.load_global_state(model, weights)
    opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
    model, opt = group_sharded_parallel(model, opt, "p_g_os")
    save_group_sharded_model(model, out_dir, opt)
    return {n: int(p.numel()) for n, p in model.named_parameters()}
