"""The port's hybrid-parallel training against the JAX package's, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices
(tests/conftest.py): ``fleet.distributed_train_step`` compiles one SPMD
program. The port's side runs in a pool of 8 ranks (tests/torch_dist_pool.py):
processes that import the port alone, joined over gloo, each holding its
shards and calling the collectives itself. The JAX model's initial weights
and the global batches go to the ranks as numpy arrays; ``convert`` cuts
them into each rank's shards and gathers the ranks' shards back.

The model is GPT at 2 layers, hidden 64, 4 heads, vocab 512, seq 16,
dropout 0, AdamW; the hybrid is dp2 x mp2 x sharding2 (every axis real).
Tolerance: rtol 1e-4 and atol 1e-5 on losses and on every gathered
parameter, the JAX package's own sharded-against-single tolerance
(tests/test_distributed.py:147-149): the two order their sums differently
(the port's gradient sums run over ranks, the JAX ones inside one program).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel.topology import use_mesh
from paddle_tpu_torch import convert
from tests.torch_dist_pool import RankPool

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=16,
           dropout=0.0, attn_dropout=0.0)
DEGREES = {"dp": 2, "mp": 2, "sharding": 2}
GLOBAL_BATCH = 8
STEPS = 3
LR = 1e-3
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pool8(tmp_path_factory):
    pool = RankPool(8, tmp_path_factory.mktemp("ranks8"))
    yield pool
    pool.close()


def _batches(n=STEPS, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, CFG["vocab_size"], (GLOBAL_BATCH, CFG["max_seq_len"] + 1))
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def _jax_run(stage, batches, clip=None, k_steps=1, degrees=DEGREES):
    """JAX ``fleet.distributed_train_step`` at ``degrees``: the initial
    weights, the losses, the parameters and moments after."""
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    strategy.sharding = True
    strategy.sharding_configs = {"stage": stage}
    if k_steps > 1:
        strategy.gradient_merge = True
        strategy.gradient_merge_configs = {"k_steps": k_steps, "avg": True}
    jfleet.init(is_collective=True, strategy=strategy)
    paddle.seed(0)
    model = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG))
    weights = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    model = jfleet.distributed_model(model)
    crit = jgpt.GPTPretrainingCriterion()
    grad_clip = paddle.nn.ClipGradByGlobalNorm(clip) if clip else None
    opt = paddle.optimizer.AdamW(learning_rate=LR, parameters=model.parameters(),
                                 weight_decay=0.01, grad_clip=grad_clip)
    opt = jfleet.distributed_optimizer(opt)
    step = jfleet.distributed_train_step(model, crit, opt)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y))) for x, y in batches]
    params = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    inner = getattr(opt, "_inner", opt)
    moments = {name: {k: np.asarray(v) for k, v in inner._accumulators[id(p)].items()}
               for name, p in model.named_parameters()}
    return weights, losses, params, moments


def _check(jax_out, port_out, degrees=DEGREES):
    _, losses, params, _ = jax_out
    for r in port_out:
        np.testing.assert_allclose(r["losses"], losses, **TOL)
    got = convert.gather_arrays([r["params"] for r in port_out], port_out[0]["layout"],
                                degrees)
    assert sorted(got) == sorted(params)
    for name in params:
        np.testing.assert_allclose(got[name], params[name], err_msg=name, **TOL)


ZERO3_NO_DP = {"mp": 2, "sharding": 4}


@pytest.mark.parametrize("stage,degrees", [(1, DEGREES), (2, DEGREES), (3, DEGREES),
                                           (3, ZERO3_NO_DP)],
                         ids=["1", "2", "3", "3-mp2sharding4"])
def test_hybrid_gpt_step_matches_jax_fleet(pool8, stage, degrees):
    """dp2 x mp2 x sharding2 at ZeRO ``stage`` (and ZeRO-3 as mp2 x
    sharding4, no dp axis): 3 steps' losses, every parameter gathered by
    ``convert.gather_arrays``, and each rank's moment shards equal to the
    JAX moments' slices on the dims ``_state_spec`` picks (they move
    through the same AdamW rule; the JAX moments are global arrays)."""
    batches = _batches()
    jax_out = _jax_run(stage, batches, degrees=degrees)
    weights, _, _, moments = jax_out
    port = pool8.run("gpt_step", degrees=degrees, stage=stage, cfg=CFG, weights=weights,
                     batches=batches, lr=LR, moments=moments)
    _check(jax_out, port, degrees)
    for r in port:
        assert r["moments_checked"] > 0
        assert r["moment_diff"] <= 1e-5
    # each rank keeps 1/sharding of every moment the sharding degree
    # divides; at stage 3 of every such parameter too
    n_sh = degrees["sharding"]
    full = {n: v.size for n, v in weights.items()}
    layout = port[0]["layout"]
    for n, size in port[0]["moment_numel"].items():
        mp = 2 if layout[n][0] is not None else 1
        assert size in (full[n] // mp // n_sh, full[n] // mp), n
    assert sum(port[0]["moment_numel"].values()) < sum(full.values()) // 2 + 64 * 8
    if stage == 3:
        cut = [n for n in layout if layout[n][1] is not None]
        assert cut, "ZeRO-3 cut no parameter"
        for n in cut:
            mp = 2 if layout[n][0] is not None else 1
            assert port[0]["sizes"][n] == full[n] // mp // n_sh


def test_gradient_merge_and_global_norm_clip_match_jax(pool8):
    """strategy.gradient_merge (k 2: the global batch in two microbatches)
    and ClipGradByGlobalNorm over the logical parameter set (an mp shard's
    squares summed over mp, a ZeRO-2 shard's over sharding), against the
    JAX step with the same strategy. The clip norm is under the gradients'
    norm, so it scales every step."""
    batches = _batches(seed=12)
    jax_out = _jax_run(2, batches, clip=0.05, k_steps=2)
    port = pool8.run("gpt_step", degrees=DEGREES, stage=2, cfg=CFG, weights=jax_out[0],
                     batches=batches, lr=LR, clip=0.05, k_steps=2)
    _check(jax_out, port)


# ---------------------------------------------------------------------------
# DataParallel, LocalSGD and DGC: a Linear(6, 3) with MSE, weights from numpy
# ---------------------------------------------------------------------------
LIN_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pool2(tmp_path_factory):
    pool = RankPool(2, tmp_path_factory.mktemp("ranks2"))
    yield pool
    pool.close()


def _lin_weights(seed=21):
    rng = np.random.default_rng(seed)
    return {"weight": rng.standard_normal((6, 3)).astype(np.float32) * 0.5,
            "bias": rng.standard_normal(3).astype(np.float32) * 0.1}


def _grads_np(w, x, y):
    """The MSE (mean over every element) gradients of x @ W + b against y."""
    err = x @ w["weight"] + w["bias"] - y
    scale = 2.0 / err.size
    return {"weight": x.T @ err * scale, "bias": err.sum(0) * scale}


def _data(world, rows=4, seed=22):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((world, rows, 6)).astype(np.float32)
    y = rng.standard_normal((world, rows, 3)).astype(np.float32)
    return x, y


def test_data_parallel_averages_gradients_like_the_jax_full_batch_step(pool2):
    """DataParallel over 2 ranks, each on half the rows, against the JAX
    Linear's SGD step on the whole batch; ``no_sync`` accumulates without
    averaging, the next backward averages the accumulated gradients;
    ``state_dict`` keeps the wrapped layer's keys."""
    w = _lin_weights()
    x, y = _data(1, rows=8)
    x, y = x[0], y[0]
    with use_mesh(None):
        lin = paddle.nn.Linear(6, 3)
        lin.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
        dp = paddle.DataParallel(lin)
        opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=dp.parameters())
        paddle.nn.functional.mse_loss(dp(paddle.to_tensor(x)), paddle.to_tensor(y)).backward()
        opt.step()
        want = {n: np.asarray(p.numpy()) for n, p in lin.named_parameters()}
    got = pool2.run("data_parallel", weights=w, x=x, y=y, lr=0.1)
    for r in got:
        assert r["keys"]
        for n in want:
            np.testing.assert_allclose(r["params"][n], want[n], err_msg=n, **LIN_TOL)
    for n in want:
        # under no_sync each rank keeps its own gradient
        assert not np.allclose(got[0]["local"][n], got[1]["local"][n])
        mean = np.mean([r["local"][n] + r["second"][n] for r in got], axis=0)
        for r in got:
            np.testing.assert_allclose(r["synced"][n], mean, err_msg=n, **LIN_TOL)


def _local_sgd_np(w, x, y, lr, k, steps):
    ranks = [dict((n, v.copy()) for n, v in w.items()) for _ in range(len(x))]
    out = []
    for s in range(1, steps + 1):
        for r, p in enumerate(ranks):
            g = _grads_np(p, x[r], y[r])
            for n in p:
                p[n] = p[n] - lr * g[n]
        if s % k == 0:
            avg = {n: np.mean([p[n] for p in ranks], axis=0) for n in w}
            ranks = [dict((n, v.copy()) for n, v in avg.items()) for _ in ranks]
        out.append([dict(p) for p in ranks])
    return out


def test_local_sgd_at_world_2_matches_numpy(pool2):
    """LocalSGD(k 2): each rank steps on its own data, the parameters are
    averaged over the two every second step (numpy's rule)."""
    w = _lin_weights()
    x, y = _data(2)
    got = pool2.run("local_sgd", weights=w, x=x, y=y, lr=0.1, k=2, steps=4)
    want = _local_sgd_np(w, x, y, 0.1, 2, 4)
    for s in range(4):
        for r in range(2):
            for n in w:
                np.testing.assert_allclose(got[r][s][n], want[s][r][n],
                                           err_msg=f"step {s} rank {r} {n}", **LIN_TOL)
    # averaged on even steps: the replicas agree there and not in between
    assert np.allclose(got[0][1]["weight"], got[1][1]["weight"])
    assert not np.allclose(got[0][0]["weight"], got[1][0]["weight"])


def _dgc_np(w, x, y, lr, mu, drop, begin, steps):
    world = len(x)
    p = {n: v.copy() for n, v in w.items()}
    u = [{n: np.zeros_like(v) for n, v in w.items()} for _ in range(world)]
    v = [{n: np.zeros_like(v) for n, v in w.items()} for _ in range(world)]
    out = []
    for s in range(1, steps + 1):
        upd = {n: np.zeros(w[n].size, np.float32) for n in w}
        for r in range(world):
            g = _grads_np(p, x[r], y[r])
            for n in w:
                u[r][n] = mu * u[r][n] + g[n]
                v[r][n] = v[r][n] + u[r][n]
                flat = v[r][n].reshape(-1)
                if s <= begin:
                    upd[n] += flat / world
                    v[r][n] = np.zeros_like(v[r][n])
                else:
                    kk = max(1, flat.size - int(drop * flat.size))
                    idx = np.argsort(-np.abs(flat), kind="stable")[:kk]
                    upd[n][idx] += flat[idx] / world
                    flat = flat.copy()
                    flat[idx] = 0.0
                    v[r][n] = flat.reshape(w[n].shape)
                    uf = u[r][n].reshape(-1).copy()
                    uf[idx] = 0.0
                    u[r][n] = uf.reshape(w[n].shape)
        for n in w:
            p[n] = p[n] - lr * upd[n].reshape(w[n].shape)
        out.append({n: val.copy() for n, val in p.items()})
    return out


def test_dgc_at_world_2_matches_numpy(pool2):
    """DGC momentum over 2 ranks: a dense warm-up step, then top-k (half)
    of each rank's residual exchanged, scatter-added and averaged, the sent
    coordinates' momentum cleared (numpy's rule); the replicas stay equal."""
    w = _lin_weights()
    x, y = _data(2)
    got = pool2.run("dgc", weights=w, x=x, y=y, lr=0.05, momentum=0.9, sparsity=[0.5],
                    rampup_begin_step=1, steps=4)
    want = _dgc_np(w, x, y, 0.05, 0.9, 0.5, 1, 4)
    for s in range(4):
        for r in range(2):
            for n in w:
                np.testing.assert_allclose(got[r][s][n], want[s][n],
                                           err_msg=f"step {s} rank {r} {n}", **LIN_TOL)


@pytest.mark.parametrize("which", ["localsgd", "dgc"])
def test_local_sgd_and_dgc_at_world_1_match_jax(which):
    """At world 1 (no process group) against the JAX optimizers in this
    process: LocalSGD is its inner SGD; DGC's dense and sparse steps."""
    import paddle_tpu_torch as pt

    w = _lin_weights()
    x, y = _data(1)
    pt.set_device("cpu")
    try:
        tl = pt.nn.Linear(6, 3)
        convert.state_dict_from_numpy(tl, w)
        with use_mesh(None):
            jl = paddle.nn.Linear(6, 3)
            jl.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
            if which == "localsgd":
                jopt = jfleet.LocalSGDOptimizer(paddle.optimizer.SGD(
                    learning_rate=0.1, parameters=jl.parameters()), k_steps=2)
                topt = pt.distributed.fleet.LocalSGDOptimizer(pt.optimizer.SGD(
                    learning_rate=0.1, parameters=tl.parameters()), k_steps=2)
            else:
                kw = dict(learning_rate=0.05, momentum=0.9, sparsity=[0.5],
                          rampup_begin_step=1)
                jopt = jfleet.DGCMomentumOptimizer(parameters=jl.parameters(), **kw)
                topt = pt.distributed.fleet.DGCMomentumOptimizer(parameters=tl.parameters(),
                                                                 **kw)
            for _ in range(3):
                paddle.nn.functional.mse_loss(jl(paddle.to_tensor(x[0])),
                                              paddle.to_tensor(y[0])).backward()
                jopt.step()
                jopt.clear_grad()
                pt.nn.functional.mse_loss(tl(torch.as_tensor(x[0])),
                                          torch.as_tensor(y[0])).backward()
                topt.step()
                topt.clear_grad()
            for n, p in tl.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(dict(jl.named_parameters())[n].numpy()),
                                           err_msg=n, **LIN_TOL)
    finally:
        pt.set_device("gpu:0")


def test_group_sharded_model_saves_the_whole_state_in_the_jax_format(pool8, tmp_path):
    """``group_sharded_parallel(level="p_g_os")`` cuts the parameters (ZeRO-3
    over sharding 2, beside mp 2), and ``save_group_sharded_model`` gathers
    them over sharding and mp and writes, from rank 0, a file the JAX
    package's ``paddle.load`` reads back as the global weights, exactly."""
    jax_out = _jax_run(2, _batches(n=1))
    weights = jax_out[0]
    sizes = pool8.run("group_sharded_save", degrees=DEGREES, cfg=CFG, weights=weights,
                      out_dir=str(tmp_path))
    assert sum(sizes[0].values()) < sum(v.size for v in weights.values()) // 2
    got = paddle.load(str(tmp_path / "model.pdparams"))
    assert sorted(got) == sorted(weights)
    for name, w in weights.items():
        np.testing.assert_array_equal(np.asarray(got[name].numpy()), w, err_msg=name)
    assert (tmp_path / "model.pdopt").exists()
