"""The port's collectives, topology and tensor-parallel layers against numpy
and the JAX package, on the CPU.

The port's ranks are pools of processes (tests/torch_dist_pool.py) at worlds
2, 4 and 8, joined over gloo; each imports the port alone. The JAX side
runs in this process: its ``dist.*`` collectives inside ``shard_map`` over a
mesh of that many of the 8 virtual CPU devices (as tests/test_distributed.py
runs them), its topology objects directly, its tensor-parallel layers
unsharded (what GSPMD's partitioned program computes). Each rank's input is
``torch_dist_cases.rank_inputs(seed, rank, shape)``.

Tolerances: a collective that moves values is exact; a reduction sums in
its own order, 1e-6 against numpy's and the JAX one's. The tensor-parallel
layers are held to tests/test_distributed.py:119's 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu._jax_compat import shard_map
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.parallel.topology import CommunicateTopology, HybridCommunicateGroup, use_mesh
from paddle_tpu_torch import convert
from tests.torch_dist_cases import rank_inputs
from tests.torch_dist_pool import RankPool

SEED = 5
SHAPE = (8, 3)
TOL_SUM = dict(rtol=1e-6, atol=1e-6)
TOL_TP = dict(rtol=1e-5, atol=1e-5)

_pools = {}


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    def get(world):
        if world not in _pools:
            _pools[world] = RankPool(world, tmp_path_factory.mktemp(f"ranks{world}"))
        return _pools[world]

    yield get
    for pool in _pools.values():
        pool.close()
    _pools.clear()


def _want(world):
    """numpy's result of every case of ``torch_dist_cases.collectives``, per rank."""
    xs = [rank_inputs(SEED, r, SHAPE) for r in range(world)]
    stack = np.stack(xs)
    total = stack.sum(0)
    out = []
    for r in range(world):
        w = {
            "all_reduce_sum": total, "all_reduce_max": stack.max(0),
            "all_reduce_min": stack.min(0), "all_reduce_prod": stack.prod(0),
            "all_reduce_avg": stack.mean(0), "all_reduce_tensor": total,
            "all_gather": stack, "broadcast": xs[-1],
            "reduce": total if r == 0 else xs[r],
            "scatter": rank_inputs(SEED, 100 + r, SHAPE),
            "reduce_scatter": np.split(total, world)[r],
            "alltoall": np.stack([np.split(xs[i], world)[r] for i in range(world)]),
            "alltoall_single": np.concatenate([np.split(xs[i], world)[r]
                                               for i in range(world)]),
            "shift": xs[r - 1] if r else np.zeros(SHAPE, np.float32),
            "shift_wrap": xs[(r - 1) % world],
            "ppermute": xs[world - 1 - r],
            "send_recv": xs[0] if r == world - 1 else xs[r],
            "isend_irecv": xs[r - 1] if r % 2 else xs[r],
            "subgroup_sum": stack[::2].sum(0) if r % 2 == 0 else xs[r],
        }
        out.append(w)
    return out


def _jax_collectives(world):
    """The JAX ``dist.*`` collectives inside ``shard_map`` over ``world``
    devices: {case: per-rank results}."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("x",))
    grp = jdist.Group(list(range(world)), axis_name="x")
    stacked = jnp.asarray(np.stack([rank_inputs(SEED, r, SHAPE) for r in range(world)]))
    parts = jnp.asarray(np.stack([rank_inputs(SEED, 100 + i, SHAPE) for i in range(world)]))

    def run(body, extra=()):
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x"),) + (P(),) * len(extra),
                               out_specs=P("x")))
        return np.asarray(fn(stacked, *extra))

    def t(v):
        return paddle.Tensor(v[0], stop_gradient=True)

    out = {}
    for name, op in (("sum", jdist.ReduceOp.SUM), ("max", jdist.ReduceOp.MAX),
                     ("min", jdist.ReduceOp.MIN), ("avg", jdist.ReduceOp.AVG)):
        def reduce_body(v, op=op):
            x = t(v)
            jdist.all_reduce(x, op, group=grp)
            return x._value[None]
        out[f"all_reduce_{name}"] = run(reduce_body)
    out["all_gather"] = run(lambda v: jdist.all_gather([], t(v), group=grp)._value[None])

    def bcast(v):
        x = t(v)
        jdist.broadcast(x, src=world - 1, group=grp)
        return x._value[None]
    out["broadcast"] = run(bcast)

    def scatter(v, p):
        x = t(v)
        jdist.scatter(x, [paddle.Tensor(p[i]) for i in range(world)], src=0, group=grp)
        return x._value[None]
    out["scatter"] = run(scatter, (parts,))

    def rs(v):
        x = paddle.Tensor(jnp.zeros((SHAPE[0] // world,) + SHAPE[1:]), stop_gradient=True)
        jdist.reduce_scatter(x, t(v), group=grp)
        return x._value[None]
    out["reduce_scatter"] = run(rs)
    out["alltoall"] = run(lambda v: jnp.stack(
        [o._value for o in jdist.alltoall(list(t(v).split(world, axis=0)), group=grp)])[None])
    out["alltoall_single"] = run(lambda v: jdist.alltoall_single(t(v), group=grp)._value[None])
    out["shift"] = run(lambda v: jdist.shift(t(v), 1, group=grp)._value[None])
    out["shift_wrap"] = run(lambda v: jdist.shift(t(v), 1, group=grp, wrap=True)._value[None])
    out["ppermute"] = run(lambda v: jdist.ppermute(
        t(v), [(i, world - 1 - i) for i in range(world)], group=grp)._value[None])
    return out


@pytest.mark.parametrize("world", [2, 4, 8])
def test_collectives_match_numpy(pools, world):
    """Every collective over gloo at ``world`` ranks, against numpy; a
    subgroup's all-reduce leaves the ranks outside it as they were."""
    got = pools(world).run("collectives", seed=SEED, shape=SHAPE)
    for r, (g, w) in enumerate(zip(got, _want(world))):
        for case, value in w.items():
            np.testing.assert_allclose(g[case], value, err_msg=f"rank {r} {case}", **TOL_SUM)
        assert g["all_gather_object"] == [{"rank": i} for i in range(world)]
        assert g["subgroup_rank"] == (r // 2 if r % 2 == 0 else -1)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_collectives_match_jax_inside_shard_map(pools, world):
    """The same cases against the JAX collectives lowered inside shard_map
    over ``world`` of the 8 virtual devices (src and group indices agree on
    a world group)."""
    got = pools(world).run("collectives", seed=SEED, shape=SHAPE)
    want = _jax_collectives(world)
    for case, per_rank in want.items():
        for r in range(world):
            np.testing.assert_allclose(got[r][case], per_rank[r], err_msg=f"rank {r} {case}",
                                       **TOL_SUM)


DEGREES = [{"dp": 2, "mp": 4}, {"dp": 2, "mp": 2, "sharding": 2}, {"sharding": 8}]


@pytest.mark.parametrize("degrees", DEGREES, ids=["dp2mp4", "dp2mp2sharding2", "sharding8"])
def test_topology_groups_match_the_jax_hcg(pools, degrees):
    """get_comm_list of every axis and each rank's group ranks and
    coordinates equal the JAX HybridCommunicateGroup's for the same degrees."""
    got = pools(8).run("hcg_groups", degrees=degrees)
    dims = [1, degrees.get("dp", 1), degrees.get("sharding", 1), 1, degrees.get("mp", 1)]
    topo = CommunicateTopology(["pipe", "data", "sharding", "sep", "model"], dims)
    hcg = HybridCommunicateGroup(topo)
    for r, g in enumerate(got):
        hcg.global_rank = r
        assert g["data"] == hcg.get_data_parallel_group().ranks
        assert g["model"] == hcg.get_model_parallel_group().ranks
        assert g["sharding"] == hcg.get_sharding_parallel_group().ranks
        assert g["pipe"] == hcg.get_pipe_parallel_group().ranks
        assert tuple(g["coord"]) == (hcg.get_data_parallel_rank(),
                                     hcg.get_model_parallel_rank(),
                                     hcg.get_sharding_parallel_rank())
        for axis in ("model", "data", "sharding"):
            assert g[f"comm_{axis}"] == topo.get_comm_list(axis)
    # fleet.init of the JAX package gives the same degrees
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    jfleet.init(is_collective=True, strategy=strategy)
    jhcg = jfleet.get_hybrid_communicate_group()
    assert jhcg.topology().get_comm_list("model") == got[0]["comm_model"]


VOCAB, HIDDEN, FFN = 32, 16, 64


def _jax_tp(weights, ids, labels, cot):
    """The JAX layers (unsharded: the math GSPMD partitions) of
    ``torch_dist_cases.TPBlock`` on ``weights``: output, CE, gradients."""
    mp = jfleet.meta_parallel
    with use_mesh(None):
        paddle.seed(0)

        class Block(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.emb = mp.VocabParallelEmbedding(VOCAB, HIDDEN)
                self.fc1 = mp.ColumnParallelLinear(HIDDEN, FFN, gather_output=False)
                self.fc2 = mp.RowParallelLinear(FFN, HIDDEN, input_is_parallel=True)
                self.fc3 = mp.ColumnParallelLinear(HIDDEN, FFN, gather_output=True)
                self.fc4 = mp.RowParallelLinear(FFN, HIDDEN, input_is_parallel=False)
                self.ce = mp.ParallelCrossEntropy()

        m = Block()
        if weights is None:
            return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
        m.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
        F = paddle.nn.functional
        h = m.emb(paddle.to_tensor(ids))
        h = m.fc2(F.relu(m.fc1(h)))
        h = m.fc4(paddle.tanh(m.fc3(h)))
        logits = paddle.matmul(h, m.emb.weight, transpose_y=True)
        ce = m.ce(logits, paddle.to_tensor(labels)).mean()
        loss = (h * paddle.to_tensor(cot)).sum() + ce
        loss.backward()
        return {"out": h.numpy(), "ce": float(ce),
                "grads": {n: np.asarray(p.grad.numpy()) for n, p in m.named_parameters()}}


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_layers_match_jax_forward_and_gradients(pools, mp):
    """VocabParallelEmbedding, both ColumnParallelLinear forms, both
    RowParallelLinear forms and ParallelCrossEntropy over a tied head (some
    labels ignored) at mp ``mp`` (dp 4 / mp) against the JAX layers: the
    output, the CE and every gradient gathered over mp."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, VOCAB, (4, 6))
    labels = rng.integers(0, VOCAB, (4, 6))
    labels[0, :2] = -100
    cot = rng.standard_normal((4, 6, HIDDEN)).astype(np.float32)
    weights = _jax_tp(None, ids, labels, cot)
    want = _jax_tp(weights, ids, labels, cot)
    degrees = {"dp": 4 // mp, "mp": mp}
    got = pools(4).run("tp_layers", degrees=degrees, weights=weights, ids=ids, labels=labels,
                       cot=cot, vocab=VOCAB, hidden=HIDDEN, ffn=FFN)
    for r in got:
        np.testing.assert_allclose(r["out"], want["out"], **TOL_TP)
        np.testing.assert_allclose(r["ce"], want["ce"], **TOL_TP)
    grads = convert.gather_arrays([r["grads"] for r in got], got[0]["layout"], degrees)
    assert sorted(grads) == sorted(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(grads[name], g, err_msg=name, **TOL_TP)
    # every weight but the replicated biases is sharded over mp
    assert {n for n, (d, _) in got[0]["layout"].items() if d is not None} == {
        "emb.weight", "fc1.weight", "fc1.bias", "fc2.weight", "fc3.weight", "fc3.bias",
        "fc4.weight"}
