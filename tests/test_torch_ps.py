"""The port's parameter-server tables and service against the JAX package's.

Both packages bind the same C++ (the port keeps its own copy under
``paddle_tpu_torch/distributed/ps/csrc`` and builds it into
``paddle_tpu_torch/_build``), so from the same seed the tables are held
BITWISE: pulls, pushes under SGD, AdaGrad and Adam, the CTR accessor,
shrink, save and load, SSD overflow, graph sampling. The service runs over
local TCP after ``tests/test_ps_service.py`` without ``fleet``: every server
is stopped in a ``finally`` and every call on the wire runs under its own
timeout (``_within``). ``SparseEmbedding`` is held against the JAX
package's pure-dense twin (``tests/test_ernie_ctr.py:30-95``: an
``nn.Embedding`` under Adagrad) with that test's tolerances: losses rtol
1e-5, rows rtol 1e-4 / atol 1e-6.
"""
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.ps as jps
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed.ps as tps
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.distributed.ps import service as tservice

WIRE_TIMEOUT_S = 60


@pytest.fixture(scope="module", autouse=True)
def _built():
    """Build the six libraries (three of each package) at once."""
    from paddle_tpu.distributed.ps import service as jservice

    loaders = (tps._load_lib, tservice._load_server_lib, tservice._load_client_lib,
               jps._load_lib, jservice._load_server_lib, jservice._load_client_lib)
    errors = []

    def one(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(fn,)) for fn in loaders]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    pt.set_device("cpu")


def _within(fn, *args, timeout=WIRE_TIMEOUT_S):
    """``fn(*args)`` in a thread joined with a timeout: a hung wire call fails
    the test instead of the suite (ctypes releases the GIL)."""
    out, errors = [], []

    def run():
        try:
            out.append(fn(*args))
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{getattr(fn, '__name__', fn)} did not return in {timeout} s"
    if errors:
        raise errors[0]
    return out[0] if out else None


def test_the_port_builds_its_own_libraries_apart_from_the_reference():
    build = os.path.join(os.path.dirname(pt.__file__), "_build")
    mine = [tps._load_lib()._name, tservice._load_server_lib()._name,
            tservice._load_client_lib()._name]
    from paddle_tpu.distributed.ps import service as jservice

    theirs = [jps._load_lib()._name, jservice._load_server_lib()._name,
              jservice._load_client_lib()._name]
    for path in mine:
        assert os.path.dirname(path) == build and os.path.isfile(path)
    assert not set(mine) & set(theirs)
    assert pt.utils.cpp_extension.get_build_directory() == build


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_table_pull_and_push_are_bitwise_the_reference(optimizer):
    kw = dict(shard_num=7, optimizer=optimizer, learning_rate=0.05, init_range=0.1, seed=42)
    a, b = tps.MemorySparseTable(8, **kw), jps.MemorySparseTable(8, **kw)
    rng = np.random.default_rng(0)
    keys = rng.integers(-1000, 10_000_000, 3000)
    np.testing.assert_array_equal(a.pull(keys), b.pull(keys))
    for _ in range(3):
        g = rng.standard_normal((keys.size, 8)).astype(np.float32)
        a.push(keys, g)
        b.push(keys, g)
    probe = np.concatenate([keys[:500], rng.integers(0, 100, 50)])
    np.testing.assert_array_equal(a.pull(probe, create=False), b.pull(probe, create=False))
    a.push_raw(keys[:10], np.ones((10, 8), np.float32))
    b.push_raw(keys[:10], np.ones((10, 8), np.float32))
    a.set_lr(0.5)
    b.set_lr(0.5)
    a.push(keys[:10], np.ones((10, 8), np.float32))
    b.push(keys[:10], np.ones((10, 8), np.float32))
    np.testing.assert_array_equal(a.pull(keys), b.pull(keys))
    assert len(a) == len(b) == a.ram_size()


def _ctr():
    return dict(show_coeff=0.25, click_coeff=1.0, decay_rate=0.9, delete_threshold=0.8,
                delete_after_unseen_days=3)


def test_ctr_accessor_and_shrink_are_bitwise_the_reference():
    tables = [mod.MemorySparseTable(4, optimizer="sgd", learning_rate=0.1, init_range=0.05,
                                    seed=3, ctr=mod.CtrAccessorConfig(**_ctr()))
              for mod in (tps, jps)]
    rng = np.random.default_rng(1)
    for day in range(5):
        keys = rng.integers(0, 60, 40)
        shows = rng.integers(1, 4, 40).astype(np.float32)
        clicks = (rng.random(40) < 0.3).astype(np.float32)
        grads = rng.standard_normal((40, 4)).astype(np.float32)
        for t in tables:
            t.push_ctr(keys, shows, clicks, grads)
        assert tables[0].shrink() == tables[1].shrink(), day
        assert len(tables[0]) == len(tables[1])
    for key in range(60):
        assert tables[0].ctr_stats(key) == tables[1].ctr_stats(key)
    keys = np.arange(60)
    np.testing.assert_array_equal(tables[0].pull(keys, create=False),
                                  tables[1].pull(keys, create=False))


def test_save_and_load_are_the_reference_format(tmp_path):
    kw = dict(shard_num=4, optimizer="adagrad", learning_rate=0.1, init_range=0.05, seed=1)
    a, b = tps.MemorySparseTable(4, **kw), jps.MemorySparseTable(4, **kw)
    keys = np.arange(100)
    g = np.random.default_rng(0).standard_normal((100, 4)).astype(np.float32)
    for t in (a, b):
        t.pull(keys)
        t.push(keys, g)
    a.save(str(tmp_path / "port.sparse"))
    b.save(str(tmp_path / "ref.sparse"))
    assert (tmp_path / "port.sparse").read_bytes() == (tmp_path / "ref.sparse").read_bytes()
    c = tps.MemorySparseTable(4, **kw)
    c.load(str(tmp_path / "ref.sparse"))  # the port reads the reference's file
    assert len(c) == 100
    np.testing.assert_array_equal(c.pull(keys), b.pull(keys))
    # the AdaGrad accumulators came along: one more push stays bitwise
    c.push(keys, g)
    b.push(keys, g)
    np.testing.assert_array_equal(c.pull(keys), b.pull(keys))
    with pytest.raises(IOError):
        c.load(str(tmp_path / "missing.sparse"))


def test_ssd_overflow_is_bitwise_the_reference(tmp_path):
    kw = dict(shard_num=4, optimizer="adagrad", learning_rate=0.05, init_range=0.05, seed=2,
              ram_budget=32)
    a = tps.MemorySparseTable(8, ssd_path=str(tmp_path / "port.bin"), **kw)
    b = jps.MemorySparseTable(8, ssd_path=str(tmp_path / "ref.bin"), **kw)
    rng = np.random.default_rng(4)
    for _ in range(4):
        keys = rng.integers(0, 400, 64)
        g = rng.standard_normal((64, 8)).astype(np.float32)
        np.testing.assert_array_equal(a.pull(keys), b.pull(keys))
        a.push(keys, g)
        b.push(keys, g)
    assert a.disk_size() == b.disk_size() > 0
    assert a.ram_size() == b.ram_size() <= 2 * 32
    keys = np.arange(400)
    np.testing.assert_array_equal(a.pull(keys, create=False), b.pull(keys, create=False))
    with pytest.raises(ValueError, match="ram_budget"):
        tps.MemorySparseTable(8, ssd_path=str(tmp_path / "x.bin"))


def _graph(mod):
    g = mod.GraphTable(shard_num=8, feat_dim=3, seed=5)
    rng = np.random.default_rng(6)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    g.add_edges(src, dst, weights=rng.random(400).astype(np.float32) + 0.1)
    g.set_node_feat(np.arange(50), rng.standard_normal((50, 3)).astype(np.float32))
    return g


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "weighted"])
def test_graph_sampling_and_features_are_the_reference(weighted, tmp_path):
    a, b = _graph(tps), _graph(jps)
    assert (a.node_count(), a.edge_count()) == (b.node_count(), b.edge_count())
    assert [a.degree(n) for n in range(52)] == [b.degree(n) for n in range(52)]
    ids = np.array([0, 3, 7, 49, 999])
    for k in (2, 5, 64):
        na, ca = a.sample_neighbors(ids, k, weighted=weighted)
        nb, cb = b.sample_neighbors(ids, k, weighted=weighted)
        np.testing.assert_array_equal(na, nb)
        np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(a.random_sample_nodes(20), b.random_sample_nodes(20))
    np.testing.assert_array_equal(a.get_node_feat([3, 1, 500]), b.get_node_feat([3, 1, 500]))
    a.save(str(tmp_path / "g.bin"))
    c = tps.GraphTable(shard_num=8, feat_dim=3, seed=5)
    c.load(str(tmp_path / "g.bin"))
    assert (c.node_count(), c.edge_count()) == (a.node_count(), a.edge_count())
    np.testing.assert_array_equal(c.get_node_feat(np.arange(50)), a.get_node_feat(np.arange(50)))


@pytest.fixture(scope="module")
def fleet2():
    """Two port servers and two clients over local TCP."""
    s0 = tps.PsServer(port=0, server_id=0, n_servers=2, n_trainers=2)
    s1 = tps.PsServer(port=0, server_id=1, n_servers=2, n_trainers=2)
    eps = [f"127.0.0.1:{s0.port}", f"127.0.0.1:{s1.port}"]
    c0 = tps.PsClient(eps, trainer_id=0)
    c1 = tps.PsClient(eps, trainer_id=1)
    try:
        _within(c0.ping)
        yield s0, s1, c0, c1
    finally:
        _within(c0.stop_servers)


def test_wire_table_is_bitwise_the_reference_local_table(fleet2):
    _, _, c0, _ = fleet2
    wire = _within(tps.DistributedSparseTable, c0, 1, 8, 16, "sgd", 0.1, 0.01, 42)
    local = jps.MemorySparseTable(8, optimizer="sgd", learning_rate=0.1, seed=42)
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1_000_000, 20_000)  # several 8192-key chunks per server
    np.testing.assert_array_equal(_within(wire.pull, keys), local.pull(keys))
    uk, inv = np.unique(keys, return_inverse=True)
    g = np.zeros((uk.size, 8), np.float32)
    np.add.at(g, inv, rng.standard_normal((keys.size, 8)).astype(np.float32))
    _within(wire.push, uk, g)
    local.push(uk, g)
    np.testing.assert_array_equal(_within(wire.pull, keys), local.pull(keys))
    assert _within(len, wire) == len(local)
    miss = _within(wire.pull, np.array([-424242]), False)
    assert np.all(miss == 0) and _within(len, wire) == len(local)


def test_wire_dense_tables_and_handle_copy_in_place(fleet2):
    _, _, c0, _ = fleet2
    init = np.arange(10, dtype=np.float32)
    _within(c0.create_dense_table, 50, 10, "sgd", 0.5, init)
    _within(c0.push_dense, 50, np.ones(10, np.float32))
    np.testing.assert_allclose(_within(c0.pull_dense, 50), init - 0.5)
    # DenseTableHandle over the port's parameters: the values come back into
    # the same storage (a captured step keeps its data_ptr()s)
    lin = pt.nn.Linear(3, 2)
    ptrs = [p.data_ptr() for p in lin.parameters()]
    h = tps.DenseTableHandle(c0, 51, list(lin.parameters()), "sgd", 1.0)
    _within(h.init, True)
    before = [p.detach().clone() for p in lin.parameters()]
    _within(h.push_pull, [torch.ones(p.shape) for p in lin.parameters()])
    for p, b0, ptr in zip(lin.parameters(), before, ptrs):
        assert p.data_ptr() == ptr
        torch.testing.assert_close(p.detach(), b0 - 1.0, rtol=0, atol=0)
    _within(h.push, [torch.ones(p.shape) for p in lin.parameters()])
    _within(h.pull_into_params)
    for p, b0 in zip(lin.parameters(), before):  # two f32 SGD steps, as the server rounds
        torch.testing.assert_close(p.detach(), (b0 - 1.0) - 1.0, rtol=0, atol=0)


def test_wire_barrier_geo_replicas_and_async_communicator(fleet2):
    _, _, c0, c1 = fleet2
    done = []
    threads = [threading.Thread(target=lambda c=c: (c.barrier(), done.append(c)), daemon=True)
               for c in (c0, c1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WIRE_TIMEOUT_S)
    assert len(done) == 2  # both released, neither hung
    g0 = _within(lambda: tps.GeoDistributedSparseTable(
        c0, 9, 4, optimizer="sgd", learning_rate=1.0, init_range=0.0, geo_steps=2, seed=0))
    g1 = _within(lambda: tps.GeoDistributedSparseTable(
        c1, 9, 4, optimizer="sgd", learning_rate=1.0, init_range=0.0, geo_steps=2, seed=0,
        create=False))
    keys = np.array([11, 22])
    one = np.ones((2, 4), np.float32)
    for g in (g0, g1):
        _within(g.pull, keys)
        _within(g.push, keys, one)
        _within(g.push, keys, one)  # the second push syncs: raw deltas added server-side
    _within(g0.refresh, keys)
    _within(g1.refresh, keys)
    np.testing.assert_array_equal(_within(g0.pull, keys), _within(g1.pull, keys))
    np.testing.assert_allclose(_within(g0.pull, keys), -4.0)
    t = _within(tps.DistributedSparseTable, c0, 12, 4, 16, "sgd", 1.0, 0.0)
    comm = tps.Communicator(t, mode="async")
    try:
        _within(t.pull, np.array([5]))
        for _ in range(10):
            comm.push(np.array([5]), np.ones((1, 4), np.float32))
        _within(comm.flush)
        np.testing.assert_allclose(_within(t.pull, np.array([5])), -10.0)
    finally:
        _within(comm.stop)


def test_kv_lease_verbs_over_the_wire():
    srv = tps.PsServer(port=0, server_id=0, n_servers=1, n_trainers=0)
    c = tps.PsClient([f"127.0.0.1:{srv.port}"])
    try:
        _within(c.kv_put, "plain/a", "x" * 100)
        _within(c.kv_lease, "lease/b", "v1", 5.0)
        assert _within(c.kv_get, "plain/a") == "x" * 100
        assert _within(c.kv_alive, "lease/") == {"lease/b": "v1"}
        _within(c.kv_del, "plain/a")
        assert _within(c.kv_get, "plain/a") is None
    finally:
        _within(srv.stop)


def test_sparse_pipeline_prefetches_and_flushes():
    t = tps.MemorySparseTable(4, shard_num=4, init_range=0.05, seed=1)
    pipe = tps.SparsePipeline(t)
    try:
        keys = np.arange(32)
        rows = _within(lambda: pipe.prefetch(keys).result())
        assert rows.shape == (32, 4)
        pipe.push_async(keys, np.ones((32, 4), np.float32))
        _within(pipe.flush)
        assert not np.allclose(t.pull(keys), rows)  # the push landed by flush()
    finally:
        _within(pipe.stop)


class _JHead(paddle.nn.Layer):
    def __init__(self, dim):
        super().__init__()
        self.fc = paddle.nn.Linear(dim, 1)

    def forward(self, rows):
        return self.fc(rows.mean(axis=1)).squeeze(-1)


class _THead(pt.nn.Layer):
    def __init__(self, dim):
        super().__init__()
        self.fc = pt.nn.Linear(dim, 1)

    def forward(self, rows):
        return self.fc(rows.mean(axis=1)).squeeze(-1)


def test_sparse_embedding_tracks_the_reference_dense_twin():
    """The port's PS path (pull, dense step, push with the C++ AdaGrad)
    against the JAX package's pure-dense twin (``nn.Embedding`` + Adagrad
    with the table's epsilon), step for step. Batches use unique ids:
    duplicate keys apply per occurrence in the table and summed in dense
    autograd."""
    dim, n_ids, batch, lr = 8, 64, 8, 0.05
    table = tps.MemorySparseTable(dim, shard_num=4, optimizer="adagrad", learning_rate=lr,
                                  init_range=0.05, seed=9)
    semb = tps.SparseEmbedding([n_ids, dim], table=table)
    paddle.seed(1)
    head_b = _JHead(dim)
    head_a = _THead(dim)
    state_dict_from_numpy(head_a, {k: np.asarray(v.numpy())
                                   for k, v in head_b.state_dict().items()})
    opt_a = pt.optimizer.SGD(learning_rate=0.1, parameters=head_a.parameters())
    demb = paddle.nn.Embedding(n_ids, dim)
    demb.weight.set_value(paddle.to_tensor(table.pull(np.arange(n_ids)).copy()))
    opt_b = paddle.optimizer.SGD(learning_rate=0.1, parameters=head_b.parameters())
    opt_emb = paddle.optimizer.Adagrad(learning_rate=lr, epsilon=1e-6,
                                       parameters=[demb.weight])
    rng = np.random.default_rng(3)
    for step in range(5):
        ids = rng.permutation(n_ids)[:batch * 4].reshape(batch, 4)
        y = (ids[:, 0] % 2).astype(np.float32)
        la = pt.nn.functional.binary_cross_entropy_with_logits(
            head_a(semb(pt.to_tensor(ids))), pt.to_tensor(y))
        la.backward()
        opt_a.step()
        opt_a.clear_grad()
        lb = paddle.nn.functional.binary_cross_entropy_with_logits(
            head_b(demb(paddle.to_tensor(ids))), paddle.to_tensor(y))
        lb.backward()
        opt_b.step()
        opt_emb.step()
        opt_b.clear_grad()
        opt_emb.clear_grad()
        np.testing.assert_allclose(float(la), float(lb), rtol=1e-5, err_msg=f"step {step}")
    np.testing.assert_allclose(table.pull(np.arange(n_ids)), demb.weight.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_sparse_embedding_merges_duplicates_and_pads_as_the_reference():
    """Duplicate ids merged before one push, ``padding_idx`` rows zero and
    never pushed, eval mode pulls without making rows: bitwise the JAX
    layer's tables after the same steps, where both heads are fixed."""
    tables = [mod.MemorySparseTable(4, shard_num=2, optimizer="adagrad", learning_rate=0.1,
                                    init_range=0.05, seed=7) for mod in (tps, jps)]
    a = tps.SparseEmbedding([50, 4], table=tables[0], padding_idx=0)
    b = jps.SparseEmbedding([50, 4], table=tables[1], padding_idx=0)
    rng = np.random.default_rng(2)
    w = rng.standard_normal((4,)).astype(np.float32)
    for _ in range(3):
        ids = rng.integers(0, 10, (6, 5))
        ids[0, 0] = 0
        ra = a(pt.to_tensor(ids))
        assert ra.shape == [6, 5, 4] and not ra.stop_gradient
        np.testing.assert_array_equal(ra.numpy()[0, 0], np.zeros(4))
        (ra * pt.to_tensor(w)).sum().backward()
        rb = b(paddle.to_tensor(ids))
        (rb * paddle.to_tensor(w)).sum().backward()
        np.testing.assert_array_equal(ra.numpy(), rb.numpy())
    keys = np.arange(10)
    np.testing.assert_array_equal(tables[0].pull(keys, create=False),
                                  tables[1].pull(keys, create=False))
    a.eval()
    n = len(tables[0])
    out = a(pt.to_tensor(np.array([[40, 41]])))
    assert out.stop_gradient and len(tables[0]) == n
    np.testing.assert_array_equal(out.numpy(), np.zeros((1, 2, 4)))


def test_sparse_embedding_is_never_deferred_under_lazy_dispatch():
    """Under lazy dispatch the pull's host read of the ids ends the pending
    segment and runs at once, and the whole-step capture never arms over it:
    every step pushes, as per-op does."""
    from paddle_tpu_torch.core import lazy

    def run(lazy_on, capture):
        lazy.reset_lazy_state()
        pt.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on, "FLAGS_eager_step_capture": capture})
        try:
            table = tps.MemorySparseTable(4, shard_num=2, optimizer="sgd", learning_rate=0.1,
                                          init_range=0.05, seed=1)
            emb = tps.SparseEmbedding([10, 4], table=table)
            head = pt.nn.Linear(4, 1)
            head.weight.set_value(np.ones((4, 1), np.float32))
            head.bias.set_value(np.zeros(1, np.float32))
            opt = pt.optimizer.SGD(learning_rate=0.1, parameters=head.parameters())
            ids = pt.to_tensor(np.array([[1, 2], [3, 1]]))
            losses = []
            for _ in range(6):
                loss = (head(emb(ids)) ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
            return losses, table.pull(np.array([1, 2, 3]))
        finally:
            pt.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_eager_step_capture": False})

    per_op = run(False, False)
    for lazy_on, capture in ((True, False), (True, True)):
        got = run(lazy_on, capture)
        assert got[0] == per_op[0]
        np.testing.assert_array_equal(got[1], per_op[1])
    assert pt.profiler.dispatch_counters()["capture_builds"] == 0
    lazy.reset_lazy_state()


def test_the_one_ps_runtime_waits_for_fleet():
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        tps.TheOnePSRuntime()
