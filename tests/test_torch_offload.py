"""Host offload of the Adam moments (``paddle_tpu_torch/optimizer/offload.py``)
against the JAX package's (``tests/test_memory_plan2.py:268-476``), on the
CPU: a parked run is bitwise an unparked one, its state after 3 steps is the
JAX package's within the fused update's tolerance, ``state()`` and the
/statusz section report it, a SIGTERM resume through the checkpoint is exact,
and the whole-step capture takes its parked set from the planner's cold set.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.profiler as prof
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import lazy
from paddle_tpu_torch.distributed.checkpoint import training_state
from paddle_tpu_torch.optimizer import offload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def on_cpu():
    """The CPU for this file's tests, the caller's device after them."""
    was = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(was)


def _run(use_offload, steps=6, seed=0, lazy_on=False):
    pt.seed(seed)
    m = nn.Sequential(nn.Linear(32, 64), nn.GELU(approximate=True), nn.Linear(64, 8))
    o = pt.optimizer.Adam(learning_rate=1e-3, parameters=m.parameters())
    if use_offload:
        # a budget the CPU's copies always meet: every moment stays parked
        offload.enable(o, min_bytes=1024, overhead_pct=1e9)
    lf = nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        x = pt.to_tensor(rng.standard_normal((16, 32)).astype("float32"))
        y = pt.to_tensor(rng.integers(0, 8, (16,)).astype("int64"))
        loss = lf(m(x), y)
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(loss.numpy().copy())
    return m, o, losses


def test_offload_roundtrip_bitwise_and_exact_state():
    m0, o0, base = _run(False)
    m1, o1, offl = _run(True)
    try:
        sched = offload.scheduler_of(o1)
        assert sched is not None and sched.d2h_count > 0 and sched.h2d_count > 0
        # between steps the moments' storages are freed: their bytes are parked
        moments = [t for st in o1._accumulators.values() for t in st.values()
                   if t.dim() >= 1 and t.numel() * t.element_size() >= 1024]
        assert moments and all(t.untyped_storage().nbytes() == 0 for t in moments)
        assert sched.parked_bytes() == sum(t.numel() * t.element_size() for t in moments)
        for a, b in zip(base, offl):
            assert np.array_equal(a, b)
        for pa, pb in zip(m0.parameters(), m1.parameters()):
            assert torch.equal(pa, pb)
        # a training state reads exact moments while they are parked
        ts0, ts1 = training_state(m0, o0), training_state(m1, o1)
        keys = {k for k in ts0 if k.startswith("__opt__")}
        assert keys and keys == {k for k in ts1 if k.startswith("__opt__")}
        for k in keys:
            assert torch.equal(ts0[k], ts1[k]), k
    finally:
        offload.disable(o1)
    assert offload.scheduler_of(o1) is None
    assert all(t.untyped_storage().nbytes() > 0 for st in o1._accumulators.values()
               for t in st.values())


def test_offload_state_equals_the_jax_package_after_3_steps():
    """The JAX package's offloaded Adam and the port's, from the same weights
    and batches: parameters and moments within 1e-5 (f32 on the CPU: the two
    order the matmul sums differently, ~1e-7 relative a product, and the
    fused update differs from XLA's by an ulp, tests/test_pallas_update.py)."""
    import paddle_tpu as paddle
    from paddle_tpu.optimizer import offload as joffload
    from paddle_tpu_torch.convert import state_dict_from_numpy

    paddle.seed(0)
    jm = paddle.nn.Sequential(paddle.nn.Linear(32, 64), paddle.nn.GELU(approximate=True),
                              paddle.nn.Linear(64, 8))
    tm = nn.Sequential(nn.Linear(32, 64), nn.GELU(approximate=True), nn.Linear(64, 8))
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    jo = paddle.optimizer.Adam(learning_rate=1e-3, parameters=jm.parameters())
    to = pt.optimizer.Adam(learning_rate=1e-3, parameters=tm.parameters())
    joffload.enable(jo, min_bytes=1024, overhead_pct=1e9)
    offload.enable(to, min_bytes=1024, overhead_pct=1e9)
    rng = np.random.default_rng(0)
    try:
        for _ in range(3):
            x = rng.standard_normal((16, 32)).astype("float32")
            y = rng.integers(0, 8, (16,)).astype("int64")
            for lib, m, o in ((paddle, jm, jo), (pt, tm, to)):
                loss = lib.nn.CrossEntropyLoss()(m(lib.to_tensor(x)), lib.to_tensor(y))
                loss.backward()
                o.step()
                o.clear_grad()
        assert offload.scheduler_of(to).d2h_count > 0
        joffload.scheduler_of(jo).sync()
        to._state_sync()
        n = 0
        for p, q in zip(jm.parameters(), tm.parameters()):  # by position: names differ
            np.testing.assert_allclose(q.detach().numpy(), p.numpy(), atol=1e-5, rtol=1e-5)
            jst, tst = jo._accumulators[id(p)], to._accumulators[id(q)]
            for k in ("moment1", "moment2"):
                np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), atol=1e-5,
                                           rtol=1e-5)
                n += 1
        assert n == 8
    finally:
        joffload.disable(jo)
        offload.disable(to)


def test_offload_statusz_and_state():
    from paddle_tpu_torch.profiler.diag import statusz_text

    _m, o, _ = _run(True, steps=4)
    try:
        snaps = offload.state()
        assert any(s["steps"] >= 1 for s in snaps)
        for key in ("groups_total", "groups_selected", "cold_source", "offloaded_mb",
                    "d2h_ema_ms", "h2d_ema_ms", "blocked_ema_ms", "step_ema_ms",
                    "overhead_pct_ema", "overhead_budget_pct", "d2h_count", "h2d_count",
                    "shrinks", "regrows", "steps"):
            assert key in snaps[0], key
        txt = statusz_text()
        assert "memory plan & offload" in txt and "offload[" in txt
    finally:
        offload.disable(o)


def test_offload_overhead_budget_shrinks_the_set():
    """An overhead budget no prefetch can meet halves the parked set, the
    largest moments staying; the numerics do not change."""
    _m0, _o0, base = _run(False, steps=5)
    pt.seed(0)
    m = nn.Sequential(nn.Linear(32, 64), nn.GELU(approximate=True), nn.Linear(64, 8))
    o = pt.optimizer.Adam(learning_rate=1e-3, parameters=m.parameters())
    sched = offload.enable(o, min_bytes=1024, overhead_pct=0.0)
    lf = nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    try:
        for i in range(5):
            x = pt.to_tensor(rng.standard_normal((16, 32)).astype("float32"))
            y = pt.to_tensor(rng.integers(0, 8, (16,)).astype("int64"))
            loss = lf(m(x), y)
            loss.backward()
            o.step()
            o.clear_grad()
            assert np.array_equal(loss.numpy(), base[i])
        assert sched.shrinks >= 1
        assert sched.snapshot()["groups_selected"] < sched.snapshot()["groups_total"]
    finally:
        offload.disable(o)


RESUME = textwrap.dedent("""
    import os, signal, sys
    import numpy as np
    sys.path.insert(0, sys.argv[4])
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.checkpoint import (
        AsyncCheckpointer, train_step_range, training_state)
    from paddle_tpu_torch.optimizer import offload
    from paddle_tpu_torch.resilience import PreemptionGuard

    pt.set_device("cpu")
    ckdir, out_npz, kill_at = sys.argv[1], sys.argv[2], int(sys.argv[3])
    pt.seed(7)
    net = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.GELU(approximate=True),
                           pt.nn.Linear(16, 4))
    opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters())
    if sys.argv[5] == "1":
        offload.enable(opt, min_bytes=64)
    X = np.random.default_rng(0).standard_normal((96, 8)).astype(np.float32)
    ck = AsyncCheckpointer(ckdir)
    state = training_state(net, opt)
    for step in train_step_range(8, ck, state, save_freq=1, guard=PreemptionGuard(),
                                 optimizer=opt):
        x = pt.to_tensor(X[(step * 8) % 96:(step * 8) % 96 + 8])
        loss = (net(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        if step == kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
    offload.disable(opt)
    final = training_state(net, opt)
    np.savez(out_npz, **{k: v.detach().cpu().numpy() for k, v in final.items()
                         if hasattr(v, "detach")})
""")


def test_offload_sigterm_resume_exact(tmp_path):
    """tests/test_memory_plan2.py:437: a SIGTERM'd and resumed run with
    parked moments ends on the uninterrupted offload-free run's state,
    bitwise: every emergency save brings the moments back first, and a
    restore writes the tensors the next park copies out."""
    script = tmp_path / "run.py"
    script.write_text(RESUME)
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def launch(ckdir, out, kill_at, use_offload):
        return subprocess.run(
            [sys.executable, str(script), ckdir, out, str(kill_at), REPO,
             "1" if use_offload else "0"], capture_output=True, text=True, timeout=240,
            env=env)

    ckdir = str(tmp_path / "ck")
    first = launch(ckdir, str(tmp_path / "got.npz"), 3, True)
    assert first.returncode == 128 + 15, (first.returncode, first.stderr)
    second = launch(ckdir, str(tmp_path / "got.npz"), -1, True)
    assert second.returncode == 0, second.stderr
    want = _resume_reference()
    got = np.load(str(tmp_path / "got.npz"))
    assert sorted(want) == sorted(got.files)
    assert any(k.startswith("__opt__") for k in want)
    for k in want:
        assert np.array_equal(want[k], got[k]), k


def _resume_reference():
    """The script's run uninterrupted and without offload, in this process
    (its checkpoints change no number)."""
    pt.seed(7)
    net = nn.Sequential(nn.Linear(8, 16), nn.GELU(approximate=True), nn.Linear(16, 4))
    opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters())
    X = np.random.default_rng(0).standard_normal((96, 8)).astype(np.float32)
    for step in range(8):
        x = pt.to_tensor(X[(step * 8) % 96:(step * 8) % 96 + 8])
        loss = (net(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return {k: v.detach().cpu().numpy() for k, v in training_state(net, opt).items()
            if hasattr(v, "detach")}


@pytest.fixture
def capture_mode():
    lazy.reset_lazy_state()
    prof.reset_dispatch_counters()
    pt.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_step_capture": True})
    try:
        yield
    finally:
        lazy.flush_if_pending("test_teardown")
        pt.set_flags({"FLAGS_eager_lazy_dispatch": False})
        lazy.reset_lazy_state()
        prof.reset_dispatch_counters()  # later files read the capture counters


def test_offload_capture_path_uses_planner_cold_set(capture_mode):
    """tests/test_memory_plan2.py:318, held to what it asserts: after the
    first captured replay the parked set comes from the planner's proof
    that the moments are first read inside the update; the captured,
    offloaded run is bitwise the eager one."""
    m1, o1, cap = _run(True)
    try:
        assert prof.dispatch_counters()["capture_replays"] >= 1
        snap = offload.scheduler_of(o1).snapshot()
        assert snap["cold_source"] == "planner", snap
        assert snap["groups_selected"] >= 1 and snap["staged_steps"] >= 1
    finally:
        offload.disable(o1)
    pt.set_flags({"FLAGS_eager_lazy_dispatch": False})
    m0, _o0, base = _run(False)
    for a, b in zip(base, cap):
        assert np.array_equal(a, b)
    for pa, pb in zip(m0.parameters(), m1.parameters()):
        assert torch.equal(pa, pb)
