"""Checkpoint and resume in the port, on the CPU: ``paddle.save`` / ``load``,
``distributed.checkpoint`` and the preemption wiring.

The scenarios of tests/test_checkpoint_resume.py and the checkpoint cases of
tests/test_resilience.py that need neither orbax nor a mesh, run against the
port with the reference's expected values (a ``Linear(4, 3)`` with Adam, and
a 2-layer, 64-wide GPT through ``compile_train_step``); then the files of
each package loaded by the other, where the JAX package is the oracle. Those
exchanges compare arrays bit for bit; the logits of one GPT state in both
packages agree within the forward tolerance of tests/test_torch_train.py.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed.checkpoint as ckmod
import paddle_tpu_torch.framework.io_utils as ioumod
from paddle_tpu_torch.distributed.checkpoint import (
    AsyncCheckpointer,
    CadenceTuner,
    load_state_dict,
    restore_training_state,
    save_state_dict,
    train_epoch_range,
    train_step_range,
    training_state,
)
from paddle_tpu_torch.resilience import Preempted, PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32,
               dropout=0.0, attn_dropout=0.0)


@pytest.fixture(autouse=True)
def on_cpu():
    previous = pt.get_device()
    pt.set_device("cpu")
    pt.profiler.reset_dispatch_counters()
    pt.resilience.reset()
    yield
    pt.set_flags({"FLAGS_fault_inject": ""})
    pt.resilience.reset()
    pt.set_device(previous)


def _make(seed=0):
    pt.seed(seed)
    net = pt.nn.Linear(4, 3)
    opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters())
    return net, opt


def _train_one(net, opt, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    loss = ((net(x) - y) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.item()


def _slow(monkeypatch, seconds):
    real_save = ioumod.save

    def slow_save(obj, path, **kw):
        time.sleep(seconds)
        return real_save(obj, path, **kw)

    monkeypatch.setattr(ioumod, "save", slow_save)


def _moments(opt, p):
    return {k: v.clone() for k, v in opt._accumulators[id(p)].items()}


def test_save_load_state_dict_roundtrip(tmp_path):
    net, _ = _make()
    path = str(tmp_path / "sd")
    save_state_dict(net.state_dict(), path)

    net2, _ = _make(seed=123)
    before = net2.weight.detach().clone()
    sd2 = net2.state_dict()
    load_state_dict(sd2, path)
    net2.set_state_dict(sd2)
    assert not torch.equal(net2.weight, before)
    assert torch.equal(net2.weight, net.weight)


def test_train_epoch_range_resumes_after_crash(tmp_path):
    """Run 2 of 5 epochs, crash in epoch 1's body, restart: resumes at 1."""
    net, opt = _make()
    ckpt = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    seen = []
    w_after_epoch0 = None
    with pytest.raises(RuntimeError, match="simulated preemption"):
        for epoch in train_epoch_range(5, ckpt, net.state_dict()):
            seen.append(epoch)
            _train_one(net, opt, seed=epoch)
            if epoch == 0:
                w_after_epoch0 = net.weight.detach().clone()
            if epoch == 1:
                raise RuntimeError("simulated preemption")
    ckpt.wait()
    assert seen == [0, 1]

    net2, opt2 = _make(seed=999)  # another init, overwritten by the restore
    ckpt2 = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    resumed = []
    for epoch in train_epoch_range(5, ckpt2, net2.state_dict()):
        if not resumed:  # restored before the first yielded epoch
            assert torch.equal(net2.weight, w_after_epoch0)
        resumed.append(epoch)
        _train_one(net2, opt2, seed=epoch)
    assert resumed == [1, 2, 3, 4]


def test_train_epoch_range_restores_optimizer_accumulators(tmp_path):
    """A training_state view refills Adam's moments on resume, in place."""
    net, opt = _make()
    ckpt = AsyncCheckpointer(str(tmp_path / "ck"))
    moments_after_epoch0 = None
    with pytest.raises(RuntimeError):
        for epoch in train_epoch_range(4, ckpt, training_state(net, opt)):
            _train_one(net, opt, seed=epoch)
            if epoch == 0:
                moments_after_epoch0 = _moments(opt, opt._param_list()[0])
            if epoch == 1:
                raise RuntimeError("simulated preemption")
    ckpt.wait()
    assert any(v.abs().sum() > 0 for v in moments_after_epoch0.values())

    net2, opt2 = _make(seed=999)
    epochs = iter(train_epoch_range(4, AsyncCheckpointer(str(tmp_path / "ck")),
                                    training_state(net2, opt2), optimizer=opt2))
    assert next(epochs) == 1
    restored = opt2._accumulators[id(opt2._param_list()[0])]
    for k, v in moments_after_epoch0.items():
        assert torch.equal(restored[k], v), k
    epochs.close()


def test_checkpointer_retention(tmp_path):
    net, _ = _make()
    ck = AsyncCheckpointer(str(tmp_path / "r"), max_to_keep=2)
    state = net.state_dict()
    for step in range(4):
        ck.save(step, state)
    ck.wait()
    assert sorted(d for d in os.listdir(tmp_path / "r") if d.isdigit()) == ["2", "3"]
    assert ck.restore_latest(net.state_dict()) == 3


def test_atomic_save_survives_crash_before_commit(tmp_path, monkeypatch):
    """A crash between the payload write and its rename leaves the previous
    snapshot as the restorable latest; the background failure surfaces at
    the join (wait)."""
    net, opt = _make()
    _train_one(net, opt)
    state = training_state(net, opt)
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=3)
    ck.save(0, state)
    ck.wait()
    w0 = net.weight.detach().clone()
    _train_one(net, opt, seed=1)

    real_replace = os.replace
    died = []

    def dying_replace(src, dst):
        if str(dst).endswith(os.sep + "1") and not died:
            died.append(1)
            raise RuntimeError("simulated kill before commit")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", dying_replace)
    ck.save(1, state)
    with pytest.raises(RuntimeError):
        ck.wait()
    monkeypatch.setattr(os, "replace", real_replace)

    net2, opt2 = _make(seed=55)
    assert ck.restore_latest(training_state(net2, opt2)) == 0
    assert torch.equal(net2.weight, w0)


def test_restore_skips_corrupt_latest_snapshot(tmp_path):
    net, opt = _make()
    _train_one(net, opt)
    state = training_state(net, opt)
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=3)
    ck.save(0, state)
    w0 = net.weight.detach().clone()
    _train_one(net, opt, seed=1)
    ck.save(1, state)
    ck.wait()  # commit step 1 before tearing its bytes
    with open(str(tmp_path / "ck" / "1"), "wb") as f:
        f.write(b"\x80\x04 torn")
    net2, opt2 = _make(seed=56)
    assert ck.restore_latest(training_state(net2, opt2)) == 0
    assert torch.equal(net2.weight, w0)


def test_train_step_range_periodic_save_crash_resume(tmp_path):
    """save_freq bounds lost work on a hard crash: die after step 5 with
    save_freq=2 -> resume at step 4."""
    net, opt = _make()
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    with pytest.raises(RuntimeError):
        for step in train_step_range(10, ck, training_state(net, opt), save_freq=2):
            _train_one(net, opt, seed=step)
            if step == 5:
                raise RuntimeError("hard crash (no signal, no boundary save)")
    ck.wait()
    net2, opt2 = _make(seed=9)
    ck2 = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    resumed = []
    for step in train_step_range(10, ck2, training_state(net2, opt2)):
        _train_one(net2, opt2, seed=step)
        resumed.append(step)
    assert resumed == [4, 5, 6, 7, 8, 9]  # steps 4..5 lost <= save_freq


def _gpt_trainer(seed=0):
    from paddle_tpu_torch.models import gpt as tgpt

    pt.seed(seed)
    cfg = tgpt.GPTConfig(**GPT_CFG)
    model = tgpt.GPTForPretraining(cfg)
    crit = tgpt.GPTPretrainingCriterion(cfg)
    opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = pt.jit.compile_train_step(model, lambda logits, labels: crit(logits, labels), opt)
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, cfg.max_seq_len + 1)))

    def one():
        return step(ids[:, :-1], ids[:, 1:]).item()

    return model, opt, one


def test_snapshot_overlap_bitwise_boundary_state(tmp_path, monkeypatch):
    """A snapshot taken at step k is bitwise the step-k state although steps
    k+1..k+3 update the live tensors in place while the save still persists:
    the persist is held until they ran, so it provably commits after the
    live state moved on. The restore then writes into the tensors a compiled
    step holds."""
    import threading

    release = threading.Event()
    real_save = ioumod.save

    def held_save(obj, path, **kw):
        assert release.wait(60)
        return real_save(obj, path, **kw)

    monkeypatch.setattr(ioumod, "save", held_save)
    model, opt, one = _gpt_trainer()
    for _ in range(3):
        one()
    state = training_state(model, opt)
    boundary = {k: (v.clone() if isinstance(v, torch.Tensor) else v.copy())
                for k, v in state.items()}
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    ck.save(0, state)  # async: the persist overlaps the next steps
    for _ in range(3):
        one()
    assert ckmod.persists_in_flight() == 1
    release.set()
    ck.wait()
    c = pt.profiler.dispatch_counters()
    assert c["ckpt_async_saves"] == 1 and c["ckpt_snapshots"] == 1
    state.refresh()
    assert any(not torch.equal(state[k], v) for k, v in boundary.items()
               if isinstance(v, torch.Tensor))

    model2, opt2, one2 = _gpt_trainer(seed=99)
    one2()  # its accumulators exist: the restore must write into them
    state2 = training_state(model2, opt2)
    ptrs = {k: v.data_ptr() for k, v in state2.items() if isinstance(v, torch.Tensor)}
    assert AsyncCheckpointer(str(tmp_path / "ck")).restore_latest(state2) == 0
    restore_training_state(state2, optimizer=opt2)
    state2.refresh()
    for k, v in boundary.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(state2[k], v), k
            assert state2[k].data_ptr() == ptrs[k], k
        else:
            np.testing.assert_array_equal(state2[k], v)


def test_cadence_tuner_arithmetic():
    """freq = max(snapshot-under-budget, persist-fits-between-saves),
    re-tuned on step-time drift (the reference's numbers)."""
    t = CadenceTuner(overhead_pct=3.5)
    for _ in range(5):
        t.observe_step(0.010)  # 10 ms steady state
    assert t.save_freq is None
    # the first save is the profiling phase: its costs are dropped
    t.observe_snapshot(2000.0)
    t.observe_persist(5000.0, profiling=True)
    assert t.save_freq is None and t.snapshot_ms is None
    t.observe_snapshot(2.0)
    assert t.save_freq is None  # no frequency until both costs are known
    t.observe_persist(30.0)  # ceil(30*1.25/10)=4 < 8: the budget rules
    assert t.save_freq == 8  # ceil(2.0 / (0.8 * 0.035 * 10))
    t.observe_persist(250.0)  # persist EMA 140 ms: ceil(17.5)=18
    assert t.save_freq == 18
    before = t.retunes
    for _ in range(30):
        t.observe_step(0.050)  # steady state 5x slower: drift re-tunes
    assert t.retunes > before
    assert t.save_freq == 4  # ceil(140*1.25/50) beats ceil(2/(.8*.035*50))=2
    assert pt.profiler.dispatch_counters()["ckpt_auto_save_freq"] == 4
    assert pt.profiler.dispatch_counters()["ckpt_cadence_retunes"] == t.retunes


def test_auto_cadence_overhead_under_budget(tmp_path):
    """save_freq='auto': measured overhead under FLAGS_ckpt_overhead_pct on
    a sleep-paced loop, and the last restorable step within the cadence."""
    net, opt = _make()
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    for step in train_step_range(80, ck, training_state(net, opt), save_freq="auto"):
        _train_one(net, opt, seed=step)
        time.sleep(0.010)  # paced so the ~ms persist fits between saves
    tuner = ck.tuner
    assert tuner is not None and tuner.save_freq is not None
    budget = pt.get_flags("FLAGS_ckpt_overhead_pct")["FLAGS_ckpt_overhead_pct"]
    assert tuner.measured_overhead_pct() <= budget
    c = pt.profiler.dispatch_counters()
    assert c["ckpt_snapshots"] >= 2
    assert c["ckpt_async_saves"] == c["ckpt_snapshots"]
    assert c["ckpt_auto_save_freq"] == tuner.save_freq
    net2, opt2 = _make(seed=31)
    got = AsyncCheckpointer(str(tmp_path / "ck")).restore_latest(training_state(net2, opt2))
    assert got is not None and got >= 79 - 2 * tuner.save_freq


def test_save_freq_rejects_unknown_string(tmp_path):
    net, opt = _make()
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    with pytest.raises(ValueError):
        list(train_step_range(2, ck, training_state(net, opt), save_freq="adaptive"))


def test_emergency_save_joins_inflight(tmp_path, monkeypatch):
    """An emergency save at a boundary whose async persist is in flight
    joins it; a different boundary supersedes with a synchronous save."""
    _slow(monkeypatch, 0.15)
    net, opt = _make()
    _train_one(net, opt)
    state = training_state(net, opt)
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=3)
    ck.save(3, state)            # in flight (slowed)
    ck.emergency_save(3, state)  # same boundary: join, don't redo
    c = pt.profiler.dispatch_counters()
    assert c["ckpt_emergency_joined_inflight"] == 1
    assert c["ckpt_sync_saves"] == 0 and c["ckpt_snapshots"] == 1
    assert ck._read_latest() == 3
    _train_one(net, opt, seed=2)
    ck.save(4, state)
    _train_one(net, opt, seed=3)
    ck.emergency_save(5, state)
    assert pt.profiler.dispatch_counters()["ckpt_sync_saves"] == 1
    assert ck._read_latest() == 5


def test_emergency_save_survives_stale_persist_failure(tmp_path, monkeypatch):
    net, opt = _make()
    _train_one(net, opt)
    state = training_state(net, opt)
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=3)
    real_save = ioumod.save
    fail_once = []

    def failing_save(obj, path, **kw):
        if not fail_once:
            fail_once.append(1)
            raise RuntimeError("disk hiccup")
        return real_save(obj, path, **kw)

    monkeypatch.setattr(ioumod, "save", failing_save)
    ck.save(2, state)  # the async persist of step 2 fails in the background
    _train_one(net, opt, seed=1)
    ck.emergency_save(5, state)  # must not re-raise the step-2 error
    assert ck.last_error is not None
    net2, opt2 = _make(seed=41)
    got = AsyncCheckpointer(str(tmp_path / "ck")).restore_latest(training_state(net2, opt2))
    assert got == 5
    assert torch.equal(net2.weight, net.weight)


def test_checkpoint_io_runs_under_the_resilience_executor(tmp_path):
    """The commit goes through resilience.execute('checkpoint', ...): an
    injected transient fault there is retried and the save lands; the
    flight recorder has each phase as a 'ckpt' event."""
    backoff = pt.get_flags("FLAGS_retry_backoff_ms")
    pt.set_flags({"FLAGS_fault_inject": "execute:p=1:x=1:checkpoint",
                  "FLAGS_retry_backoff_ms": 0.0})
    try:
        net, opt = _make()
        pt.profiler.trace.clear()
        ck = AsyncCheckpointer(str(tmp_path / "ck"))
        ck.save(0, training_state(net, opt), blocking=True)
        save_state_dict(net.state_dict(), str(tmp_path / "sd"))
    finally:
        pt.set_flags(backoff)
    c = pt.profiler.dispatch_counters()
    assert c["fault_sites"]["checkpoint"] == 1 and c["retry_attempts"] == 1
    assert c["ckpt_sync_saves"] == 1 and ck._read_latest() == 0
    phases = [e.attrs["phase"] for e in pt.profiler.trace.events(kind="ckpt")]
    assert phases == ["snapshot", "transfer", "commit"]
    assert os.path.exists(tmp_path / "sd")


def test_train_step_range_break_drains_inflight_save(tmp_path, monkeypatch):
    _slow(monkeypatch, 0.15)
    net, opt = _make()
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    for step in train_step_range(10, ck, training_state(net, opt), save_freq=1):
        _train_one(net, opt, seed=step)
        if step == 2:
            break  # step 2's save is never issued; step 1's is in flight
    net2, opt2 = _make(seed=13)
    got = AsyncCheckpointer(str(tmp_path / "ck")).restore_latest(training_state(net2, opt2))
    assert got == 1


def test_sigterm_resume_loses_no_step(tmp_path):
    """tests/test_resilience.py's case: SIGTERM during step 3 under a
    PreemptionGuard finishes the step, emergency-saves it, raises Preempted;
    the relaunch resumes at 4 and ends bitwise on the clean run's loss."""
    def run_step(net, opt, i):
        return _train_one(net, opt, seed=100 + i)

    net, opt = _make()
    clean = [run_step(net, opt, i) for i in range(8)]

    net, opt = _make()
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    done = []
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.raises(Preempted) as info:
        for step in train_step_range(8, ck, training_state(net, opt), guard=PreemptionGuard()):
            run_step(net, opt, step)
            done.append(step)
            if step == 3:
                os.kill(os.getpid(), signal.SIGTERM)
    assert done == [0, 1, 2, 3] and info.value.code == 128 + signal.SIGTERM
    c = pt.profiler.dispatch_counters()
    assert c["preemptions"] == 1 and c["emergency_saves"] == 1
    assert signal.getsignal(signal.SIGTERM) == previous  # the loop uninstalled the guard

    net2, opt2 = _make(seed=777)
    ck2 = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    resumed, losses = [], []
    for step in train_step_range(8, ck2, training_state(net2, opt2), guard=PreemptionGuard()):
        losses.append(run_step(net2, opt2, step))
        resumed.append(step)
    assert resumed == [4, 5, 6, 7]
    assert losses == clean[4:]


def test_train_epoch_range_guard(tmp_path):
    net, opt = _make()
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    seen = []
    with pytest.raises(Preempted):
        for epoch in train_epoch_range(5, ck, training_state(net, opt), guard=PreemptionGuard()):
            seen.append(epoch)
            _train_one(net, opt)
            if epoch == 1:
                os.kill(os.getpid(), signal.SIGTERM)
    assert seen == [0, 1]
    net2, opt2 = _make(seed=9)
    ck2 = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    resumed = [e for e in train_epoch_range(5, ck2, training_state(net2, opt2),
                                            guard=PreemptionGuard())
               if _train_one(net2, opt2) is not None]
    assert resumed == [2, 3, 4]


class _Sampler:
    """A data iterator with Paddle's state methods: a cursor and a seed."""

    def __init__(self):
        self.cursor, self.seed = 0, 0

    def state_dict(self):
        return {"cursor": self.cursor, "seed": self.seed}

    def load_state_dict(self, doc):
        self.cursor, self.seed = doc["cursor"], doc["seed"]


def test_data_state_rides_the_snapshot(tmp_path):
    """data= packs the iterator's state into the fixed-size __data__.blob of
    every snapshot; the resume pushes it back, so each batch is read once."""
    net, opt = _make()
    sampler = _Sampler()
    sampler.seed = 42
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    with pytest.raises(RuntimeError):
        for step in train_step_range(6, ck, training_state(net, opt), save_freq=1,
                                     data=sampler):
            sampler.cursor += 1
            if step == 3:
                raise RuntimeError("crash in step 3")
    ck.wait()
    assert training_state(net, opt)[ckmod._DATA_KEY].shape == (ckmod._DATA_BLOB_BYTES,)
    net2, opt2 = _make(seed=5)
    sampler2 = _Sampler()
    steps = iter(train_step_range(6, AsyncCheckpointer(str(tmp_path / "ck")),
                                  training_state(net2, opt2), data=sampler2))
    assert next(steps) == 3
    assert sampler2.state_dict() == {"cursor": 3, "seed": 42}
    steps.close()
    with pytest.raises(ValueError, match="does not fit"):
        ckmod._pack_data_state({"data": b"x" * ckmod._DATA_BLOB_BYTES})


_CHILD_PRELUDE = """
import os, sys, time
sys.path.insert(0, sys.argv[2])
import numpy as np, torch
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed.checkpoint as ckmod
import paddle_tpu_torch.framework.io_utils as ioumod
pt.set_device("cpu")
pt.seed(0)
net = pt.nn.Linear(4, 3)
opt = pt.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters())
rng = np.random.default_rng(0)
X = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
Y = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
def one():
    loss = ((net(X) - Y) ** 2).mean(); loss.backward()
    opt.step(); opt.clear_grad()
one()
state = ckmod.training_state(net, opt)
ck = ckmod.AsyncCheckpointer(sys.argv[1], max_to_keep=3)
ck.save(0, state)
ck.wait()
np.save(os.path.join(sys.argv[1], "expect_w.npy"), net.weight.detach().numpy())
one()
"""


def _run_killed_child(tmp_path, body):
    ckdir = str(tmp_path / "ck")
    os.makedirs(ckdir, exist_ok=True)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD_PRELUDE + textwrap.dedent(body), ckdir, REPO],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 137, (out.returncode, out.stdout, out.stderr)
    assert "UNREACHABLE" not in out.stdout
    assert "jax" not in out.stdout
    net, opt = _make(seed=77)
    assert AsyncCheckpointer(ckdir, max_to_keep=3).restore_latest(training_state(net, opt)) == 0
    np.testing.assert_array_equal(net.weight.detach().numpy(),
                                  np.load(os.path.join(ckdir, "expect_w.npy")))
    assert not os.path.exists(os.path.join(ckdir, "1"))


def test_crash_during_async_save_subprocess(tmp_path):
    """The process trains on while the background persist of step 1 runs,
    then dies in it (kill:checkpoint: os._exit(137) between the payload
    write and the rename): the parent restores the intact step 0."""
    _run_killed_child(tmp_path, """
        real_save = ioumod.save
        def slow_save(obj, path, **kw):
            time.sleep(0.3)  # keep the persist in flight while we train on
            return real_save(obj, path, **kw)
        ioumod.save = slow_save
        pt.set_flags({"FLAGS_fault_inject": "kill:checkpoint"})
        ck.save(1, state)   # the async persist armed with the kill
        one(); one()        # training overlaps the doomed persist
        ck.wait()           # the join: os._exit(137) fired mid-commit
        print("UNREACHABLE", sorted(m for m in sys.modules if m.split(".")[0] == "jax"))
    """)


def test_injected_kill_mid_save_subprocess(tmp_path):
    """A blocking save hard-killed between payload write and commit."""
    _run_killed_child(tmp_path, """
        pt.set_flags({"FLAGS_fault_inject": "kill:checkpoint"})
        ck.save(1, state, blocking=True)
        print("UNREACHABLE")
    """)


# ---------------------------------------------------------------------------
# files of each package loaded by the other (the JAX package as the oracle)
# ---------------------------------------------------------------------------
def _nested(rng):
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "i64": rng.integers(-9, 9, (4,)).astype(np.int64),
        "i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "scalar": np.float32(1.5),
        "meta": {"epoch": 3, "name": "gpt", "list": [1, 2.5, "x"], "tuple": (4, 5)},
    }


def _assert_bitwise(got, want):
    assert type(got) is type(want) or isinstance(got, np.ndarray), (type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_bitwise(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_bitwise(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert got == want


def test_files_cross_between_packages_bitwise(tmp_path):
    import paddle_tpu as paddle

    rng = np.random.default_rng(0)
    want = _nested(rng)
    # the port's file in the JAX package
    pt.save({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in want.items()}, str(tmp_path / "t.pdparams"))
    _assert_bitwise(paddle.load(str(tmp_path / "t.pdparams"), return_numpy=True), want)
    # the JAX package's file in the port, as numpy and as CPU tensors
    paddle.save({k: paddle.to_tensor(v) if isinstance(v, np.ndarray) and v.ndim else v
                 for k, v in want.items()}, str(tmp_path / "j.pdparams"))
    _assert_bitwise(pt.load(str(tmp_path / "j.pdparams"), return_numpy=True), want)
    as_tensors = pt.load(str(tmp_path / "j.pdparams"))
    assert isinstance(as_tensors["f32"], torch.Tensor)
    assert as_tensors["f32"].device.type == "cpu"
    assert torch.equal(as_tensors["i64"], torch.from_numpy(want["i64"]))


def test_bfloat16_crosses_between_packages_bitwise(tmp_path):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    import jax.numpy as jnp

    import paddle_tpu as paddle

    bits = np.random.default_rng(1).integers(0, 2 ** 16, (6, 7)).astype(np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] &= 0xBFFF  # no inf or NaN patterns
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    pt.save({"w": t, "nested": [t[0]]}, str(tmp_path / "t.pdparams"))
    got = paddle.load(str(tmp_path / "t.pdparams"))
    assert got["w"].dtype == jnp.bfloat16
    assert got["w"].numpy().view(np.uint16).tobytes() == bits.tobytes()
    assert got["nested"][0].numpy().view(np.uint16).tobytes() == bits[0].tobytes()

    paddle.save({"w": paddle.to_tensor(bits.view(ml_dtypes.bfloat16))},
                str(tmp_path / "j.pdparams"))
    back = pt.load(str(tmp_path / "j.pdparams"))["w"]
    assert back.dtype == torch.bfloat16
    assert back.view(torch.int16).numpy().view(np.uint16).tobytes() == bits.tobytes()
    assert pt.load(str(tmp_path / "j.pdparams"), return_numpy=True)["w"].dtype == \
        ml_dtypes.bfloat16


def test_bfloat16_o2_training_state_round_trips_bitwise(tmp_path):
    """The O2 checkpoint is mostly bf16 (parameters and both AdamW moments):
    every entry comes back with its dtype and bits."""
    pytest.importorskip("ml_dtypes")
    model, opt, one = _gpt_trainer()
    model = pt.amp.decorate(model, level="O2", dtype="bfloat16")
    one()
    state = training_state(model, opt)
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save(0, state)
    ck.wait()
    want = {k: v.clone() for k, v in state.items() if isinstance(v, torch.Tensor)}
    assert sum(v.dtype == torch.bfloat16 for v in want.values()) > len(want) // 2
    model2, opt2, _ = _gpt_trainer(seed=3)
    model2 = pt.amp.decorate(model2, level="O2", dtype="bfloat16")
    state2 = training_state(model2, opt2)
    assert ck.restore_latest(state2) == 0
    for k, v in want.items():
        assert state2[k].dtype == v.dtype and torch.equal(state2[k], v), k


def _jax_gpt_and_port_gpt():
    import paddle_tpu as paddle
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu.parallel.topology import use_mesh
    from paddle_tpu_torch.models import gpt as tgpt

    with use_mesh(None):
        paddle.seed(5)
        jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**GPT_CFG))
    pt.seed(6)
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**GPT_CFG))
    return jm, tm


def _logits(jm, tm, ids):
    import paddle_tpu as paddle
    from paddle_tpu.parallel.topology import use_mesh

    jm.eval()
    tm.eval()
    with use_mesh(None):
        jl = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids)).numpy()
    return jl, tl


def test_gpt_state_dict_crosses_between_packages(tmp_path):
    """A JAX GPT's state_dict written by paddle_tpu.save loads through
    paddle_tpu_torch.load + set_state_dict, and the reverse; the logits agree
    within tests/test_torch_gpt.py's f32 forward tolerance."""
    import paddle_tpu as paddle

    jm, tm = _jax_gpt_and_port_gpt()
    ids = np.random.default_rng(2).integers(0, GPT_CFG["vocab_size"], (2, 16))
    paddle.save(jm.state_dict(), str(tmp_path / "jax.pdparams"))
    missing, unexpected = tm.set_state_dict(pt.load(str(tmp_path / "jax.pdparams")))
    assert missing == [] and unexpected == []
    jl, tl = _logits(jm, tm, ids)
    np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=1e-5)

    jm2, tm2 = _jax_gpt_and_port_gpt()
    pt.save(tm2.state_dict(), str(tmp_path / "port.pdparams"))
    missing, unexpected = jm2.set_state_dict(paddle.load(str(tmp_path / "port.pdparams")))
    assert missing == [] and unexpected == []
    for k, v in tm2.state_dict().items():
        np.testing.assert_array_equal(jm2.state_dict()[k].numpy(), v.numpy())
    jl, tl = _logits(jm2, tm2, ids)
    np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=1e-5)


def test_training_state_snapshots_cross_between_packages(tmp_path, monkeypatch):
    """A JAX training_state snapshot on the reference's pickle path restores
    in the port's restore_latest (parameters and Adam accumulators bit for
    bit), and a port snapshot in the JAX package's."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed.checkpoint as jck

    monkeypatch.setattr(jck, "_HAS_ORBAX", False)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 3)).astype(np.float32)

    paddle.seed(0)
    jnet = paddle.nn.Linear(4, 3)
    jopt = paddle.optimizer.Adam(learning_rate=1e-2, parameters=jnet.parameters())
    for _ in range(2):
        loss = ((jnet(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
    jstate = jck.training_state(jnet, jopt)
    jckpt = jck.AsyncCheckpointer(str(tmp_path / "jax"), max_to_keep=2)
    jckpt.save(7, jstate)
    jckpt.wait()
    jstate.refresh()
    want = {k: np.asarray(getattr(v, "_value", v)) for k, v in jstate.items()}

    net, opt = _make(seed=1)
    state = training_state(net, opt)
    assert AsyncCheckpointer(str(tmp_path / "jax")).restore_latest(state) == 7
    restore_training_state(state, optimizer=opt)
    state.refresh()
    assert set(state) == set(want)
    for k, v in want.items():
        got = state[k].numpy() if isinstance(state[k], torch.Tensor) else state[k]
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k

    _train_one(net, opt, seed=9)
    ckpt = AsyncCheckpointer(str(tmp_path / "port"))
    ckpt.save(8, state)
    ckpt.wait()
    paddle.seed(3)
    jnet2 = paddle.nn.Linear(4, 3)
    jopt2 = paddle.optimizer.Adam(learning_rate=1e-2, parameters=jnet2.parameters())
    jstate2 = jck.training_state(jnet2, jopt2)
    assert jck.AsyncCheckpointer(str(tmp_path / "port")).restore_latest(jstate2) == 8
    jck.restore_training_state(jstate2, optimizer=jopt2)
    jstate2.refresh()
    state.refresh()
    for k, v in state.items():
        want_k = v.numpy() if isinstance(v, torch.Tensor) else v
        got = np.asarray(getattr(jstate2[k], "_value", jstate2[k]))
        assert got.tobytes() == want_k.tobytes(), k
