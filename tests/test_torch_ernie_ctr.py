"""BASELINE config 5 on the port: ``paddle_tpu_torch/examples/ernie_ctr.py``
against the JAX package's ``examples/ernie_ctr.py`` at a small size.

The dense model's weights are carried across with
``convert.state_dict_from_numpy``; both tables are ``MemorySparseTable``s of
the same C++ from the same seed, so they start with the same rows. Five sync
``train_step``s in both packages give the same losses and table rows within
1e-4 (rtol and atol), the tolerance of the port's encoder parity test
(``tests/test_torch_nn_layers.py``, ``NORM``).
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.examples import ernie_ctr as tec

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import ernie_ctr as jec  # noqa: E402

NORM = 1e-4
SMALL = dict(vocab_size=500, hidden=32, layers=1, heads=4, seq_len=16, slots=4, sparse_dim=8)


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _pair(**kw):
    cfg = dict(SMALL, **kw)
    jt, jm, js = jec.build(jec.ErnieCtrConfig(**cfg))
    tt, tm, ts = tec.build(tec.ErnieCtrConfig(**cfg))
    state_dict_from_numpy(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return (jt, js), (tt, ts), tec.ErnieCtrConfig(**cfg)


def test_five_sync_steps_match_the_jax_package():
    (jt, js), (tt, ts), cfg = _pair()
    rng = np.random.default_rng(0)
    batches = [tec.synthetic_batch(cfg, 8, rng) for _ in range(5)]
    lj = [jec.train_step(jt, js, cfg, *b) for b in batches]
    lt = [tec.train_step(tt, ts, cfg, *b) for b in batches]
    np.testing.assert_allclose(lt, lj, rtol=NORM, atol=NORM)
    keys = np.unique(np.concatenate([b[0].reshape(-1) for b in batches]))
    assert len(tt) == len(jt) == keys.size
    np.testing.assert_allclose(tt.pull(keys, create=False), jt.pull(keys, create=False),
                               rtol=NORM, atol=NORM)


def test_synthetic_batch_is_the_jax_package_batch():
    cfg = tec.ErnieCtrConfig(**SMALL)
    for a, b in zip(tec.synthetic_batch(cfg, 8, np.random.default_rng(3)),
                    jec.synthetic_batch(cfg, 8, np.random.default_rng(3))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_state_dict_names_are_the_jax_package_names():
    (_, _), (_, _), cfg = _pair()
    jm = jec.ErnieCtrDense(jec.ErnieCtrConfig(**SMALL))
    tm = tec.ErnieCtrDense(cfg)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())


def test_compiled_step_returns_the_eager_row_gradients():
    """The row gradients ``grad_input_idx=(0,)`` returns equal eager
    autograd's on a twin model stepped beside it (on the CPU the step runs
    eagerly: the same arithmetic, so bitwise)."""
    import copy

    cfg = tec.ErnieCtrConfig(**SMALL)
    table, model, step = tec.build(cfg)
    twin = copy.deepcopy(model)
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=twin.parameters())
    bce = pt.nn.BCEWithLogitsLoss()
    rng = np.random.default_rng(1)
    for _ in range(3):
        slot_ids, tokens, labels = tec.synthetic_batch(cfg, 8, rng)
        rows = table.pull(slot_ids.reshape(-1)).reshape(8, cfg.slots, cfg.sparse_dim)
        tok, lab = pt.to_tensor(tokens), pt.to_tensor(labels)
        loss, (g,) = step(pt.to_tensor(rows), tok, lab)
        x = pt.to_tensor(rows, stop_gradient=False)
        ref = bce(twin(x, tok), lab)
        ref.backward()
        opt.step()
        opt.clear_grad()
        np.testing.assert_array_equal(g.numpy(), x.grad.numpy())
        assert float(loss) == float(ref)
        table.push(slot_ids.reshape(-1), g.numpy().reshape(-1, cfg.sparse_dim))


def test_loss_falls_on_a_fixed_batch_sync_and_pipelined():
    cfg = tec.ErnieCtrConfig(**SMALL)
    table, _, step = tec.build(cfg)
    fixed = tec.synthetic_batch(cfg, 8, np.random.default_rng(0))
    losses = [tec.train_step(table, step, cfg, *fixed) for _ in range(10)]
    assert losses[-1] < losses[0] * 0.9 and len(table) > 0
    table, _, step = tec.build(cfg)
    piped = tec.train_pipelined(table, step, cfg, [fixed] * 10)
    assert all(np.isfinite(piped)) and piped[-1] < piped[0] * 0.9
    assert len(table) == np.unique(fixed[0]).size


def test_ssd_overflow_trains_past_its_ram_budget(tmp_path):
    cfg = tec.ErnieCtrConfig(**SMALL)
    table, _, step = tec.build(cfg, ssd_path=str(tmp_path / "slots.bin"), ram_budget=64)
    rng = np.random.default_rng(0)
    for _ in range(6):
        tec.train_step(table, step, cfg, *tec.synthetic_batch(cfg, 8, rng))
    assert table.disk_size() > 0 and table.ram_size() <= 2 * 64
