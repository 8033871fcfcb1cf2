"""The port's recompute (``incubate.recompute``, ``GPTConfig.use_recompute``)
and random state, on the CPU.

At dropout 0 the port with recompute is held against the JAX package with
recompute (tests/test_torch_train.py's GPT and tolerances). At dropout 0.1
the two packages cannot share random bits, so the port with recompute is
held against the port without it, from one seed: the recomputed forward
must draw the forward's masks again, so loss and gradients are equal to the
bit. A recompute that drew new masks (as ``torch.utils.checkpoint`` would:
it stashes only torch's default generators) changes the gradients; the
negative control below shows that this test sees that.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel.topology import use_mesh
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.models import gpt as tgpt

SEED = 0
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
           dropout=0.0, attn_dropout=0.0)
BATCH = 2


@pytest.fixture(autouse=True)
def one_device():
    """The JAX reference on one device, whatever mesh an earlier test left
    installed: its tensor-parallel layers constrain to an installed mesh."""
    with use_mesh(None):
        yield


@pytest.fixture(autouse=True)
def flash_on():
    paddle.set_flags({"FLAGS_use_flash_attention": True})
    pt.set_flags({"FLAGS_use_flash_attention": True})


def _batch(seed=1):
    ids = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                               (BATCH, CFG["max_seq_len"] + 1))
    return ids[:, :-1], ids[:, 1:]


def _port_pair(**cfg):
    """Two port GPTs with the same weights, the second with recompute."""
    pt.seed(SEED)
    plain = tgpt.GPTForPretraining(tgpt.GPTConfig(**dict(CFG, **cfg)), device="cpu")
    rec = tgpt.GPTForPretraining(tgpt.GPTConfig(**dict(CFG, use_recompute=True, **cfg)),
                                 device="cpu")
    rec.load_state_dict(plain.state_dict())
    return plain, rec


def _loss_and_grads(model, x, y, seed, use_grad=False, amp=None):
    pt.seed(seed)
    with pt.amp.auto_cast(**amp) if amp else contextlib.nullcontext():
        loss = tgpt.GPTPretrainingCriterion()(model(torch.as_tensor(x)), torch.as_tensor(y))
    params = list(model.parameters())
    if use_grad:
        grads = torch.autograd.grad(loss, params)
    else:  # backward() outside the auto_cast block, as the fp16 loop does
        loss.backward()
        grads = [p.grad for p in params]
    return loss.detach(), grads


def test_recompute_at_dropout_0_matches_the_jax_package():
    paddle.seed(SEED)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**dict(CFG, use_recompute=True)))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**dict(CFG, use_recompute=True)), device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    x, y = _batch()
    jloss = jgpt.GPTPretrainingCriterion()(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    jloss.backward()
    tloss, tgrads = _loss_and_grads(tm, x, y, SEED)
    # tests/test_torch_train.py::test_every_parameter_gradient_matches_the_jax_tape's
    # tolerances, for its reasons
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5, rtol=1e-6)
    jgrads = [p.grad.numpy() for p in jm.parameters()]
    names = [n for n, _ in tm.named_parameters()]
    assert names == [n for n, _ in jm.named_parameters()]
    for n, g, jg in zip(names, tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-6, rtol=0, err_msg=n)


@pytest.mark.parametrize("use_grad", [False, True])
@pytest.mark.parametrize("amp", [None, dict(level="O1", dtype="bfloat16")])
def test_recompute_at_dropout_replays_the_masks_bitwise(use_grad, amp):
    plain, rec = _port_pair(dropout=0.1, attn_dropout=0.1)
    x, y = _batch(seed=2)
    ref_loss, ref_grads = _loss_and_grads(plain, x, y, seed=7, use_grad=use_grad, amp=amp)
    loss, grads = _loss_and_grads(rec, x, y, seed=7, use_grad=use_grad, amp=amp)
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    # the masks were drawn: another seed gives another loss
    other, _ = _loss_and_grads(plain, x, y, seed=8, use_grad=True, amp=amp)
    assert not torch.equal(other, ref_loss)
    # the generator ends where the run without recompute leaves it
    pt.seed(7)
    _loss_and_grads(plain, x, y, seed=7, use_grad=use_grad, amp=amp)
    after_plain = trandom.generator("cpu").get_state()
    _loss_and_grads(rec, x, y, seed=7, use_grad=use_grad, amp=amp)
    assert torch.equal(trandom.generator("cpu").get_state(), after_plain)


def test_a_recompute_that_draws_new_masks_is_caught(monkeypatch):
    """The negative control: with the stash's restore disabled, the
    recomputation draws new masks and the gradients differ."""
    plain, rec = _port_pair(dropout=0.1)
    x, y = _batch(seed=3)
    _, ref_grads = _loss_and_grads(plain, x, y, seed=5)
    monkeypatch.setattr(trandom.SegmentRng, "replay", lambda self: contextlib.nullcontext())
    _, grads = _loss_and_grads(rec, x, y, seed=5)
    assert not all(torch.equal(a, b) for a, b in zip(grads, ref_grads))


def test_three_compiled_steps_with_recompute_and_dropout_equal_those_without():
    losses, params = [], []
    for model in _port_pair(dropout=0.1):
        opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
        crit = tgpt.GPTPretrainingCriterion()
        step = pt.jit.compile_train_step(model, lambda lo, lb: crit(lo, lb), opt)
        pt.seed(11)
        x, y = _batch(seed=4)
        losses.append([step(torch.as_tensor(x), torch.as_tensor(y)) for _ in range(3)])
        params.append([p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*losses))
    assert all(torch.equal(a, b) for a, b in zip(*params))
    assert len(set(float(v) for v in losses[0])) == 3


def test_recompute_functions_and_sequential_and_the_fleet_reexport():
    from paddle_tpu_torch.distributed.fleet import utils as fleet_utils

    assert fleet_utils.recompute is pt.incubate.recompute
    assert fleet_utils.recompute_sequential is pt.incubate.recompute_sequential
    torch.manual_seed(0)
    layers = torch.nn.Sequential(pt.nn.Linear(8, 8, device="cpu"), pt.nn.Dropout(0.2),
                                 pt.nn.Linear(8, 8, device="cpu"), pt.nn.Dropout(0.2),
                                 pt.nn.Linear(8, 4, device="cpu"))
    x = torch.randn(3, 8, requires_grad=True)

    def run(fn):
        pt.seed(3)
        out = fn(x)
        gx, *gp = torch.autograd.grad(out.square().sum(), [x, *layers.parameters()])
        return out.detach(), gx, gp

    ref = run(layers)
    for fn in (lambda t: pt.incubate.recompute_sequential({"segments": 2}, layers, t),
               lambda t: pt.incubate.recompute_sequential(3, layers, t),
               # a bound method's segment takes its layer's parameters
               lambda t: fleet_utils.recompute(layers.forward, t),
               lambda t: pt.incubate.recompute(layers.forward, t, preserve_rng_state=True)):
        out, gx, gp = run(fn)
        assert torch.equal(out, ref[0]) and torch.equal(gx, ref[1])
        assert all(torch.equal(a, b) for a, b in zip(gp, ref[2]))
    # non-tensor arguments pass through; without grad the function just runs
    scale = pt.incubate.recompute(lambda t, k: t * k, x, 2.0)
    assert torch.equal(scale, x * 2.0) and scale.requires_grad
    with torch.no_grad():
        pt.seed(3)
        out = pt.incubate.recompute(layers.forward, x)
        assert out.grad_fn is None and torch.equal(out, ref[0])


def test_a_parameter_changed_in_place_before_the_backward_raises():
    _, rec = _port_pair()
    x, y = _batch()
    loss = tgpt.GPTPretrainingCriterion()(rec(torch.as_tensor(x)), torch.as_tensor(y))
    with torch.no_grad():
        rec.gpt.layers[0].ln1.weight.add_(1.0)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        loss.backward()


def test_rng_state_round_trip_and_seed_in_place():
    pt.seed(4)
    gen = trandom.generator("cpu")
    state = pt.get_rng_state()
    a = torch.rand(5, generator=gen)
    pt.set_rng_state(state)
    assert torch.equal(torch.rand(5, generator=gen), a)
    pt.seed(4)  # reseeded in place: a graph that registered it follows
    assert trandom.generator("cpu") is gen and torch.equal(torch.rand(5, generator=gen), a)
    assert state[0] == 4


class _FakeGraph:
    def __init__(self):
        self.registered = []

    def register_generator_state(self, gen):
        self.registered.append(gen)


def test_register_generator_state_makes_pairs_that_follow_the_rng_state():
    pt.seed(9)
    graph = _FakeGraph()
    with trandom.register_generator_state(graph, "cpu", segments=2) as pairs:
        assert trandom.generator("cpu") in graph.registered
        assert len(graph.registered) == 1 + 4 and len(pairs) == 2
        for _ in range(2):  # as if the capture ran its two segments
            trandom.SegmentRng("cpu")

    def replay_draws():  # what a replay's segments draw: reseed, then each pair
        pairs.reseed()
        draws = [torch.rand(4, generator=fwd) for fwd, _ in pairs]
        for (_, rec), drawn in zip(pairs, draws):  # the two of a pair draw the same bits
            assert torch.equal(torch.rand(4, generator=rec), drawn)
        return draws

    state = pt.get_rng_state()
    first = replay_draws()
    assert not torch.equal(first[0], first[1])  # two pairs draw different bits
    second = replay_draws()
    assert not any(torch.equal(a, b) for a, b in zip(first, second))  # new bits per replay
    # the device generator is the whole random state: restoring it, or
    # reseeding, brings the replay's draws back
    pt.set_rng_state(state)
    assert all(torch.equal(a, b) for a, b in zip(replay_draws(), first))
    pt.seed(9)
    assert all(torch.equal(a, b) for a, b in zip(replay_draws(), first))
    with pytest.raises(RuntimeError, match="ran 0 recompute segments, its warm-up steps 1"):
        with trandom.register_generator_state(_FakeGraph(), "cpu", segments=1):
            pass


def test_counting_segments_counts_the_recompute_segments_of_a_step():
    _, rec = _port_pair(dropout=0.1)
    x, y = _batch()
    with trandom.counting_segments() as seen:
        loss = tgpt.GPTPretrainingCriterion()(rec(torch.as_tensor(x)), torch.as_tensor(y))
    assert seen.count == CFG["num_layers"]
    with trandom.counting_segments() as again:
        loss.backward()  # the recomputations are no new segments
    assert again.count == 0 and trandom._scope is None


def test_a_restored_rng_state_replays_a_compiled_recompute_step():
    """paddle.set_rng_state brings back a step's masks: at lr 0, a step, the
    state restored, and the step again give one loss; a third, another."""
    _, model = _port_pair(dropout=0.1)
    opt = pt.optimizer.AdamW(learning_rate=0.0, parameters=model.parameters())
    crit = tgpt.GPTPretrainingCriterion()
    step = pt.jit.compile_train_step(model, lambda lo, lb: crit(lo, lb), opt)
    x, y = (torch.as_tensor(a) for a in _batch(seed=6))
    pt.seed(12)
    state = pt.get_rng_state()
    first = step(x, y)
    pt.set_rng_state(state)
    again, other = step(x, y), step(x, y)
    assert torch.equal(first, again) and not torch.equal(again, other)
