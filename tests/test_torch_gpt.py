"""The port's GPT against the JAX GPT, weights carried across by convert.py.

A 2-layer model (hidden 64, 4 heads, vocab 128, max_seq_len 64) is built in
both packages; the JAX state_dict goes into the port as numpy arrays. Token
ids come from numpy with a seed. Tolerance on logits: 1e-5 absolute, f32 on
the CPU; the two frameworks order matmul and softmax sums differently
(about 3e-7 apart on this model), and logits are of order 1.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.models import gpt as tgpt

TOL = 1e-5
SEED = 0
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=64,
           dropout=0.0, attn_dropout=0.0)


@pytest.fixture(scope="module")
def models():
    paddle.seed(SEED)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG))
    jm.eval()
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**CFG), device="cpu").eval()
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], shape)


@pytest.mark.parametrize("flash", [True, False])
def test_logits_match(models, flash):
    jm, tm = models
    ids = _ids((2, 48), seed=1)
    paddle.set_flags({"FLAGS_use_flash_attention": flash})
    pt.set_flags({"FLAGS_use_flash_attention": flash})
    try:
        ref = jm(paddle.to_tensor(ids)).numpy()
        with torch.no_grad():
            out = tm(torch.as_tensor(ids)).numpy()
    finally:
        paddle.set_flags({"FLAGS_use_flash_attention": True})
        pt.set_flags({"FLAGS_use_flash_attention": True})
    assert out.shape == (2, 48, CFG["vocab_size"])
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_greedy_generate_matches_step_by_step(models):
    jm, tm = models
    prompts = _ids((2, 8), seed=2)
    j_tokens = np.array(jm.generate(paddle.to_tensor(prompts), max_new_tokens=8).numpy())
    t_tokens = tm.generate(prompts, max_new_tokens=8).cpu().numpy()
    np.testing.assert_array_equal(t_tokens, j_tokens)

    # the per-step logits generate() decides on, through both KV caches
    j_caches = [{"k": None, "v": None} for _ in range(CFG["num_layers"])]
    t_caches = [{"k": None, "v": None} for _ in range(CFG["num_layers"])]
    margins = []
    for cur in range(8, 16):
        lo = 0 if cur == 8 else cur - 1
        feed = j_tokens[:, lo:cur]
        j_step = jm(paddle.to_tensor(feed), caches=j_caches, pos_offset=lo).numpy()[:, -1]
        with torch.no_grad():
            t_step = tm(torch.as_tensor(feed), caches=t_caches, pos_offset=lo).numpy()[:, -1]
        np.testing.assert_allclose(t_step, j_step, atol=TOL, rtol=0)
        top2 = np.sort(j_step, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        np.testing.assert_array_equal(j_step.argmax(-1), j_tokens[:, cur])
    # at this seed no greedy choice is a near-tie the tolerance could flip
    assert min(m.min() for m in margins) > TOL


def test_generate_eos_and_top1(models):
    jm, tm = models
    prompts = _ids((2, 6), seed=3)
    greedy = tm.generate(prompts, max_new_tokens=10).numpy()
    eos = int(greedy[0, 8])
    j_eos = jm.generate(paddle.to_tensor(prompts), max_new_tokens=10, eos_token_id=eos).numpy()
    t_eos = tm.generate(prompts, max_new_tokens=10, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(t_eos, j_eos)
    # top-1 sampling is greedy whatever the generator draws
    np.testing.assert_array_equal(tm.generate(prompts, max_new_tokens=10, top_k=1).numpy(),
                                  greedy)


def test_topk_sampling_reproducible_from_seed(models):
    _, tm = models
    prompts = _ids((2, 6), seed=4)
    pt.seed(7)
    a = tm.generate(prompts, max_new_tokens=8, top_k=5)
    pt.seed(7)
    b = tm.generate(prompts, max_new_tokens=8, top_k=5)
    assert torch.equal(a, b)
    assert a.shape == (2, 14) and int(a.max()) < CFG["vocab_size"]


def test_per_row_pos_offset(models):
    jm, tm = models
    ids = _ids((2, 3), seed=5)
    offs = np.array([4, 9], np.int64)
    ref = jm.gpt.embeddings(paddle.to_tensor(ids), pos_offset=paddle.to_tensor(offs)).numpy()
    with torch.no_grad():
        out = tm.gpt.embeddings(torch.as_tensor(ids), pos_offset=torch.as_tensor(offs)).numpy()
    np.testing.assert_allclose(out, ref, atol=0, rtol=0)


def test_length_limits(models):
    _, tm = models
    with pytest.raises(ValueError, match="no room"):
        tm.generate(_ids((1, 64), seed=6), max_new_tokens=1)
    caches = [{"k": None, "v": None} for _ in range(CFG["num_layers"])]
    with torch.no_grad():
        tm(torch.as_tensor(_ids((1, 60), seed=7)), caches=caches)
        # positions stay inside the table; the cache's 60 + 5 > 64 overflows
        with pytest.raises(tgpt.CacheOverflow):
            tm(torch.as_tensor(_ids((1, 5), seed=8)), caches=caches, pos_offset=0)


def test_unported_branches_raise():
    cfg = tgpt.GPTConfig(**CFG, sequence_parallel=True, sequence_parallel_mode="ring")
    m = tgpt.GPTForPretraining(cfg, device="cpu").eval()
    ids = torch.as_tensor(_ids((1, 8), seed=9))
    with torch.no_grad(), pytest.raises(NotImplementedError, match="multi-GPU"):
        m(ids)
    # a non-dict cache is the serving engine's paged view, ported: the layer
    # hands it q, k, v (tests/test_torch_serving.py holds the paged branch
    # bitwise against the dict cache)
    seen = []

    class View:
        def append_attend(self, q, k, v, *, scale):
            seen.append((tuple(q.shape), scale))
            return q

    with torch.no_grad():
        out = m.gpt.layers[0].attn(torch.zeros(1, 8, 64), cache=View())
    assert out.shape == (1, 8, 64) and seen == [((1, 8, 4, 16), 0.25)]
    # recompute is ported (tests/test_torch_recompute.py): with it the
    # logits are those of the same model without it
    m.cfg.sequence_parallel = False
    with torch.no_grad():
        plain = m(ids)
    m.cfg.use_recompute = True
    logits = m(ids)
    assert logits.requires_grad and torch.equal(logits.detach(), plain)


def test_convert_checks_every_key(models):
    jm, _ = models
    arrays = {k: v.numpy() for k, v in jm.state_dict().items()}
    fresh = tgpt.GPTForPretraining(tgpt.GPTConfig(**CFG), device="cpu")
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    key = "gpt.layers.0.attn.qkv_proj.weight"

    missing = dict(arrays)
    del missing[key]
    extra = dict(arrays, **{"gpt.layers.9.ln1.weight": arrays["gpt.final_ln.weight"]})
    shaped = dict(arrays, **{key: arrays[key].T})
    typed = dict(arrays, **{key: arrays[key].astype(np.float64)})
    for bad, match in [(missing, "missing"), (extra, "unexpected"), (shaped, "shape"),
                       (typed, "dtype")]:
        with pytest.raises(ValueError, match=match):
            state_dict_from_numpy(fresh, bad)
    # a refused load leaves the model as it was
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, before[k])
