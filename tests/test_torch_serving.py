"""The port's serving engine (``paddle_tpu_torch.serving``) against the JAX
package's, on the CPU.

A tiny GPT (vocab 64, hidden 32, 2 layers, 2 heads, max_seq_len 32, as
``tests/test_serving.py`` builds) is made in the JAX package from seed 7
and carried into the port by ``convert.py``. Its weights are drawn with
``initializer_range=0.2`` rather than 0.02: at 0.02 greedy decode repeats
one token whatever the context, which would hide a cache that attends the
wrong positions. Prompts come from ``np.random.default_rng``.

Tolerances: the paged attention op against the JAX op, 1e-6 on its output
and on both pools (f32; the two frameworks order the softmax and matmul
sums differently, ~1e-7 apart); the engine's logits rows against the JAX
engine's, 1e-5 (the logits tolerance of ``tests/test_torch_gpt.py``), and
equal tokens where no greedy choice is a near-tie within that tolerance
(asserted). Within the port everything is bitwise: paged against the
fixed-shape cache over the same context length, the engine against
``generate()``, and the three execution rungs against each other (on the
CPU each runs the same function eagerly).

Under fault injection (``FLAGS_fault_inject``) the port's engine gives the
JAX engine's tokens, and under the targeted specs the same fault, retry,
ladder and fallback counters. The Supervisor, restart, fail-clean, drain and
health tests are ports of ``tests/test_serving_overload.py``'s and
``tests/test_serving.py``'s, with the tokens of a restarted serve equal to
``generate()``'s.

On the CPU no CUDA graph is captured; ``tests/test_torch_cuda_kernels.py``
holds the graphs on the card.
"""
import os
import signal
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.profiler as jprof
import paddle_tpu.resilience as jres
import paddle_tpu_torch as pt
from paddle_tpu import serving as jserving
from paddle_tpu.core.lazy import reset_serve_programs as jreset_serve_programs
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForPretraining as JGPTForPretraining
from paddle_tpu.ops import nn_ops as jops
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch import serving
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.core import lazy
from paddle_tpu_torch.core.flags import describe_flags
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.models.gpt import CacheOverflow
from paddle_tpu_torch.ops import nn_ops as tops
from paddle_tpu_torch.profiler import trace
from paddle_tpu_torch.serving.cache import PagedCacheView, _BatchState

VOCAB = 64
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2, max_seq_len=32,
           dropout=0.0, attn_dropout=0.0, initializer_range=0.2)
OP_TOL = 1e-6
LOGITS_TOL = 1e-5
ENGINE_PROMPT_LENS = (8, 8, 16, 5)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JGPTForPretraining(JGPTConfig(**CFG))
    jm.eval()
    tm = GPTForPretraining(GPTConfig(**CFG), device="cpu").eval()
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture
def model(models):
    return models[1]


@pytest.fixture(autouse=True)
def _isolation():
    prof.reset_dispatch_counters()
    pt.resilience.reset()
    yield
    pt.set_flags({
        "FLAGS_fault_inject": "",
        "FLAGS_retry_backoff_ms": 5.0,
        "FLAGS_serving_max_engine_restarts": 3,
        "FLAGS_trace_stall_ms": 0.0,
        "FLAGS_postmortem_dir": "",
        "FLAGS_serving_capture": True,
        "FLAGS_serving_capture_donate": True,
        "FLAGS_serving_capture_cache_size": 16,
        "FLAGS_serving_default_deadline_ms": 0.0,
        "FLAGS_serving_deadline_partial": True,
        "FLAGS_serving_queue_max": 256,
        "FLAGS_serving_queue_wait_p99_ms": 0.0,
        "FLAGS_serving_request_retries": 2,
        "FLAGS_memory_budget_mb": 0.0,
    })
    pt.resilience.reset()
    lazy.reset_serve_programs()


def make_engine(model, **kw):
    kw.setdefault("block_size", 8)
    kw.setdefault("prompt_buckets", [8, 16])
    kw.setdefault("num_blocks", 24)
    return serving.Engine(model, serving.ServingConfig(**kw))


def _prompt(rng, n=8):
    return rng.integers(1, VOCAB, n)


def _generate(model, prompt, n):
    return [int(t) for t in model.generate(np.asarray(prompt, np.int64)[None, :],
                                           max_new_tokens=n).numpy()[0, len(prompt):]]


# ---------------------------------------------------------------------------
# (a), (b): paged_decode_attention against the JAX op and against the port's
# own cached_attention
# ---------------------------------------------------------------------------
B, H, D, BS, NBLK = 2, 2, 8, 8, 4
L = NBLK * BS
TABLES = np.asarray([[2 + i * NBLK + j for j in range(NBLK)] for i in range(B)], np.int32)


def _paged_inputs(case, lens):
    """Pools holding ``lens[i]`` cached tokens per row (scratch ids 0..1
    unused) and the chunk: one token (decode) or 16 from position 0."""
    rng = np.random.default_rng(0)
    s = 1 if case == "decode" else 16
    n_total = 2 + B * NBLK
    k_pool = np.zeros((n_total, BS, H, D), np.float32)
    v_pool = np.zeros((n_total, BS, H, D), np.float32)
    k_cache = np.zeros((B, L, H, D), np.float32)
    v_cache = np.zeros((B, L, H, D), np.float32)
    for i in range(B):
        k_cache[i, :lens[i]] = rng.standard_normal((lens[i], H, D))
        v_cache[i, :lens[i]] = rng.standard_normal((lens[i], H, D))
        k_pool[TABLES[i]] = k_cache[i].reshape(NBLK, BS, H, D)
        v_pool[TABLES[i]] = v_cache[i].reshape(NBLK, BS, H, D)
    q, k_new, v_new = (rng.standard_normal((B, s, H, D)).astype(np.float32) for _ in range(3))
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, k_cache=k_cache, v_cache=v_cache,
                k_new=k_new, v_new=v_new, lens=np.asarray(lens, np.int32), s=s)


def _port_paged(x, prefill):
    t = {k: torch.from_numpy(x[k].copy()) for k in ("q", "k_pool", "v_pool", "k_new", "v_new")}
    out, nk, nv = tops.paged_decode_attention(
        t["q"], t["k_pool"], t["v_pool"], torch.from_numpy(TABLES.astype(np.int64)),
        torch.from_numpy(x["lens"].astype(np.int64)), t["k_new"], t["v_new"],
        scale=0.25, block_size=BS, prefill=prefill)
    return out.numpy(), nk.numpy(), nv.numpy()


@pytest.mark.parametrize("case,lens", [("decode", [13, 6]), ("prefill", [0, 0])])
def test_paged_attention_matches_jax(case, lens):
    x = _paged_inputs(case, lens)
    prefill = case == "prefill"
    ref = jops.paged_decode_attention(
        jnp.asarray(x["q"]), jnp.asarray(x["k_pool"]), jnp.asarray(x["v_pool"]),
        jnp.asarray(TABLES), jnp.asarray(x["lens"]), jnp.asarray(x["k_new"]),
        jnp.asarray(x["v_new"]), scale=0.25, block_size=BS, prefill=prefill)
    got = _port_paged(x, prefill)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=OP_TOL, rtol=0)


@pytest.mark.parametrize("case,cur", [("decode", 13), ("prefill", 0)])
def test_paged_attention_bitwise_equals_cached_attention(case, cur):
    x = _paged_inputs(case, [cur] * B)
    out, nk, nv = _port_paged(x, prefill=case == "prefill")
    ref_out, ref_k, ref_v = tops.cached_attention(
        torch.from_numpy(x["q"]), torch.from_numpy(x["k_cache"]),
        torch.from_numpy(x["v_cache"]), torch.from_numpy(x["k_new"]),
        torch.from_numpy(x["v_new"]), cur, scale=0.25)
    assert np.array_equal(out, ref_out.numpy())
    for i in range(B):  # the written pool rows are the fixed cache's rows
        assert np.array_equal(nk[TABLES[i]].reshape(L, H, D), ref_k.numpy()[i])
        assert np.array_equal(nv[TABLES[i]].reshape(L, H, D), ref_v.numpy()[i])


def test_paged_attention_rejects_unaligned_prefill():
    z = torch.zeros
    with pytest.raises(ValueError, match="multiple of"):
        tops.paged_decode_attention(
            z(1, 5, 2, 4), z(3, 8, 2, 4), z(3, 8, 2, 4), z(1, 2, dtype=torch.int64),
            z(1, dtype=torch.int64), z(1, 5, 2, 4), z(1, 5, 2, 4), scale=0.5,
            block_size=8, prefill=True)


def test_gpt_paged_branch_bitwise_equals_dict_cache(model):
    # the model's paged branch: a prompt then three decode steps through
    # PagedCacheView, against the dict cache; 4 blocks of 8 = max_seq_len,
    # so both caches attend over the same 32 positions
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(1, VOCAB, (2, 16)))
    shape = (2 + 2 * 4, 8, CFG["num_heads"], CFG["hidden_size"] // CFG["num_heads"])
    k_pools = [torch.zeros(shape) for _ in range(CFG["num_layers"])]
    v_pools = [torch.zeros(shape) for _ in range(CFG["num_layers"])]
    tables = torch.tensor([[2, 3, 4, 5], [6, 7, 8, 9]])

    def paged(ids, lens, prefill):
        st = _BatchState(k_pools, v_pools, tables, lens, prefill=prefill)
        views = [PagedCacheView(st, i, 8) for i in range(CFG["num_layers"])]
        return model(ids, caches=views, pos_offset=0 if prefill else lens)

    caches = [{"k": None, "v": None} for _ in range(CFG["num_layers"])]
    with torch.no_grad():
        got = [paged(prompt, torch.zeros(2, dtype=torch.int64), True)]
        want = [model(prompt, caches=caches, pos_offset=0)]
        for pos in range(16, 19):
            nxt = want[-1][:, -1].argmax(-1, keepdim=True)
            got.append(paged(nxt, torch.full((2,), pos), False))
            want.append(model(nxt, caches=caches, pos_offset=pos))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# (c), (d), (e): the engine against the JAX engine, generate() and itself
# ---------------------------------------------------------------------------
def _engine_prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, VOCAB, p) for p in ENGINE_PROMPT_LENS]


def test_engine_matches_jax_engine(models):
    jm, tm = models
    prompts = _engine_prompts()
    jprof.reset_dispatch_counters()
    try:
        jeng = jserving.Engine(jm, jserving.ServingConfig(
            block_size=8, prompt_buckets=[8, 16], num_blocks=24, keep_logits=True))
        ref = jeng.serve(prompts, max_new_tokens=8)
        jeng.close()
    finally:
        jreset_serve_programs()
    got = make_engine(tm, keep_logits=True).serve(prompts, max_new_tokens=8)
    margins = []
    for r, g in zip(ref, got):
        assert r.ok and g.ok
        assert g.tokens == r.tokens
        assert len(g.logits) == len(r.logits) == 8
        for a, b in zip(g.logits, r.logits):
            np.testing.assert_allclose(a, b, atol=LOGITS_TOL, rtol=0)
            top2 = np.sort(b)[-2:]
            margins.append(top2[1] - top2[0])
    # no greedy choice here is a near-tie the tolerance could flip
    assert min(margins) > LOGITS_TOL


def test_engine_tokens_match_generate(model):
    prompts = _engine_prompts()
    resps = make_engine(model).serve(prompts, max_new_tokens=8)
    for p, r in zip(prompts, resps):
        assert r.ok
        assert r.tokens == _generate(model, p, 8)


def _serve_logged(model, prompts, **flags_):
    pt.set_flags(flags_)
    try:
        return make_engine(model, keep_logits=True).serve(prompts, max_new_tokens=6)
    finally:
        pt.set_flags({"FLAGS_serving_capture": True, "FLAGS_serving_capture_donate": True})


@pytest.mark.parametrize("rung", [
    {},  # the captured rung again: replays are deterministic
    {"FLAGS_serving_capture_donate": False},  # the retained rung
    {"FLAGS_serving_capture": False},  # eager
])
def test_execution_rungs_bitwise_equal(model, rung):
    prompts = _engine_prompts()
    base = _serve_logged(model, prompts)
    prof.reset_dispatch_counters()
    other = _serve_logged(model, prompts, **rung)
    for a, b in zip(base, other):
        assert a.ok and b.ok
        assert a.tokens == b.tokens
        assert all(np.array_equal(x, y) for x, y in zip(a.logits, b.logits))
    c = prof.dispatch_counters()
    assert c["serve_capture_fallbacks"] == 0
    if rung.get("FLAGS_serving_capture") is False:
        assert c["serve_capture_builds"] == c["serve_capture_replays"] == 0


def test_retained_rung_failure_leaves_pool_intact(model):
    # the retained rung runs the step on copies of the pool: a fault inside
    # it leaves the pool as it was, and the eager floor completes the step
    pt.set_flags({"FLAGS_serving_capture_donate": False})
    eng = make_engine(model)
    p = _prompt(np.random.default_rng(0))
    rid = eng.submit(p, max_new_tokens=4)
    real, seen = eng._decode_fn, {}

    def failing_once(k_pools, v_pools, *feeds):
        before = [t.clone() for t in eng._pool.k + eng._pool.v]
        out = real(k_pools, v_pools, *feeds)
        if not seen:
            seen["on_copies"] = all(a is not b for a, b in zip(k_pools, eng._pool.k))
            seen["intact"] = all(torch.equal(a, b)
                                 for a, b in zip(before, eng._pool.k + eng._pool.v))
            raise RuntimeError("fault inside the retained rung")
        return out

    eng._decode_fn = failing_once
    eng.run_until_idle()
    assert seen == {"on_copies": True, "intact": True}
    c = prof.dispatch_counters()
    assert c["serve_capture_fallbacks"] == 1 and c["serve_request_requeues"] == 0
    r = eng.pop_response(rid)
    assert r.ok and r.tokens == _generate(model, p, 4)


# ---------------------------------------------------------------------------
# (f): ports of tests/test_serving.py
# ---------------------------------------------------------------------------
def test_steady_state_one_program_per_decode_step(model):
    rng = np.random.default_rng(3)
    prompts = [_prompt(rng) for _ in range(4)]
    eng = make_engine(model, prompt_buckets=[8])
    eng.serve(prompts, max_new_tokens=8)  # warm: builds the programs
    prof.reset_dispatch_counters()
    eng.serve(prompts, max_new_tokens=8)  # steady state
    c = prof.dispatch_counters()
    assert c["serve_capture_builds"] == 0, "steady state re-captured"
    assert c["serve_capture_fallbacks"] == 0
    # every decode step is exactly one captured replay; prefills add one each
    assert c["serve_capture_replays"] == c["serve_decode_steps"] + c["serve_prefills"]
    assert c["serve_decode_steps"] > 0


def test_capture_cache_eviction_counted():
    pt.set_flags({"FLAGS_serving_capture_cache_size": 2})
    for i in range(4):
        lazy.serve_program(("test-evict", i), lambda *a: a)
    assert prof.dispatch_counters()["serve_capture_evictions"] == 2
    assert lazy.serve_capture_state()["cached_programs"] == 2


def test_admission_refusal_at_tight_pool(model):
    # pool capacity 3 blocks: a request needing 4 must be REFUSED up front
    eng = make_engine(model, num_blocks=3)
    rng = np.random.default_rng(0)
    rid = eng.submit(_prompt(rng, 16), max_new_tokens=16)
    r = eng.response(rid)
    assert r is not None and r.status == "rejected"
    assert "overflow" in r.error.lower()
    assert prof.dispatch_counters()["serve_admission_refusals"] == 1
    rid2 = eng.submit(_prompt(rng), max_new_tokens=4)
    eng.run_until_idle()
    assert eng.response(rid2).ok


def test_real_fault_mid_step_recovers_every_group(model):
    # a fault escaping the captured rung zeroes the pool in place and
    # requeues ALL in-flight sequences, including those in other context
    # groups whose decode was still pending this tick
    from paddle_tpu_torch.serving.engine import _PoolsConsumed

    rng = np.random.default_rng(3)
    prompts = [_prompt(rng), _prompt(rng, 16)]
    eng = make_engine(model)
    ids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    pools = [t for t in eng._pool.k + eng._pool.v]
    orig = eng._run_tiered
    state = {"armed": True}

    def boom(key, fn, args):
        if key[0] == "decode" and state["armed"]:
            state["armed"] = False
            raise _PoolsConsumed(RuntimeError("device fault mid-replay"))
        return orig(key, fn, args)

    eng._run_tiered = boom
    eng.run_until_idle()
    c = prof.dispatch_counters()
    assert c["serve_request_requeues"] == 2  # both groups torn down
    assert c["serve_requests_dropped"] == 0
    for p, i in zip(prompts, ids):
        r = eng.response(i)
        assert r.ok and r.tokens == _generate(model, p, 4)
    assert eng._pool.free_blocks == eng._pool.num_blocks
    # zeroed in place: the captured programs' tensors are still the pool's
    assert all(a is b for a, b in zip(pools, eng._pool.k + eng._pool.v))


def test_engine_close_releases_captured_programs(model):
    rng = np.random.default_rng(0)
    eng = make_engine(model)
    eng.serve([_prompt(rng)], max_new_tokens=4)
    eng2 = make_engine(model)
    eng2.serve([_prompt(rng)], max_new_tokens=4)
    before = lazy.serve_capture_state()["cached_programs"]
    eng.close()
    assert lazy.serve_capture_state()["cached_programs"] < before
    prof.reset_dispatch_counters()
    eng2.serve([_prompt(rng)], max_new_tokens=4)
    assert prof.dispatch_counters()["serve_capture_builds"] == 0


def test_backpressure_queues_and_completes(model):
    eng = make_engine(model, prompt_buckets=[8], num_blocks=4)
    rng = np.random.default_rng(0)
    resps = eng.serve([_prompt(rng) for _ in range(6)], max_new_tokens=8)
    assert all(r.ok for r in resps)
    c = prof.dispatch_counters()
    assert c["serve_requests_completed"] == 6
    assert c["serve_requests_dropped"] == 0
    assert eng._pool.free_blocks == eng._pool.num_blocks  # all recycled


def _staggered(eng, prompts, arrivals, n_new):
    """Submit ``arrivals[t]`` prompts before tick t, step until idle; returns
    the responses and the queue depth after every tick."""
    ids, depth, left, t = [], [], iter(prompts), 0
    while t < len(arrivals) or eng.pending:
        if t < len(arrivals):
            ids += [eng.submit(next(left), max_new_tokens=n_new) for _ in range(arrivals[t])]
        eng.step()
        depth.append(eng.routing_signals()["queue_depth"])
        t += 1
    eng.run_until_idle()
    return [eng.pop_response(i) for i in ids], depth


@pytest.mark.parametrize("capture", [True, False], ids=["captured", "eager"])
def test_staggered_arrivals_batch_continuously(model, capture):
    # requests arrive while others decode, into a pool of 8 blocks (4
    # two-block sequences at once): admissions land mid-decode, the decode
    # batch grows and shrinks, backpressure queues the rest, and every
    # request still gets generate()'s tokens (bitwise on the CPU)
    pt.set_flags({"FLAGS_serving_capture": capture})
    rng = np.random.default_rng(5)
    prompts = [_prompt(rng, n) for n in (8, 5, 8, 3, 8, 6, 8, 7, 4, 8)]
    eng = make_engine(model, prompt_buckets=[8], num_blocks=8)
    resps, depth = _staggered(eng, prompts, [2, 0, 1, 3, 0, 2, 2], 6)
    rows = {len(t.request_ids) for t in eng.step_timings() if t.kind == "decode"}
    order = [t.kind for t in eng.step_timings()]
    assert max(depth) > 0  # backpressure fired
    assert len(rows) >= 3  # the batch changed size
    assert "prefill" in order[order.index("decode"):]  # admitted mid-decode
    for p, r in zip(prompts, resps):
        assert r.ok and r.tokens == _generate(model, p, 6)
    c = prof.dispatch_counters()
    assert c["serve_requests_dropped"] == c["serve_block_leaks"] == 0
    assert eng._pool.free_blocks == eng._pool.num_blocks


def test_cache_overflow_is_request_level(model):
    # fixed-shape path: the overflow is a structured CacheOverflow ...
    small = GPTForPretraining(GPTConfig(**dict(CFG, max_seq_len=8)), device="cpu").eval()
    caches = [{"k": None, "v": None} for _ in range(CFG["num_layers"])]
    with torch.no_grad():
        small(torch.arange(8)[None, :], caches=caches, pos_offset=0)
        with pytest.raises(CacheOverflow) as ei:
            small(torch.tensor([[1]]), caches=caches, pos_offset=7)
    assert isinstance(ei.value, ValueError)
    assert ei.value.need == 9 and ei.value.capacity == 8
    # ... and the scheduler turns it into a per-request response
    eng = make_engine(model, num_blocks=2)
    rng = np.random.default_rng(0)
    bad = eng.submit(_prompt(rng, 16), max_new_tokens=8)  # 3 blocks
    ok = eng.submit(_prompt(rng), max_new_tokens=4)  # 2 blocks
    eng.run_until_idle()
    rb, ro = eng.response(bad), eng.response(ok)
    assert rb.status == "rejected" and "overflow" in rb.error.lower()
    assert ro.ok


def test_drain_completes_submitted_rejects_new(model):
    eng = make_engine(model, prompt_buckets=[8])
    rng = np.random.default_rng(0)
    ids = [eng.submit(_prompt(rng), max_new_tokens=6) for _ in range(3)]
    eng.step()
    eng.begin_drain()
    late = eng.submit(_prompt(rng))
    eng.run_until_idle()
    assert all(eng.response(i).ok for i in ids)
    assert eng.response(late).status == "rejected"
    c = prof.dispatch_counters()
    assert c["serve_preempt_drains"] == 1
    assert c["serve_requests_dropped"] == 0


@pytest.mark.parametrize("prompt_buckets,decode_batch_buckets", [
    ([128, 32], None), (None, [8, 2]), ([8, 0], None)])
def test_config_bucket_lists_validated(model, prompt_buckets, decode_batch_buckets):
    with pytest.raises(ValueError, match="ascending"):
        make_engine(model, prompt_buckets=prompt_buckets,
                    decode_batch_buckets=decode_batch_buckets)


def test_prompt_bucket_must_be_a_block_multiple(model):
    with pytest.raises(ValueError, match="multiple"):
        make_engine(model, prompt_buckets=[12])


def test_serve_evicts_responses_and_counts_outcomes(model):
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    rs = eng.serve([_prompt(rng) for _ in range(2)], max_new_tokens=3)
    assert all(r.ok for r in rs)
    assert all(eng.response(r.request_id) is None for r in rs)
    assert eng.stats()["completed"] == 2


def test_engine_stats_and_flags_surface(model):
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    eng.serve([_prompt(rng)], max_new_tokens=4)
    st = eng.stats()
    assert st["completed"] == 1
    assert st["token_lat_p50_ms"] is not None
    assert st["token_lat_p99_ms"] >= st["token_lat_p50_ms"]
    assert 0.0 < st["pool_peak_occupancy"] <= 1.0
    assert st["capture"]["cached_programs"] >= 2
    names = {d["name"] for d in describe_flags("serving")}
    assert {"FLAGS_serving_block_size", "FLAGS_serving_num_blocks",
            "FLAGS_serving_prompt_buckets", "FLAGS_serving_decode_batch_buckets",
            "FLAGS_serving_capture", "FLAGS_serving_capture_donate",
            "FLAGS_serving_capture_cache_size", "FLAGS_serving_max_new_tokens",
            "FLAGS_serving_request_retries", "FLAGS_serving_default_deadline_ms",
            "FLAGS_serving_deadline_partial", "FLAGS_serving_queue_max",
            "FLAGS_serving_queue_wait_p99_ms", "FLAGS_serving_max_engine_restarts"} == names
    assert all(d["doc"] for d in describe_flags("serving"))
    # the same names and defaults as the JAX package's flags
    jdocs = {d["name"]: d["default"] for d in paddle.core.flags.describe_flags("serving")}
    for d in describe_flags("serving") + describe_flags("memory_budget_mb"):
        assert jdocs.get(d["name"], d["default"]) == d["default"], d["name"]
    sig = eng.routing_signals()
    assert sig["health"] == "ready" and sig["queue_depth"] == 0
    assert sig["prefill_ema_ms"] is not None


def test_step_timings_record_every_token(model):
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    rs = eng.serve([_prompt(rng, n) for n in ENGINE_PROMPT_LENS], max_new_tokens=4)
    steps = eng.step_timings()
    c = prof.dispatch_counters()
    assert sum(t.kind == "prefill" for t in steps) == c["serve_prefills"] == len(rs)
    assert sum(t.kind == "decode" for t in steps) == c["serve_decode_steps"]
    # every generated token is one row of one recorded step, in order
    per_request = {}
    for t in steps:
        assert t.batch >= len(t.request_ids) >= 1
        for rid in t.request_ids:
            per_request[rid] = per_request.get(rid, 0) + 1
    assert per_request == {r.request_id: len(r.tokens) for r in rs}
    assert [t.end for t in steps] == sorted(t.end for t in steps)
    assert all(min(t.feed_ms, t.launch_ms, t.wait_ms) >= 0 and t.device_ms is None
               for t in steps)  # no CUDA events on the CPU
    # the latency histogram observes one sample per recorded row
    assert eng.stats()["token_lat_count"] == sum(len(t.request_ids) for t in steps)
    eng.reset_stats()
    assert eng.step_timings() == [] and eng.stats()["token_lat_count"] == 0


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "constant"])
def test_histogram_quantiles_match_jax(dist):
    # the port's copy of the streaming histogram gives the JAX one's
    # estimates exactly (same buckets, same interpolation)
    from paddle_tpu.profiler.metrics import Histogram as JHistogram
    from paddle_tpu_torch.profiler.metrics import Histogram

    rng = np.random.default_rng(3)
    samples = {"lognormal": rng.lognormal(1.0, 1.0, 500),
               "uniform": rng.uniform(0.01, 50.0, 500),
               "constant": np.full(20, 4.2)}[dist]
    ours, theirs = Histogram(), JHistogram("h")
    for v in samples:
        ours.observe(v)
        theirs.observe(v)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    assert ours.count == theirs.count == len(samples)


def test_embeddings_accept_per_row_offset_tensor(model):
    ids = torch.tensor([[3], [4]])
    with torch.no_grad():
        h = model.gpt.embeddings(ids, pos_offset=torch.tensor([5, 9]))
        h0 = model.gpt.embeddings(ids[0:1], pos_offset=5)
        h1 = model.gpt.embeddings(ids[1:2], pos_offset=9)
    assert torch.equal(h[0], h0[0]) and torch.equal(h[1], h1[0])


def test_budgeted_pool_raises_not_ported(model):
    pt.set_flags({"FLAGS_memory_budget_mb": 3.0})
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        make_engine(model, num_blocks=0)
    pt.set_flags({"FLAGS_memory_budget_mb": 0.0})
    assert make_engine(model, num_blocks=0)._pool.num_blocks == 256


def test_create_engine_and_default_device(model):
    eng = serving.create_engine(model, block_size=8, prompt_buckets=[8], num_blocks=8)
    assert eng._pool.k[0].device.type == "cpu" and eng._pool.num_blocks == 8
    assert len(eng._pool.k) == CFG["num_layers"]


# ---------------------------------------------------------------------------
# (g): ports of tests/test_serving_overload.py that need no fault injection
# ---------------------------------------------------------------------------
def test_deadline_expiry_in_queue(model):
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    rid = eng.submit(_prompt(rng), max_new_tokens=4, deadline_ms=5.0)
    eng._now = lambda: time.time() + 10.0  # virtual clock: deadline passed
    eng.run_until_idle()
    r = eng.pop_response(rid)
    assert r.status == "timeout" and not r.ok
    assert r.tokens == [] and "queued" in r.error
    c = prof.dispatch_counters()
    assert c["serve_deadline_expired"] == 1
    assert c["serve_expire_stages"]["queued"] == 1
    assert c["serve_prefills"] == 0
    assert eng._pool.free_blocks == eng._pool.num_blocks
    assert c["serve_block_leaks"] == 0


def test_deadline_expiry_at_prefill_pop(model):
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    rid = eng.submit(_prompt(rng), max_new_tokens=4, deadline_ms=50.0)
    base = eng._queue.peek().submit_time
    clock = iter([base + 0.001, base + 10.0])  # alive at the scan, expired at the pop
    eng._now = lambda: next(clock, base + 10.0)
    eng.run_until_idle()
    assert eng.pop_response(rid).status == "timeout"
    c = prof.dispatch_counters()
    assert dict(c["serve_expire_stages"]) == {"prefill": 1}
    assert c["serve_prefills"] == 0
    assert eng._pool.free_blocks == eng._pool.num_blocks


@pytest.mark.parametrize("partial", [True, False])
def test_deadline_expiry_mid_decode(model, partial):
    rng = np.random.default_rng(3)
    p = _prompt(rng)
    clean = _generate(model, p, 8)
    pt.set_flags({"FLAGS_serving_deadline_partial": partial})
    eng = make_engine(model)
    rid = eng.submit(p, max_new_tokens=8, deadline_ms=60_000.0)
    eng.step()  # prefill + first decode
    eng.step()
    (seq,) = eng._active
    assert 2 <= len(seq.tokens) < 8
    eng._now = lambda: time.time() + 120.0
    eng.run_until_idle()
    r = eng.pop_response(rid)
    assert r.status == "timeout"
    if partial:  # the partial output is the prefix of the full run
        assert len(r.tokens) >= 2 and r.tokens == clean[:len(r.tokens)]
    else:
        assert r.tokens == []
    c = prof.dispatch_counters()
    assert c["serve_expire_stages"]["decode"] == 1
    assert eng._pool.free_blocks == eng._pool.num_blocks
    assert c["serve_block_leaks"] == 0


def test_default_deadline_flag_applies(model):
    pt.set_flags({"FLAGS_serving_default_deadline_ms": 7.5})
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    rid = eng.submit(_prompt(rng), max_new_tokens=4)
    assert eng._queue.peek().deadline_ms == 7.5
    rid2 = eng.submit(_prompt(rng), max_new_tokens=4, deadline_ms=9999.0)
    assert any(r.deadline_ms == 9999.0 for r in eng._queue)
    rid3 = eng.submit(_prompt(rng), max_new_tokens=4, deadline_ms=0)  # opt-out
    assert any(r.request_id == rid3 and r.deadline_ms is None for r in eng._queue)
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.submit(_prompt(rng), max_new_tokens=4, deadline_ms=-1)
    eng.run_until_idle()
    assert eng.response(rid) is not None and eng.response(rid2) is not None
    assert eng.response(rid3).ok


def test_expired_decode_row_does_not_perturb_neighbors(model):
    rng = np.random.default_rng(5)
    p_live, p_dead = _prompt(rng), _prompt(rng)
    clean_live = _generate(model, p_live, 8)
    eng = make_engine(model)
    rid_live = eng.submit(p_live, max_new_tokens=8)
    rid_dead = eng.submit(p_dead, max_new_tokens=8, deadline_ms=60_000.0)
    eng.step()
    eng.step()
    base = time.time()
    eng._now = lambda: base + 120.0  # only p_dead has a deadline
    eng.run_until_idle()
    assert eng.pop_response(rid_dead).status == "timeout"
    r = eng.pop_response(rid_live)
    assert r.ok and r.tokens == clean_live


def test_queue_cap_sheds_with_structured_overloaded(model):
    pt.set_flags({"FLAGS_serving_queue_max": 2})
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    ids = [eng.submit(_prompt(rng), max_new_tokens=2) for _ in range(4)]
    shed = [eng.response(i) for i in ids if eng.response(i) is not None]
    assert len(shed) == 2
    for r in shed:
        assert r.status == "overloaded" and r.retriable and "queue" in r.error
    c = prof.dispatch_counters()
    assert c["serve_requests_shed"] == 2
    assert c["serve_shed_reasons"]["queue_full"] == 2
    eng.run_until_idle()
    done = [eng.response(i) for i in ids]
    assert sum(1 for r in done if r.ok) == 2
    assert all(r is not None for r in done)


def test_predicted_deadline_miss_sheds_at_submit(model):
    eng = make_engine(model)
    eng._admission.note_prefill(8, 100.0)
    eng._admission.note_decode(100.0, 1)
    rng = np.random.default_rng(0)
    rid = eng.submit(_prompt(rng), max_new_tokens=8, deadline_ms=50.0)
    r = eng.response(rid)
    assert r is not None and r.status == "overloaded" and r.retriable
    assert "predicted" in r.error
    assert prof.dispatch_counters()["serve_shed_reasons"]["predicted_deadline_miss"] == 1
    rid2 = eng.submit(_prompt(rng), max_new_tokens=2, deadline_ms=1e9)
    eng.run_until_idle()
    assert eng.response(rid2).ok


def test_queue_wait_trip_wire_sheds_batch_first(model):
    pt.set_flags({"FLAGS_serving_queue_wait_p99_ms": 5.0})
    eng = make_engine(model)
    for _ in range(10):
        eng._admission.note_queue_wait(500.0)
    rng = np.random.default_rng(0)
    b = eng.submit(_prompt(rng), max_new_tokens=2, priority="batch")
    rb = eng.response(b)
    assert rb is not None and rb.status == "overloaded"
    assert "batch sheds first" in rb.error
    i = eng.submit(_prompt(rng), max_new_tokens=2, priority="interactive")
    assert eng.response(i) is None  # queued, not shed
    eng.run_until_idle()
    assert eng.response(i).ok
    assert prof.dispatch_counters()["serve_shed_reasons"]["queue_p99"] == 1


def test_non_head_queued_request_expires(model):
    eng = make_engine(model, num_blocks=4)  # one admitted sequence at a time
    rng = np.random.default_rng(0)
    head = eng.submit(_prompt(rng), max_new_tokens=8)
    dead = eng.submit(_prompt(rng), max_new_tokens=8, deadline_ms=60_000.0)
    base = time.time()
    eng._now = lambda: base + 120.0
    eng.step()
    r = eng.response(dead)
    assert r is not None and r.status == "timeout"
    assert prof.dispatch_counters()["serve_expire_stages"]["queued"] == 1
    eng.run_until_idle()
    assert eng.response(head).ok


def test_trip_wire_recovers_after_storm(model):
    pt.set_flags({"FLAGS_serving_queue_wait_p99_ms": 50.0})
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    for _ in range(10):
        eng._admission.note_queue_wait(500.0)
    b1 = eng.submit(_prompt(rng), max_new_tokens=2, priority="batch")
    assert eng.response(b1).status == "overloaded"
    for _ in range(130):
        eng._admission.note_queue_wait(1.0)
    b2 = eng.submit(_prompt(rng), max_new_tokens=2, priority="batch")
    assert eng.response(b2) is None
    eng.run_until_idle()
    assert eng.response(b2).ok


def test_interactive_pops_ahead_of_batch():
    q = serving.RequestQueue()
    rb = serving.Request(prompt=np.ones(4), max_new_tokens=1, priority="batch")
    ri = serving.Request(prompt=np.ones(4), max_new_tokens=1, priority="interactive")
    q.push(rb)
    q.push(ri)
    assert q.peek() is ri and q.pop() is ri
    assert q.pop() is rb and q.pop() is None
    with pytest.raises(ValueError, match="priority"):
        serving.Request(prompt=np.ones(4), max_new_tokens=1, priority="bulk")


def test_batch_backlog_includes_interactive_but_not_vice_versa(model):
    eng = make_engine(model, num_blocks=4)
    eng._admission.note_prefill(8, 10.0)
    eng._admission.note_decode(10.0, 1)
    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.submit(_prompt(rng), max_new_tokens=8, deadline_ms=1e9, priority="batch")
    b = eng.submit(_prompt(rng), max_new_tokens=8, deadline_ms=200.0, priority="batch")
    i = eng.submit(_prompt(rng), max_new_tokens=8, deadline_ms=200.0, priority="interactive")
    rb, ri = eng.response(b), eng.response(i)
    assert rb is not None and rb.status == "overloaded"
    assert ri is None
    eng._now = lambda: time.time() + 1e4
    eng.run_until_idle()
    assert eng.response(i) is not None


def test_health_transitions(model):
    from paddle_tpu_torch.serving.engine import _PoolsConsumed

    eng = make_engine(model)
    assert eng.health == "warming"
    rng = np.random.default_rng(0)
    eng.serve([_prompt(rng)], max_new_tokens=2)
    assert eng.health == "ready"
    eng._recover_pools(_PoolsConsumed(RuntimeError("forced")))  # a pool rebuild
    assert eng.health == "degraded"
    for _ in range(10):  # a cooldown of clean ticks re-promotes
        eng.step()
    assert eng.health == "ready"
    eng.begin_drain()
    assert eng.health == "draining" and not eng.serviceable()
    eng.close()
    assert eng.health == "dead"
    assert eng.response(eng.submit(_prompt(rng))).status == "rejected"
    assert prof.dispatch_counters()["serve_health_transitions"] == 4


def test_block_leak_audit_counts_and_repairs(model):
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    eng.serve([_prompt(rng)], max_new_tokens=2)
    assert prof.dispatch_counters()["serve_block_leaks"] == 0
    assert eng._pool.alloc(3) is not None  # an exit path that forgot its blocks
    eng.run_until_idle()
    assert prof.dispatch_counters()["serve_block_leaks"] == 3
    assert eng._pool.free_blocks == eng._pool.num_blocks


# ---------------------------------------------------------------------------
# (h): serving under faults, against the JAX engine
# ---------------------------------------------------------------------------
FAULT_COUNTERS = ("injected_faults", "retry_attempts", "ladder_demotions",
                  "serve_capture_fallbacks")


def _serve_faulted_jax(jm, spec, prompts):
    jres.reset()
    jprof.reset_dispatch_counters()
    paddle.set_flags({"FLAGS_fault_inject": spec, "FLAGS_retry_backoff_ms": 0.5})
    try:
        jeng = jserving.Engine(jm, jserving.ServingConfig(
            block_size=8, prompt_buckets=[8, 16], num_blocks=24))
        resps = jeng.serve(prompts, max_new_tokens=8)
        jeng.close()
        return resps, dict(jprof.dispatch_counters())
    finally:
        paddle.set_flags({"FLAGS_fault_inject": "", "FLAGS_retry_backoff_ms": 5.0})
        jres.reset()
        jreset_serve_programs()


def _serve_faulted(tm, spec, prompts, **kw):
    pt.resilience.reset()
    prof.reset_dispatch_counters()
    pt.set_flags({"FLAGS_fault_inject": spec, "FLAGS_retry_backoff_ms": 0.5})
    try:
        eng = make_engine(tm, **kw)
        resps = eng.serve(prompts, max_new_tokens=8)
        return resps, dict(prof.dispatch_counters()), eng
    finally:
        pt.set_flags({"FLAGS_fault_inject": "", "FLAGS_retry_backoff_ms": 5.0})
        pt.resilience.reset()


@pytest.mark.parametrize("spec", ["execute:p=0.2", "execute:p=1:x=3:decode",
                                  "execute:p=1:x=1:prefill"])
def test_faulted_serve_matches_jax_engine(models, spec):
    jm, tm = models
    prompts = _engine_prompts()
    ref, jc = _serve_faulted_jax(jm, spec, prompts)
    got, c, _ = _serve_faulted(tm, spec, prompts)
    clean = [_generate(tm, p, 8) for p in prompts]
    assert all(r.ok for r in ref) and all(g.ok for g in got)
    assert [g.tokens for g in got] == [r.tokens for r in ref] == clean
    assert c["serve_requests_dropped"] == c["serve_block_leaks"] == 0
    assert c["injected_faults"] > 0
    if spec != "execute:p=0.2":
        # the targeted specs fire only at the rungs both engines share; the
        # untargeted one also fires at the JAX floor's per-op sites, which
        # the port's floor has as one 'op' site
        assert {k: c[k] for k in FAULT_COUNTERS} == {k: jc[k] for k in FAULT_COUNTERS}
    if spec == "execute:p=1:x=3:decode":
        assert c["ladder_demotions"] >= 1 and c["serve_capture_fallbacks"] > 0
    if spec == "execute:p=1:x=1:prefill":
        assert c["retry_attempts"] > 0


def test_fault_injection_serve_bitwise_to_clean(model):
    prompts = _engine_prompts()
    clean = _serve_logged(model, prompts)
    pt.set_flags({"FLAGS_fault_inject": "execute:p=0.2", "FLAGS_retry_backoff_ms": 0.5})
    faulted = make_engine(model, keep_logits=True).serve(prompts, max_new_tokens=6)
    assert prof.dispatch_counters()["injected_faults"] > 0
    for a, b in zip(clean, faulted):
        assert b.ok and a.tokens == b.tokens
        assert all(np.array_equal(x, y) for x, y in zip(a.logits, b.logits))


def test_storm_demotes_then_cooldown_repromotes_and_replays(model):
    prompts = _engine_prompts()
    pt.set_flags({"FLAGS_fault_inject": "execute:p=1:x=3:decode",
                  "FLAGS_retry_backoff_ms": 0.5, "FLAGS_ladder_cooldown_steps": 3})
    try:
        eng = make_engine(model)
        stormed = eng.serve(prompts, max_new_tokens=8)
        assert prof.dispatch_counters()["ladder_demotions"] >= 1
        demoted = [t for t in eng.step_timings()
                   if t.kind == "decode" and t.rung != "captured"]
        assert demoted and {t.rung for t in demoted} <= {"retained", "eager"}
        # the clean serve after the storm: the demoted buckets run retained
        # until FLAGS_ladder_cooldown_steps clean ticks re-promote them, then
        # their graphs replay again
        pt.set_flags({"FLAGS_fault_inject": ""})
        eng.reset_stats()
        prof.reset_dispatch_counters()
        again = eng.serve(prompts, max_new_tokens=8)
    finally:
        pt.set_flags({"FLAGS_ladder_cooldown_steps": 8})
    c = prof.dispatch_counters()
    rungs = [t.rung for t in eng.step_timings() if t.kind == "decode"]
    assert c["ladder_promotions"] >= 1 and c["serve_capture_replays"] > 0
    assert "retained" in rungs and rungs[-1] == "captured"
    assert rungs.index("captured") > rungs.index("retained")
    assert [r.tokens for r in again] == [r.tokens for r in stormed]
    assert [r.tokens for r in again] == [_generate(model, p, 8) for p in prompts]


def test_request_requeue_on_floor_failure(model):
    # a storm that exhausts every rung INCLUDING the eager floor errors the
    # request after its retry budget: an error RESPONSE, never a drop
    pt.set_flags({"FLAGS_serving_request_retries": 1})
    rng = np.random.default_rng(3)
    (r,), c, _ = _serve_faulted(model, "execute:p=1:x=9", [_prompt(rng)])
    assert r.status == "error" and r.error
    assert c["serve_request_requeues"] >= 1
    assert c["serve_requests_dropped"] == 0
    assert dict(c["fault_sites"]).get("op", 0) > 0  # the floor is a site


def test_pool_consumed_after_replay_recovers(model):
    # a real fault raised AFTER the captured rung wrote the pool: recovery
    # zeroes the pool in place and requeues every in-flight sequence
    rng = np.random.default_rng(3)
    prompts = [_prompt(rng), _prompt(rng, 16)]
    eng = make_engine(model)
    ids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    real = lazy._ServeProgram._captured
    state = {"armed": True}

    def fails_after_write(prog, k_pools, v_pools, feeds):
        out = real(prog, k_pools, v_pools, feeds)
        if prog.key[0] == "decode" and state["armed"]:
            state["armed"] = False
            raise RuntimeError("device fault after the replay wrote the pool")
        return out

    pools = list(eng._pool.k + eng._pool.v)
    lazy._ServeProgram._captured = fails_after_write
    try:
        eng.run_until_idle()
    finally:
        lazy._ServeProgram._captured = real
    c = prof.dispatch_counters()
    assert c["serve_capture_fallbacks"] == 1 and c["fatal_faults"] == 1
    assert c["serve_request_requeues"] == 2 and c["serve_requests_dropped"] == 0
    for p, i in zip(prompts, ids):
        r = eng.response(i)
        assert r.ok and r.tokens == _generate(model, p, 4)
    assert all(a is b for a, b in zip(pools, eng._pool.k + eng._pool.v))
    assert eng.health == "degraded"


def test_no_leaks_under_mixed_storm(model):
    # sheds + expiries + faults + requeues in one run: every exit path
    # recycles its blocks and every request ends terminal
    pt.set_flags({"FLAGS_fault_inject": "execute:p=0.2", "FLAGS_retry_backoff_ms": 0.5,
                  "FLAGS_serving_queue_max": 4})
    eng = make_engine(model, num_blocks=8)
    rng = np.random.default_rng(1)
    ids = []
    for k in range(10):
        ids.append(eng.submit(
            _prompt(rng), max_new_tokens=4,
            deadline_ms=5.0 if k % 3 == 0 else None,
            priority="batch" if k % 2 else "interactive"))
    eng.run_until_idle()
    statuses = [eng.response(i).status for i in ids]  # no Nones: terminal
    assert set(statuses) <= {"ok", "timeout", "overloaded", "error", "rejected"}
    c = prof.dispatch_counters()
    assert c["serve_requests_dropped"] == c["serve_block_leaks"] == 0
    assert eng._pool.free_blocks == eng._pool.num_blocks


def test_serve_events_in_the_flight_recorder(model):
    trace.clear()
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    eng.serve([_prompt(rng), _prompt(rng)], max_new_tokens=3)
    eng.submit(_prompt(rng, 64), max_new_tokens=4)  # rejected: past max positions
    phases = [e.attrs["phase"] for e in trace.events(kind="serve")]
    for phase in ("admit", "prefill", "decode", "complete", "health", "reject"):
        assert phase in phases, phase
    assert trace.events(kind="serve")[-1].attrs["phase"] == "reject"
    lanes = [e for e in trace.chrome_trace_events() if e["name"] == "request"]
    assert {e["ph"] for e in lanes} == {"b", "n", "e"}


# ---------------------------------------------------------------------------
# (i): ports of tests/test_serving_overload.py's supervisor and health tests
# ---------------------------------------------------------------------------
def test_supervisor_restarts_on_tick_exception_bitwise(model):
    rng = np.random.default_rng(3)
    prompts = [_prompt(rng) for _ in range(3)]
    clean = [_generate(model, p, 6) for p in prompts]
    eng = make_engine(model)
    sup = serving.Supervisor(eng)
    try:
        ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        orig = eng._decode_batch
        state = {"armed": True}

        def wedge(chunk, n_blk):
            if state["armed"]:
                state["armed"] = False
                raise RuntimeError("tick bug escaped the ladder")
            return orig(chunk, n_blk)

        eng._decode_batch = wedge
        sup.run_until_idle()
        resps = [eng.pop_response(i) for i in ids]
    finally:
        sup.close()
    assert sup.restarts == 1
    assert [r.tokens for r in resps] == clean
    assert all(r.ok for r in resps)
    c = prof.dispatch_counters()
    assert c["serve_engine_restarts"] == 1
    assert c["serve_requests_dropped"] == c["serve_block_leaks"] == 0
    assert eng._pool.free_blocks == eng._pool.num_blocks
    assert sup.state()["last_restart_error"] == "RuntimeError: tick bug escaped the ladder"


def test_supervisor_restart_budget_fails_clean(model, tmp_path):
    pt.set_flags({"FLAGS_postmortem_dir": str(tmp_path)})
    rng = np.random.default_rng(0)
    eng = make_engine(model)
    sup = serving.Supervisor(eng, max_restarts=2)
    try:
        ids = [eng.submit(_prompt(rng), max_new_tokens=4) for _ in range(3)]

        def always_wedged(chunk, n_blk):
            raise RuntimeError("permanently wedged")

        eng._decode_batch = always_wedged
        sup.run_until_idle()  # must RETURN — fail clean, never hang
    finally:
        sup.close()
    assert sup.restarts == 3  # 2 restarts + the final over-budget attempt
    assert eng.health == "dead"
    for i in ids:
        r = eng.response(i)
        assert r is not None and r.status == "error"
        assert "restarts" in r.error
    late = eng.submit(_prompt(rng), max_new_tokens=2)
    assert eng.response(late).status == "rejected"
    c = prof.dispatch_counters()
    assert c["serve_engine_restarts"] == 2  # the budgeted ones
    assert c["serve_requests_dropped"] == c["serve_block_leaks"] == 0
    doc = trace.read_postmortem(trace.last_postmortem_path())
    assert doc["reason"] == "engine_dead" and doc["attrs"]["restarts"] == 2
    assert doc["exception"]["message"] == "permanently wedged"


def _serve_supervised_until_dead(model, tmp_path, tick_error, restart_error=None):
    """Three requests under a Supervisor whose engine's first decode tick
    raises ``tick_error``; with ``restart_error`` set, zeroing the pool in
    the restart raises it. Returns (engine, supervisor, responses, restarts
    attempted)."""
    pt.set_flags({"FLAGS_postmortem_dir": str(tmp_path)})
    rng = np.random.default_rng(0)
    eng = make_engine(model)
    sup = serving.Supervisor(eng)
    attempted = []
    real_restart = eng.restart

    def restart(err):
        attempted.append(err)
        real_restart(err)

    def wedged(chunk, n_blk):
        raise tick_error

    def reset_storage():
        raise restart_error

    eng.restart, eng._decode_batch = restart, wedged
    if restart_error is not None:
        eng._pool.reset_storage = reset_storage
    try:
        ids = [eng.submit(_prompt(rng), max_new_tokens=4) for _ in range(3)]
        sup.run_until_idle()  # must RETURN with every request answered
    finally:
        sup.close()
    return eng, sup, [eng.response(i) for i in ids], attempted


def test_supervisor_fails_clean_when_restart_raises(model, tmp_path):
    # a restart that cannot zero the pool must not strand the requests it
    # requeued: the engine fails clean instead
    lost = RuntimeError("CUDA error: an illegal memory access was encountered")
    eng, sup, resps, attempted = _serve_supervised_until_dead(
        model, tmp_path, RuntimeError("tick bug escaped the ladder"), restart_error=lost)
    assert len(attempted) == 1 and sup.restarts == 1
    assert eng.health == "dead"
    assert all(r is not None and r.status == "error" for r in resps)
    assert all("its restart failed" in r.error for r in resps)
    c = prof.dispatch_counters()
    assert c["serve_requests_dropped"] == c["serve_block_leaks"] == 0
    assert eng._pool.free_blocks == eng._pool.num_blocks
    doc = trace.read_postmortem(trace.last_postmortem_path())
    assert doc["reason"] == "engine_dead" and doc["exception"]["message"] == str(lost)


def test_supervisor_sticky_cuda_error_fails_clean_without_restart(model, tmp_path):
    # a CUDA error escaping the tick means a lost context: no restart is
    # tried (its own device work would raise again), every request errors
    lost = RuntimeError("CUDA error: an illegal memory access was encountered")
    eng, sup, resps, attempted = _serve_supervised_until_dead(model, tmp_path, lost)
    assert not attempted and sup.restarts == 1
    assert eng.health == "dead"
    assert all(r is not None and r.status == "error" for r in resps)
    assert all("CUDA context is lost" in r.error for r in resps)
    c = prof.dispatch_counters()
    assert c["serve_engine_restarts"] == 0
    assert c["serve_requests_dropped"] == c["serve_block_leaks"] == 0
    assert eng._pool.free_blocks == eng._pool.num_blocks
    late = eng.submit(_prompt(np.random.default_rng(1)), max_new_tokens=2)
    assert eng.response(late).status == "rejected"


def test_supervisor_consumes_stall_watchdog(model):
    # a tick that trips the stall watchdog AND makes no observable progress
    # is a wedge: the supervisor restarts the engine
    rng = np.random.default_rng(3)
    prompts = [_prompt(rng) for _ in range(2)]
    clean = [_generate(model, p, 4) for p in prompts]
    pt.set_flags({"FLAGS_trace_stall_ms": 40.0})
    eng = make_engine(model)
    sup = serving.Supervisor(eng)
    try:
        ids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.step()  # a healthy tick arms the watchdog heartbeat
        orig = eng._decode_batch
        state = {"armed": True}

        def wedged_tick(chunk, n_blk):
            if state["armed"]:
                state["armed"] = False
                time.sleep(0.25)  # way past FLAGS_trace_stall_ms...
                return True       # ...and NOTHING decoded: a true wedge
            return orig(chunk, n_blk)

        eng._decode_batch = wedged_tick
        sup.run_until_idle()
        resps = [eng.pop_response(i) for i in ids]
    finally:
        sup.close()
    assert sup.restarts >= 1
    assert all(r.ok for r in resps)
    assert [r.tokens for r in resps] == clean
    assert prof.dispatch_counters()["serve_requests_dropped"] == 0
    assert trace.heartbeat_age_ms(f"serve[{eng._uid}]") is None  # disarmed at idle


def test_slow_but_productive_tick_is_not_a_wedge(model):
    rng = np.random.default_rng(3)
    pt.set_flags({"FLAGS_trace_stall_ms": 40.0})
    eng = make_engine(model)
    sup = serving.Supervisor(eng)
    try:
        ids = [eng.submit(_prompt(rng), max_new_tokens=4) for _ in range(2)]
        eng.step()  # arm the heartbeat
        orig = eng._decode_batch
        state = {"armed": True}

        def slow_tick(chunk, n_blk):
            if state["armed"]:
                state["armed"] = False
                time.sleep(0.25)  # trips the watchdog...
            return orig(chunk, n_blk)  # ...but the decode happens

        eng._decode_batch = slow_tick
        sup.run_until_idle()
        resps = [eng.pop_response(i) for i in ids]
    finally:
        sup.close()
    assert sup.restarts == 0
    assert all(r.ok for r in resps)
    assert any(e.attrs.get("phase") == "stall_benign" for e in trace.events(kind="serve"))


def test_restart_requeues_do_not_burn_request_retries(model):
    # the engine wedged, not the request: with default budgets
    # (request_retries=2 < max_engine_restarts=3) an in-flight request
    # survives all three in-budget restarts and finishes with its tokens
    rng = np.random.default_rng(3)
    prompts = [_prompt(rng) for _ in range(2)]
    clean = [_generate(model, p, 4) for p in prompts]
    eng = make_engine(model)
    sup = serving.Supervisor(eng)
    try:
        ids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        orig = eng._decode_batch
        state = {"wedges": 3}

        def wedge(chunk, n_blk):
            if state["wedges"]:
                state["wedges"] -= 1
                raise RuntimeError("wedge")
            return orig(chunk, n_blk)

        eng._decode_batch = wedge
        sup.run_until_idle()
        resps = [eng.pop_response(i) for i in ids]
    finally:
        sup.close()
    assert sup.restarts == 3
    assert all(r.ok for r in resps)
    assert [r.tokens for r in resps] == clean


def test_restart_and_fail_clean_health(model):
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    eng.serve([_prompt(rng)], max_new_tokens=2)
    assert eng.health == "ready"
    eng.restart(RuntimeError("forced"))
    assert eng.health == "degraded" and eng.stats()["restarts"] == 1
    for _ in range(10):  # cooldown of clean ticks re-promotes
        eng.step()
    assert eng.health == "ready"
    eng.begin_drain()
    assert eng.health == "draining" and not eng.serviceable()
    eng.fail_clean(RuntimeError("done"))
    assert eng.health == "dead"
    assert prof.dispatch_counters()["serve_health_transitions"] >= 5


def test_health_events_explain_transitions(model):
    trace.clear()
    eng = make_engine(model)
    rng = np.random.default_rng(0)
    eng.serve([_prompt(rng)], max_new_tokens=2)
    eng.restart(RuntimeError("forced"))
    health = [e.attrs for e in trace.events(kind="serve") if e.attrs.get("phase") == "health"]
    assert [h["state"] for h in health[:2]] == ["ready", "degraded"]
    assert health[1]["why"] == "engine restart: RuntimeError"
    assert health[1]["prev"] == "ready"


def test_restart_releases_graphs_and_recaptures(model):
    # the restart evicts THIS engine's programs only; a second engine's stay
    rng = np.random.default_rng(0)
    eng, other = make_engine(model), make_engine(model)
    eng.serve([_prompt(rng)], max_new_tokens=3)
    other.serve([_prompt(rng)], max_new_tokens=3)
    before = lazy.serve_capture_state()["cached_programs"]
    eng.restart(RuntimeError("forced"))
    assert lazy.serve_capture_state()["cached_programs"] == before // 2
    prof.reset_dispatch_counters()
    p = _prompt(rng)
    (r,) = eng.serve([p], max_new_tokens=3)
    assert r.ok and r.tokens == _generate(model, p, 3)
    assert prof.dispatch_counters()["serve_capture_builds"] > 0  # captured again
    prof.reset_dispatch_counters()
    other.serve([_prompt(rng)], max_new_tokens=3)
    assert prof.dispatch_counters()["serve_capture_builds"] == 0


def test_restart_during_drain_refuses_work_past_the_barrier(model):
    rng = np.random.default_rng(0)
    eng = make_engine(model)
    inside = eng.submit(_prompt(rng), max_new_tokens=4)
    eng.step()
    eng.begin_drain()
    # work that raced in past the barrier (a submit racing the signal)
    late = serving.Request(prompt=_prompt(rng), max_new_tokens=4)
    eng._queue.push(late)
    eng._accepted.add(late.request_id)
    eng.step()  # the late request is admitted and in flight
    assert any(s.req.request_id == late.request_id for s in eng._active)
    eng.restart(RuntimeError("wedge during drain"))
    r = eng.response(late.request_id)
    assert r.status == "overloaded" and r.retriable and "drain barrier" in r.error
    eng.run_until_idle()
    assert eng.response(inside).ok
    c = prof.dispatch_counters()
    assert c["serve_requests_dropped"] == c["serve_block_leaks"] == 0


def test_preemption_handler_sigterm_drains(model):
    assert threading.current_thread() is threading.main_thread()
    rng = np.random.default_rng(3)
    prompts = [_prompt(rng) for _ in range(3)]
    clean = [_generate(model, p, 6) for p in prompts]
    eng = make_engine(model, prompt_buckets=[8])
    prev = signal.getsignal(signal.SIGTERM)
    eng.install_preemption_handler()
    eng.install_preemption_handler()  # twice: keeps the original previous
    try:
        ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.step()
        killer = threading.Timer(0.01, lambda: os.kill(os.getpid(), signal.SIGTERM))
        killer.start()
        killer.join()
        eng.run_until_idle()
        late = eng.submit(prompts[0], max_new_tokens=6)
    finally:
        eng.uninstall_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is prev
    assert [eng.response(i).tokens for i in ids] == clean
    assert eng.response(late).status == "rejected"
    c = prof.dispatch_counters()
    assert c["serve_preempt_drains"] == 1 and c["serve_requests_dropped"] == 0
