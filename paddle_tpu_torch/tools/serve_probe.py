"""Serve probe of the port: the ``paddle.serving`` engine under a canned
chaos plan (the six scenarios of the JAX package's ``tools/serve_probe.py``).

A scripted request mix must complete EVERY request, with tokens identical
to the fault-free reference, under

  parity        fault-free serve vs per-request model.generate()
  faults        injected transient execute faults at p=0.2 (retry recovery)
  storm         guaranteed per-step decode faults exhausting the retry
                budget: the ladder demotes the bucket captured -> retained
                (-> per-op) and every request still completes with the same
                tokens
  sigterm       SIGTERM mid-serve -> drain: everything already submitted
                completes, new submissions are rejected, nothing drops
  overload      2x sustained oversubmit: with the queue-wait p99 trip wire
                open, every batch-class submission sheds with a structured
                retriable 'overloaded' response while every interactive
                request completes inside its deadline; zero hangs, zero
                drops, zero leaked KV blocks
  wedge         a forced engine wedge (a tick exception escaping the
                resilience ladder): the Supervisor restarts the engine
                (fresh pool, evicted captured programs) and the requeued
                sequences finish with bitwise-identical tokens

It prints one JSON line per scenario, then ``ALL SCENARIOS PASSED`` and
exits 0, or the failed scenarios and exits 1. The model is a tiny GPT
(random weights from a seed) on the card, its prefill and decode steps
captured as CUDA graphs; ``--device cpu`` runs it on the CPU:

    python -m paddle_tpu_torch.tools.serve_probe [--requests 6] [--max-new 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

import numpy as np

import paddle_tpu_torch as paddle
import paddle_tpu_torch.profiler as prof
import paddle_tpu_torch.resilience as res
from paddle_tpu_torch import serving

VOCAB = 64


def _build(seed=7):
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    paddle.seed(seed)
    cfg = GPTConfig(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                    num_heads=2, max_seq_len=32, dropout=0.0,
                    attn_dropout=0.0)
    m = GPTForPretraining(cfg)
    m.eval()
    return m


def _mix(n):
    rng = np.random.default_rng(11)
    lens = [8, 16, 5, 8, 12, 16]
    return [rng.integers(1, VOCAB, lens[i % len(lens)]) for i in range(n)]


def _engine(model):
    return serving.Engine(model, serving.ServingConfig(
        block_size=8, prompt_buckets=[8, 16], num_blocks=24))


def _fresh(spec=""):
    from paddle_tpu_torch.core.lazy import reset_serve_programs

    res.reset()
    prof.reset_dispatch_counters()
    reset_serve_programs()
    paddle.set_flags({"FLAGS_fault_inject": spec,
                      "FLAGS_retry_backoff_ms": 0.5})


def _tokens(resps):
    return [list(r.tokens) for r in resps]


def scenario_parity(model, prompts, max_new, results):
    _fresh()
    eng = _engine(model)
    resps = eng.serve(prompts, max_new_tokens=max_new)
    ref = []
    for p in prompts:
        out = model.generate(
            paddle.to_tensor(np.asarray(p, np.int64)[None, :]),
            max_new_tokens=max_new,
        ).cpu().numpy()[0, len(p):]
        ref.append([int(t) for t in out])
    ok = all(r.ok for r in resps) and _tokens(resps) == ref
    results.append({"scenario": "parity", "ok": ok,
                    "requests": len(prompts),
                    "completed": sum(r.ok for r in resps)})
    return _tokens(resps)


def scenario_faults(model, prompts, max_new, clean, results):
    _fresh("execute:p=0.2")
    eng = _engine(model)
    resps = eng.serve(prompts, max_new_tokens=max_new)
    c = prof.dispatch_counters()
    ok = (all(r.ok for r in resps) and _tokens(resps) == clean
          and c["serve_requests_dropped"] == 0)
    results.append({
        "scenario": "faults/p=0.2", "ok": ok,
        "injected": c["injected_faults"], "retries": c["retry_attempts"],
        "fallbacks": c["serve_capture_fallbacks"],
        "dropped": c["serve_requests_dropped"],
    })


def scenario_storm(model, prompts, max_new, clean, results):
    _fresh("execute:p=1:x=3:decode")
    eng = _engine(model)
    resps = eng.serve(prompts, max_new_tokens=max_new)
    c = prof.dispatch_counters()
    ok = (all(r.ok for r in resps) and _tokens(resps) == clean
          and c["serve_capture_fallbacks"] > 0
          and c["serve_requests_dropped"] == 0)
    results.append({
        "scenario": "storm/decode", "ok": ok,
        "fallbacks": c["serve_capture_fallbacks"],
        "demotions": c["ladder_demotions"],
        "retry_exhausted": c["retry_exhausted"],
        "dropped": c["serve_requests_dropped"],
    })


def scenario_sigterm(model, prompts, max_new, clean, results):
    """SIGTERM lands mid-serve (a timer thread signals our own pid): the
    installed handler flips the engine into drain mode — every request
    submitted BEFORE the signal completes with the right tokens, a request
    submitted after is rejected, zero drops."""
    _fresh()
    eng = _engine(model)
    eng.install_preemption_handler()
    late_status = {}
    try:
        ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.step()  # prefills + first decode step in flight
        killer = threading.Timer(
            0.01, lambda: os.kill(os.getpid(), signal.SIGTERM))
        killer.start()
        killer.join()
        eng.run_until_idle()  # the drain
        late = eng.submit(prompts[0], max_new_tokens=max_new)
        late_status["late"] = eng.response(late).status
        resps = [eng.response(i) for i in ids]
    finally:
        eng.uninstall_preemption_handler()
    c = prof.dispatch_counters()
    ok = (all(r is not None and r.ok for r in resps)
          and _tokens(resps) == clean
          and late_status.get("late") == "rejected"
          and c["serve_preempt_drains"] >= 1
          and c["serve_requests_dropped"] == 0)
    results.append({
        "scenario": "sigterm-drain", "ok": ok,
        "drains": c["serve_preempt_drains"],
        "late_submit": late_status.get("late"),
        "dropped": c["serve_requests_dropped"],
    })


def scenario_overload(model, max_new, results):
    """2× sustained oversubmit: interactive requests carry a generous
    deadline and must ALL complete inside it; batch requests arrive into
    an open queue-wait p99 trip wire and must ALL shed with a structured
    retriable response. The hard gates: every submitted request gets a
    terminal response (zero hangs, zero drops) and the pool leaks zero
    blocks."""
    _fresh()
    paddle.set_flags({"FLAGS_serving_queue_wait_p99_ms": 1.0,
                      "FLAGS_serving_queue_max": 64})
    try:
        eng = _engine(model)
        rng = np.random.default_rng(5)
        warm = [rng.integers(1, VOCAB, 8) for _ in range(10)]
        # warm window: compiles the programs AND seeds the measured cost
        # EMAs + enough queue-wait samples (>= 8) to arm the trip wire
        eng.serve(warm, max_new_tokens=max_new)
        deadline_ms = 120_000.0  # generous: interactive must make it
        n = 12  # ~2x what the 24-block pool can hold concurrently
        subs = []  # (rid, priority)
        for k in range(n):
            for prio in ("interactive", "batch"):
                rid = eng.submit(rng.integers(1, VOCAB, 8),
                                 max_new_tokens=max_new,
                                 deadline_ms=deadline_ms, priority=prio)
                subs.append((rid, prio))
        eng.run_until_idle()
        resps = {rid: eng.pop_response(rid) for rid, _ in subs}
        c = prof.dispatch_counters()
    finally:
        paddle.set_flags({"FLAGS_serving_queue_wait_p99_ms": 0.0,
                          "FLAGS_serving_queue_max": 256})
    inter = [resps[r] for r, p in subs if p == "interactive"]
    batch = [resps[r] for r, p in subs if p == "batch"]
    inter_lat = [r.latency_ms for r in inter if r is not None and r.ok]
    inter_p99 = (float(np.percentile(inter_lat, 99)) if inter_lat else None)
    ok = (
        all(r is not None for r in resps.values())          # zero hangs
        and all(r.ok for r in inter)                        # goodput kept
        and inter_p99 is not None and inter_p99 < deadline_ms
        and all(r.status == "overloaded" and r.retriable for r in batch)
        and c["serve_requests_dropped"] == 0
        and c["serve_block_leaks"] == 0
        and eng._pool.free_blocks == eng._pool.num_blocks
    )
    results.append({
        "scenario": "overload/2x", "ok": ok,
        "interactive_completed": sum(r.ok for r in inter),
        "interactive_p99_ms": inter_p99,
        "deadline_ms": deadline_ms,
        "batch_shed": sum(r.status == "overloaded" for r in batch),
        "shed_reasons": dict(c["serve_shed_reasons"]),
        "dropped": c["serve_requests_dropped"],
        "block_leaks": c["serve_block_leaks"],
    })


def scenario_wedge(model, prompts, max_new, clean, results):
    """A forced mid-run engine wedge — a tick exception escaping the
    resilience ladder — detected by the Supervisor, which restarts the
    engine and finishes every request with bitwise-identical tokens."""
    _fresh()
    eng = _engine(model)
    sup = serving.Supervisor(eng)
    try:
        ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        orig = eng._decode_batch
        state = {"armed": True}

        def wedged(chunk, n_blk):
            if state["armed"]:
                state["armed"] = False
                raise RuntimeError("forced wedge: tick bug")
            return orig(chunk, n_blk)

        eng._decode_batch = wedged
        sup.run_until_idle()
        resps = [eng.pop_response(i) for i in ids]
    finally:
        sup.close()
    c = prof.dispatch_counters()
    ok = (all(r is not None and r.ok for r in resps)
          and _tokens(resps) == clean
          and sup.restarts >= 1
          and c["serve_engine_restarts"] >= 1
          and c["serve_requests_dropped"] == 0
          and c["serve_block_leaks"] == 0
          and eng.health in ("ready", "degraded"))
    results.append({
        "scenario": "wedge/supervisor", "ok": ok,
        "restarts": sup.restarts,
        "health": eng.health,
        "requeues": c["serve_request_requeues"],
        "dropped": c["serve_requests_dropped"],
        "block_leaks": c["serve_block_leaks"],
    })


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="gpu", help="gpu (the card, default) or cpu")
    args = ap.parse_args()
    paddle.set_device(args.device)

    model = _build()
    prompts = _mix(args.requests)
    results = []
    clean = scenario_parity(model, prompts, args.max_new, results)
    scenario_faults(model, prompts, args.max_new, clean, results)
    scenario_storm(model, prompts, args.max_new, clean, results)
    scenario_sigterm(model, prompts, args.max_new, clean, results)
    scenario_overload(model, args.max_new, results)
    scenario_wedge(model, prompts, args.max_new, clean, results)
    _fresh()

    for r in results:
        print(json.dumps(r))
    if all(r["ok"] for r in results):
        print("ALL SCENARIOS PASSED")
        return 0
    print("SCENARIO FAILURES:", [r["scenario"] for r in results if not r["ok"]])
    return 1


if __name__ == "__main__":
    sys.exit(main())
