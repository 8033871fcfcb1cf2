"""Observability probe of the port: the flight recorder, postmortem, ops-plane
and attribution gates of the JAX package's ``tools/obs_probe.py``, run on
BASELINE.json config 1's LeNet (and a tiny GPT serving engine):

  chaos-events          LeNet under execute:p=0.2,compile:p=0.2 recovers
                        bitwise, and the capture fallback-reason EVENTS in
                        the flight recorder match the
                        capture_fallback_reasons counter histogram exactly,
                        with the perf sentinel armed and never tripping
  unrecovered-postmortem a fault storm that outlives the retry budget at
                        the captured tier dumps a postmortem whose event
                        tail explains the fault (site, retries, the ladder
                        demotion) while the run completes on the fallback
                        path
  serving-lanes         the merged chrome trace holds one async lane per
                        served request (b/n/e events keyed by id)
  diag-server           one process of captured training and a serving
                        engine answers /metrics, /healthz, /readyz,
                        /flight, /statusz; /healthz flips to 503 on a
                        forced stall; a 10 Hz scraper's cost is gated
  perf-sentinel         a forced steady slowdown trips the sentinel
                        exactly once (/healthz 503 'degraded', a flight
                        event, a postmortem) and recovery clears it
  triage                with FLAGS_telemetry on and a GlobalStepSampler, a
                        one-step nan:grads injection and a forced slowdown
                        each dump exactly one postmortem whose attribution
                        names the spiking group / the slowed key and the
                        batch's sample ids; the telemetry overhead is gated
  trace-overhead        the flight recorder's per-step cost is gated

The three overhead gates are analytic, as in the JAX probe, against
``--overhead-budget-pct`` (1%): the flight recorder's emit cost times its
events a step, and the telemetry record cost, over a step time; the
/metrics build time times 10 scrapes a second, a share of each second and
so of any step. The step is the measured LeNet step unless
``--gate-step-ms`` names another: on the card the captured LeNet step is
well under a millisecond, so ``chip_smoke.py`` gates against the GPT-2
345M step where a user runs telemetry and scrapes, and the LeNet
percentages are printed beside them. The harness is its own copy of the
JAX probe's LeNet recipe (``tools/chaos_probe.py``). It prints one JSON
line per scenario, then ``ALL SCENARIOS PASSED`` and exits 0, or
``OBSERVABILITY GATE FAILED`` and exits 1. On the card by default;
``--device cpu`` runs it on the CPU:

    python -m paddle_tpu_torch.tools.obs_probe [--steps 6] [--batch 64] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

import paddle_tpu_torch as paddle
import paddle_tpu_torch.profiler as prof
import paddle_tpu_torch.resilience as res
from paddle_tpu_torch.profiler import trace
from paddle_tpu_torch.resilience import rescue as _rescue

STEPS = 6
BATCH = 8
# the perf-sentinel scenario's least recovery time, s
RECOVERY_S = 0.25


# -- the LeNet harness (the JAX package's tools/chaos_probe.py recipe) -------
def _build(seed=0):
    from paddle_tpu_torch.vision.models import LeNet

    paddle.seed(seed)
    net = LeNet()
    opt = paddle.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters())
    loss_fn = paddle.nn.CrossEntropyLoss()
    return net, opt, loss_fn


def _batches(steps, batch):
    rng = np.random.default_rng(0)
    return [
        (rng.standard_normal((batch, 1, 28, 28)).astype(np.float32),
         rng.integers(0, 10, (batch,)))
        for _ in range(steps)
    ]


def _one_step(net, opt, loss_fn, xy):
    x, y = xy
    loss = loss_fn(net(paddle.to_tensor(x)), paddle.to_tensor(y))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss)


def _run(batches, seed=0):
    net, opt, loss_fn = _build(seed)
    return [_one_step(net, opt, loss_fn, xy) for xy in batches]


def _fresh(fault_spec=""):
    res.reset()
    prof.reset_dispatch_counters()
    _rescue.reset_counters()
    trace.clear()
    prof.sentinel.reset()
    paddle.set_flags({"FLAGS_fault_inject": fault_spec,
                      "FLAGS_retry_backoff_ms": 0.5})


def _gate_pct(cost_ms, lenet_step_ms, gate_step_ms):
    """(the percentage gated, the LeNet percentage): the host cost over the
    step it is gated against (``--gate-step-ms``, else the LeNet step)."""
    lenet = cost_ms / max(lenet_step_ms, 1e-9) * 100.0
    gated = lenet if not gate_step_ms else cost_ms / gate_step_ms * 100.0
    return gated, lenet


def _fallback_reason_events():
    out = {}
    # server-side kind filter: only capture events materialize
    for e in trace.events(kind="capture"):
        if e.attrs and e.attrs.get("phase") == "fallback":
            r = e.attrs["reason"]
            out[r] = out.get(r, 0) + 1
    return out


def _http_get(addr, path, timeout=5.0):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{addr}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _scrape_build_p50():
    """Server-side /metrics exposition-build p50 (ms) from the
    diag_scrape_ms histogram, or None before the first scrape."""
    build = None
    for met in prof.metrics.default_registry().metrics():
        if met.name == "diag_scrape_ms":
            build = met.quantile(0.5)
    return None if build is None else round(build, 3)


def measure_scrape_latency(addr, n=30, timeout=5.0):
    """`n` sequential /metrics scrapes against a live diag server:
    client-side p50/p99 round-trip ms plus the server-side build p50 —
    the ONE scrape-latency definition bench.py's observability block and
    the diag-server scenario share."""
    lats = []
    for _ in range(n):
        t0 = time.perf_counter()
        _http_get(addr, "/metrics", timeout=timeout)
        lats.append((time.perf_counter() - t0) * 1000.0)
    lats.sort()
    return {
        "scrape_p50_ms": round(lats[len(lats) // 2], 3),
        "scrape_p99_ms": round(lats[max(0, int(len(lats) * 0.99) - 1)], 3),
        "scrape_build_p50_ms": _scrape_build_p50(),
        "scrapes": n,
    }


def scenario_chaos_events(batches, results):
    """Injected chaos recovers bitwise AND the fallback-reason event stream
    agrees with the counter histogram. The event/counter equality only
    holds while the ring retains the whole run, so it is sized to the run
    (counters are lifetime; a saturated ring would fail the gate with zero
    real defects)."""
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True,
                      "FLAGS_eager_step_capture": True,
                      "FLAGS_trace_ring_size": max(
                          4096, 512 * (len(batches) + 4))})
    _fresh()
    clean = _run(batches)
    _fresh("execute:p=0.2,compile:p=0.2")
    # the perf-regression sentinel rides along ARMED: a clean chaos run
    # (retries recover, ladder suppression covers demotions) must produce
    # ZERO trips — injected-fault noise is not a perf regression
    paddle.set_flags({"FLAGS_sentinel_pct": 30.0,
                      "FLAGS_sentinel_warmup_steps": 3,
                      "FLAGS_sentinel_sustain_steps": 3})
    faulted = _run(batches)
    c = prof.dispatch_counters()
    sentinel_trips = int(c["perf_regressions"])
    paddle.set_flags({"FLAGS_sentinel_pct": 0.0})
    counter_reasons = dict(c["capture_fallback_reasons"])
    event_reasons = _fallback_reason_events()
    fault_events = trace.events(kind="fault")
    ring_ok = len(trace.events()) < int(
        paddle.get_flags("FLAGS_trace_ring_size")["FLAGS_trace_ring_size"])
    _fresh()
    paddle.set_flags({"FLAGS_trace_ring_size": 4096})
    ok = (faulted == clean
          and ring_ok  # nothing evicted — the comparisons below are valid
          and event_reasons == counter_reasons
          and len(fault_events) == c["fault_events"]
          and sentinel_trips == 0)
    results.append({
        "scenario": "chaos-events",
        "ok": ok,
        "final_loss_clean": clean[-1],
        "final_loss_faulted": faulted[-1],
        "injected_faults": c["injected_faults"],
        "fault_events_in_ring": len(fault_events),
        "fallback_reasons_counters": counter_reasons,
        "fallback_reasons_events": event_reasons,
        "sentinel_trips_during_chaos": sentinel_trips,
    })
    return ok


def scenario_unrecovered_postmortem(batches, results, pmdir):
    """A storm that outlives the retry budget at the captured tier: the
    fault escapes execute() (postmortem) and the ladder demotes, while the
    run itself finishes on the fallback path bitwise-identical."""
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True,
                      "FLAGS_eager_step_capture": True})
    _fresh()
    clean = _run(batches)
    _fresh("execute:captured:p=1:x=5")
    paddle.set_flags({"FLAGS_postmortem_dir": pmdir,
                      "FLAGS_retry_max": 1,
                      "FLAGS_ladder_demote_after": 1,
                      "FLAGS_ladder_cooldown_steps": 100})
    stormed = _run(batches)
    paddle.set_flags({"FLAGS_postmortem_dir": "",
                      "FLAGS_retry_max": 2,
                      "FLAGS_ladder_demote_after": 2,
                      "FLAGS_ladder_cooldown_steps": 8})
    _fresh()
    pms = sorted(f for f in os.listdir(pmdir)
                 if f.startswith("postmortem_unrecovered_fault"))
    ok = stormed == clean and bool(pms)
    doc = None
    if pms:
        with open(os.path.join(pmdir, pms[0])) as f:
            doc = json.load(f)
        tail = doc["events"]
        kinds = [(e["kind"], e["site"]) for e in tail]
        fault_tail = [e for e in tail if e["kind"] == "fault"
                      and e["site"] == "captured"]
        ladder_tail = [e for e in tail if e["kind"] == "ladder"]
        # the tail must EXPLAIN the fault: the site that failed, the retry
        # that preceded the escape, and the ladder transition it caused
        ok = (ok
              and doc["attrs"]["site"] == "captured"
              and doc["attrs"]["retries"] >= 1
              and bool(fault_tail)
              and ("retry", "captured") in kinds
              and any(e["attrs"]["action"] == "demote" for e in ladder_tail)
              and doc["metrics"]["counters"]["retry_exhausted"] >= 1)
    results.append({
        "scenario": "unrecovered-postmortem",
        "ok": ok,
        "final_loss_clean": clean[-1],
        "final_loss_storm": stormed[-1],
        "postmortems": pms,
        "postmortem_site": None if doc is None else doc["attrs"].get("site"),
        "postmortem_retries": None if doc is None else doc["attrs"].get("retries"),
        "postmortem_tail_events": None if doc is None else len(doc["events"]),
    })
    return ok


def scenario_serving_lanes(results):
    """The merged chrome trace shows per-request serving lanes."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    paddle.set_flags({"FLAGS_eager_lazy_dispatch": False})
    _fresh()
    paddle.seed(7)
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=2, max_seq_len=32, dropout=0.0,
                    attn_dropout=0.0)
    model = GPTForPretraining(cfg)
    model.eval()
    eng = serving.Engine(model, serving.ServingConfig(
        block_size=8, prompt_buckets=[8], num_blocks=24))
    try:
        ids = [eng.submit([1, 2, 3], max_new_tokens=4),
               eng.submit([5, 6], max_new_tokens=4),
               eng.submit([7, 8, 9, 10], max_new_tokens=4)]
        eng.run_until_idle()
        stats = eng.stats()
    finally:
        eng.close()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.Profiler(timer_only=True).export(path)
        with open(path) as f:
            doc = json.load(f)
    serve_evs = [e for e in doc["traceEvents"] if e.get("cat") == "serving"]
    lanes_ok = True
    for rid in ids:
        # e.get: engine-scoped instants (health transitions) share the
        # serving category but carry no request id
        phs = [e["ph"] for e in serve_evs if e.get("id") == str(rid)]
        lanes_ok &= bool(phs) and phs[0] == "b" and phs[-1] == "e" and "n" in phs
    ok = lanes_ok and stats["token_lat_p50_ms"] is not None
    results.append({
        "scenario": "serving-lanes",
        "ok": ok,
        "requests": len(ids),
        "serving_trace_events": len(serve_evs),
        "token_lat_p50_ms": stats["token_lat_p50_ms"],
        "token_lat_p99_ms": stats["token_lat_p99_ms"],
    })
    return ok


def measure_trace_overhead(batches, reps=4, gate_step_ms=None):
    """Tracing-on overhead on the captured steady state, two ways.

    The GATED number is analytic: (per-emit cost with the ring on − the
    off-mode fast-path cost) × events/step, as a fraction of the median
    step time. Emitting events is the ONLY work the flag adds, the emit
    microcost is stable to ~0.1 µs, and events/step is deterministic at
    steady state — so this bound is reproducible on a box whose wall clock
    swings ±30% second to second (where a direct A/B at 1% precision is
    noise). The A/B window delta is reported alongside, unguarded, as the
    sanity check that nothing outside emit() changed."""
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True,
                      "FLAGS_eager_step_capture": True})
    _fresh()
    net, opt, loss_fn = _build()
    for xy in batches * 3:  # warm up into captured steady state
        _one_step(net, opt, loss_fn, xy)

    def window(steps=20):
        t0 = time.perf_counter()
        for i in range(steps):
            _one_step(net, opt, loss_fn, batches[i % len(batches)])
        return (time.perf_counter() - t0) / steps

    # -- per-emit microcost, on-mode vs off-mode fast path ------------------
    def emit_cost_us(ring, n=50_000):
        paddle.set_flags({"FLAGS_trace_ring_size": ring})
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(n):
                # no step= — the runtime's emit sites all take the
                # current_step() auto-fill path, so its cost must be part
                # of the measured per-emit delta
                trace.emit("probe", site="bench", i=i)
            dt = (time.perf_counter() - t0) / n * 1e6
            best = dt if best is None else min(best, dt)
        return best

    emit_on_us = emit_cost_us(4096)
    emit_off_us = emit_cost_us(0)

    # -- events/step + step time at steady state ----------------------------
    paddle.set_flags({"FLAGS_trace_ring_size": 4096})
    window(2)
    trace.clear()
    t_on = min(window() for _ in range(reps))
    events_per_step = len(trace.events()) / (reps * 20 + 0.0)
    paddle.set_flags({"FLAGS_trace_ring_size": 0})
    window(2)
    t_off = min(window() for _ in range(reps))
    paddle.set_flags({"FLAGS_trace_ring_size": 4096})

    step_us = min(t_on, t_off) * 1e6
    cost_ms = max(0.0, emit_on_us - emit_off_us) * events_per_step / 1000.0
    overhead_pct, lenet_pct = _gate_pct(cost_ms, step_us / 1000.0, gate_step_ms)
    return {
        "emit_on_us": round(emit_on_us, 3),
        "emit_off_us": round(emit_off_us, 3),
        "events_per_step": round(events_per_step, 2),
        "step_ms": round(step_us / 1000.0, 3),
        "gate_step_ms": gate_step_ms,
        "overhead_pct": round(overhead_pct, 4),
        "lenet_overhead_pct": round(lenet_pct, 4),
        # informational: wall-clock A/B (noise-dominated on shared boxes)
        "ab_step_ms_trace_on": round(t_on * 1000.0, 3),
        "ab_step_ms_trace_off": round(t_off * 1000.0, 3),
        "ab_delta_pct": round((t_on - t_off) / t_off * 100.0, 2),
    }


def scenario_trace_overhead(batches, results, budget_pct, gate_step_ms=None):
    m = measure_trace_overhead(batches, gate_step_ms=gate_step_ms)
    ok = m["overhead_pct"] < budget_pct
    results.append(dict({"scenario": "trace-overhead", "ok": ok,
                         "budget_pct": budget_pct}, **m))
    return ok


def scenario_diag_server(batches, results, budget_pct=1.0, gate_step_ms=None):
    """The end-to-end gate: ONE process running captured training
    plus a serving engine answers /metrics (valid exposition), /healthz
    (200 while healthy, 503 within one watchdog period of a forced stall),
    /flight?kind=..., /statusz — and a 10 Hz scraper costs < 1% steps/s
    (gated analytically like the trace-overhead scenario: per-scrape cost
    × rate over step time; the wall-clock A/B rides along unguarded)."""
    import threading

    from paddle_tpu_torch.profiler import diag
    from paddle_tpu_torch.profiler.metrics import parse_prometheus_text

    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True,
                      "FLAGS_eager_step_capture": True,
                      "FLAGS_trace_ring_size": 4096})
    _fresh()
    addr = diag.start(port=0)
    checks = {}
    m = {}
    try:
        # captured training steady state + a tiny serving engine
        net, opt, loss_fn = _build()
        for xy in batches * 3:
            _one_step(net, opt, loss_fn, xy)
        from paddle_tpu_torch import serving
        from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

        paddle.seed(7)
        cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                        num_heads=2, max_seq_len=32, dropout=0.0,
                        attn_dropout=0.0)
        model = GPTForPretraining(cfg)
        model.eval()
        eng = serving.Engine(model, serving.ServingConfig(
            block_size=8, prompt_buckets=[8], num_blocks=24))
        try:
            eng.serve([[1, 2, 3], [5, 6]], max_new_tokens=4)

            st, body = _http_get(addr, "/metrics")
            parsed = parse_prometheus_text(body.decode())
            checks["metrics_parses"] = (
                st == 200 and parsed.get("paddle_programs", 0) >= 1
                and parsed.get("paddle_serve_requests_completed", 0) >= 2
                and any(k.startswith("paddle_serve_token_lat_ms_count")
                        for k in parsed))
            st, body = _http_get(addr, "/healthz")
            doc = json.loads(body)
            checks["healthz_ok"] = bool(
                st == 200 and doc["status"] == "ok" and doc["engines"])
            st, body = _http_get(addr, "/readyz")
            checks["readyz_ok"] = st == 200
            st, body = _http_get(addr, "/flight?kind=ladder")
            ladder_doc = json.loads(body)
            checks["flight_ladder_answers"] = (
                st == 200 and isinstance(ladder_doc["events"], list))
            st, body = _http_get(addr, "/flight?kind=flush&last=8")
            flush_doc = json.loads(body)
            checks["flight_flush_filtered"] = (
                st == 200 and flush_doc["count"] >= 1
                and all(e["kind"] == "flush" for e in flush_doc["events"]))
            st, body = _http_get(addr, "/statusz")
            checks["statusz_renders"] = (
                st == 200 and b"serving engines" in body
                and b"resilience ladder" in body)
        finally:
            eng.close()

        # forced stall: /healthz must flip 200 -> 503 within one watchdog
        # period (the liveness read is the heartbeat AGE, so the flip needs
        # no watchdog thread — one period after the last heartbeat it's red)
        paddle.set_flags({"FLAGS_trace_stall_ms": 120.0})
        _one_step(net, opt, loss_fn, batches[0])  # fresh heartbeat
        st_before, _ = _http_get(addr, "/healthz")
        deadline = time.time() + 3.0
        st_after, why = 0, None
        while time.time() < deadline:
            st_after, body = _http_get(addr, "/healthz")
            if st_after == 503:
                why = json.loads(body)["reasons"]
                break
            time.sleep(0.03)
        checks["healthz_flips_on_stall"] = (
            st_before == 200 and st_after == 503
            and "stalled" in (why or []))
        paddle.set_flags({"FLAGS_trace_stall_ms": 0.0})
        trace.watchdog_disarm()

        # 10 Hz scraper overhead on the captured steady state
        def window(steps=20):
            t0 = time.perf_counter()
            for i in range(steps):
                _one_step(net, opt, loss_fn, batches[i % len(batches)])
            return (time.perf_counter() - t0) / steps

        window(2)
        t_plain = min(window() for _ in range(3))
        stop_evt = threading.Event()
        lats = []

        def scraper():
            while not stop_evt.is_set():
                t0 = time.perf_counter()
                _http_get(addr, "/metrics")
                lats.append((time.perf_counter() - t0) * 1000.0)
                stop_evt.wait(0.1)  # 10 Hz

        th = threading.Thread(target=scraper, daemon=True)
        th.start()
        t_scraped = min(window() for _ in range(3))
        # a fast step (the captured LeNet step on the card, ~1 ms) ends the
        # windows within a scrape or two: keep stepping until the build
        # time's median rests on 20 scrapes (at most 10 s)
        deadline = time.time() + 10.0
        while len(lats) < 20 and time.time() < deadline:
            window()
        stop_evt.set()
        th.join(timeout=2)
        lats.sort()
        scrape_p50 = lats[len(lats) // 2] if lats else 0.0
        # analytic bound (house style: wall-clock A/B at 1% resolution does
        # not replicate on a noisy box): what a scraper can steal from the
        # step thread is the GIL time the handler holds — the SERVER-side
        # exposition build (diag_scrape_ms) — × 10/s. The client round
        # trip (reported alongside) is dominated by per-request TCP setup,
        # which burns no step-thread time.
        build_p50 = _scrape_build_p50() or 0.0
        # the build's share of each second (10 scrapes a second): the same
        # share of any step's time, the LeNet step's or the gate step's
        overhead_pct = build_p50 * 10.0 / 1000.0 * 100.0
        checks["scrape_overhead_under_budget"] = overhead_pct < budget_pct
        m = {
            "gate_step_ms": gate_step_ms,
            "lenet_scrape_overhead_pct": round(overhead_pct, 4),
            "scrape_build_p50_ms": round(build_p50, 3),
            "scrape_p50_ms": round(scrape_p50, 3),
            "scrape_p99_ms": round(
                lats[max(0, int(len(lats) * 0.99) - 1)], 3) if lats else None,
            "scrapes": len(lats),
            "scrape_overhead_pct": round(overhead_pct, 4),
            "ab_step_ms_plain": round(t_plain * 1000.0, 3),
            "ab_step_ms_scraped": round(t_scraped * 1000.0, 3),
            "ab_delta_pct": round(
                (t_scraped - t_plain) / t_plain * 100.0, 2),
        }
    finally:
        diag.stop()
        paddle.set_flags({"FLAGS_trace_stall_ms": 0.0})
    ok = all(checks.values())
    results.append(dict({"scenario": "diag-server", "ok": ok,
                         "budget_pct": budget_pct}, **checks, **m))
    return ok


def scenario_sentinel(batches, results, pmdir):
    """A forced steady-state slowdown trips the perf-regression sentinel
    EXACTLY once: /healthz goes 503 'degraded' with reason
    perf_regression, a perf_regression flight event and postmortem land,
    and recovery clears the trip (hysteresis) so /healthz greens again."""
    from paddle_tpu_torch.profiler import diag

    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True,
                      "FLAGS_eager_step_capture": True})
    _fresh()
    addr = diag.start(port=0)
    checks = {}
    trips_detail = {}
    recovery_steps = 0
    try:
        net, opt, loss_fn = _build()
        for xy in batches * 2:  # settle into captured steady state
            _one_step(net, opt, loss_fn, xy)
        _one_step(net, opt, loss_fn, batches[0])
        paddle.set_flags({"FLAGS_sentinel_pct": 30.0,
                          "FLAGS_sentinel_warmup_steps": 6,
                          "FLAGS_sentinel_sustain_steps": 3,
                          "FLAGS_postmortem_dir": pmdir})
        prof.sentinel.reset()
        # clean steady window: arms the baseline, zero trips
        for i in range(14):
            _one_step(net, opt, loss_fn, batches[i % len(batches)])
        c0 = prof.dispatch_counters()
        checks["no_trip_while_steady"] = c0["perf_regressions"] == 0
        st, _ = _http_get(addr, "/healthz")
        checks["healthz_green_while_steady"] = st == 200
        sent_state = prof.sentinel.state()
        base_ms = max(
            [v["baseline_ms"] or 0.0
             for v in sent_state["keys"].values()] + [1.0])
        # forced steady-state slowdown: every step now takes ~2x baseline
        for i in range(16):
            _one_step(net, opt, loss_fn, batches[i % len(batches)])
            time.sleep(base_ms / 1000.0)
        c1 = prof.dispatch_counters()
        checks["exactly_one_trip"] = c1["perf_regressions"] == 1
        st, body = _http_get(addr, "/healthz")
        doc = json.loads(body)
        checks["healthz_degraded_perf_regression"] = (
            st == 503 and doc["status"] == "degraded"
            and doc["reasons"] == ["perf_regression"])
        trip_events = [e for e in trace.events(kind="perf_regression")
                       if e.attrs and e.attrs.get("phase") == "trip"]
        checks["flight_event_emitted"] = len(trip_events) == 1
        pms = [f for f in os.listdir(pmdir)
               if f.startswith("postmortem_perf_regression")]
        checks["postmortem_dumped"] = len(pms) == 1
        # recovery: back to the baseline pace clears the trip (hysteresis).
        # The JAX probe's 30 steps span ~0.23 s of its ~7.5 ms CPU step; a
        # captured step on the card is a few times shorter, and the host's
        # pace wanders over windows that short, so recovery gets at least
        # RECOVERY_S as well (the CPU's 30 steps take longer than that)
        t_end = time.perf_counter() + RECOVERY_S
        while prof.sentinel.tripped() and (recovery_steps < 30
                                           or time.perf_counter() < t_end):
            _one_step(net, opt, loss_fn,
                      batches[recovery_steps % len(batches)])
            recovery_steps += 1
        st, _ = _http_get(addr, "/healthz")
        checks["healthz_green_after_recovery"] = (
            st == 200 and not prof.sentinel.tripped())
        checks["still_one_trip_total"] = (
            prof.dispatch_counters()["perf_regressions"] == 1)
        trips_detail = {
            k: {kk: v[kk] for kk in ("baseline_ms", "ema_ms", "trips",
                                     "suppressed")}
            for k, v in prof.sentinel.state()["keys"].items()}
    finally:
        diag.stop()
        paddle.set_flags({"FLAGS_sentinel_pct": 0.0,
                          "FLAGS_postmortem_dir": ""})
        prof.sentinel.reset()
    ok = all(checks.values())
    results.append(dict({"scenario": "perf-sentinel", "ok": ok,
                         "keys": trips_detail,
                         "recovery_steps": recovery_steps}, **checks))
    return ok


def scenario_triage(batches, results, pmdir, budget_pct=1.0, gate_step_ms=None):
    """The attribution gate: with FLAGS_telemetry on and a
    GlobalStepSampler driving the batches, (a) a one-step nan:grads
    injection under numeric_rescue=skip dumps EXACTLY ONE numeric_rescue
    postmortem whose attribution names the spiking param group and the
    offending batch's sample ids; (b) a forced steady slowdown trips the
    sentinel EXACTLY ONCE, and its perf_regression postmortem's
    attribution names the slowed program key (train), the spike that
    preceded it, and the step's sample ids; (c) telemetry-on overhead is
    gated < budget analytically (host record cost per step over step
    time — the device-side work is folded into the step program and adds
    zero launches, bitwise-identically; see tests/test_attribution.py)."""
    from paddle_tpu_torch.io import GlobalStepSampler
    from paddle_tpu_torch.profiler import attribution

    # lazy tier, capture off: the sentinel/step key stays a stable 'train'
    # (no capture re-arm can retire it mid-scenario), and nan:grads fires
    # directly in the fused update instead of via a capture fallback. A
    # prior scenario's ARMED controller would still tag the key with its
    # signature — drop the thread's observer so the key is clean.
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True,
                      "FLAGS_eager_step_capture": False})
    from paddle_tpu_torch.core import lazy as _lazy_mod

    _lazy_mod._tls.observer = None
    _fresh()
    attribution.reset()
    checks = {}
    m = {}
    try:
        paddle.set_flags({"FLAGS_postmortem_dir": pmdir,
                          "FLAGS_numeric_rescue": "skip",
                          "FLAGS_telemetry": True})
        net, opt, loss_fn = _build()
        # one sample pool; the sampler's ids pick each step's batch, so a
        # postmortem's recovered ids are checkable against what we fed
        xs = np.concatenate([b[0] for b in batches])
        ys = np.concatenate([b[1] for b in batches])
        sampler = GlobalStepSampler(len(xs), global_batch_size=BATCH,
                                    seed=5)
        fed = {}

        def sampled_step():
            step_no = sampler.cursor
            ids = [int(i) for i in sampler.local_ids(step_no)]
            sampler.cursor += 1
            fed[step_no] = ids
            return _one_step(net, opt, loss_fn, (xs[ids], ys[ids]))

        for _ in range(9):  # settle: builds must not poison the baseline
            sampled_step()
        paddle.set_flags({"FLAGS_sentinel_pct": 30.0,
                          "FLAGS_sentinel_warmup_steps": 6,
                          "FLAGS_sentinel_sustain_steps": 3})
        prof.sentinel.reset()
        t_window = []
        for _ in range(10):  # steady window: arms the sentinel baseline
            t0 = time.perf_counter()
            sampled_step()
            t_window.append(time.perf_counter() - t0)
        step_ms = sorted(t_window)[len(t_window) // 2] * 1000.0

        # (a) one-step nan injection -> exactly one rescue postmortem
        paddle.set_flags({"FLAGS_fault_inject": "nan:grads:p=1:x=1"})
        sampled_step()
        paddle.set_flags({"FLAGS_fault_inject": ""})
        checks["one_rescue"] = _rescue.counters["numeric_rescues"] == 1
        rescue_pms = [f for f in os.listdir(pmdir)
                      if f.startswith("postmortem_numeric_rescue")]
        checks["one_rescue_postmortem"] = len(rescue_pms) == 1
        spiking_group = None
        if rescue_pms:
            with open(os.path.join(pmdir, rescue_pms[0])) as f:
                doc = json.load(f)
            att = doc["attribution"]
            spiking = att["telemetry"]["spiking_groups"]
            spiking_group = spiking[0] if spiking else None
            checks["rescue_names_spiking_group"] = bool(spiking)
            checks["rescue_names_sample_ids"] = (
                att["batch"]["sample_ids"] == fed.get(att["batch"]["step"]))
        for _ in range(4):  # settle back before the slowdown phase
            sampled_step()

        # (b) forced steady slowdown -> exactly one perf_regression
        # postmortem whose attribution names the slowed key + the spike
        base_ms = max(step_ms, 1.0)
        for _ in range(16):
            sampled_step()
            time.sleep(base_ms / 1000.0)
        c = prof.dispatch_counters()
        checks["exactly_one_trip"] = c["perf_regressions"] == 1
        trip_pms = [f for f in os.listdir(pmdir)
                    if f.startswith("postmortem_perf_regression")]
        checks["one_trip_postmortem"] = len(trip_pms) == 1
        if trip_pms:
            with open(os.path.join(pmdir, trip_pms[0])) as f:
                doc = json.load(f)
            att = doc["attribution"]
            tripped = att["programs"]["tripped"]
            checks["trip_names_slowed_key"] = bool(
                tripped and tripped[-1]["key"].startswith("train")
                and tripped[-1]["drift_pct"] > 30.0)
            checks["trip_carries_spike_history"] = (
                att["telemetry"]["total_spikes"] >= 1
                and spiking_group is not None)
            checks["trip_names_sample_ids"] = (
                att["batch"]["sample_ids"] == fed.get(att["batch"]["step"]))
            m["tripped_key"] = None if not tripped else tripped[-1]["key"]
            m["spiking_group"] = spiking_group

        # (c) telemetry-on overhead, analytic: marginal host record cost
        # (tight-loop microbench over the live group names — the one
        # measurement definition in attribution.measure_record_cost_ms)
        # × one record/step over steady step time, same house style as
        # the flight-recorder per-emit bound; the live EMA — which folds
        # in cache-warming noise an A/B cannot attribute — rides along
        # unguarded. Runs LAST: the microbench mutates telemetry state.
        m["telemetry_steps"] = int(
            prof.dispatch_counters()["telemetry_steps"])
        live_ms = attribution.telemetry_record_cost_ms() or 0.0
        pnames = attribution.group_names(list(net.parameters()))
        rec_ms = attribution.measure_record_cost_ms(pnames)
        overhead_pct, lenet_pct = _gate_pct(rec_ms, step_ms, gate_step_ms)
        checks["telemetry_overhead_under_budget"] = overhead_pct < budget_pct
        m.update({
            "gate_step_ms": gate_step_ms,
            "lenet_telemetry_overhead_pct": round(lenet_pct, 4),
            "telemetry_record_cost_ms": round(rec_ms, 4),
            "telemetry_record_cost_live_ms": round(live_ms, 4),
            "step_ms": round(step_ms, 3),
            "telemetry_overhead_pct": round(overhead_pct, 4),
        })
    finally:
        paddle.set_flags({"FLAGS_postmortem_dir": "",
                          "FLAGS_numeric_rescue": "",
                          "FLAGS_telemetry": False,
                          "FLAGS_sentinel_pct": 0.0,
                          "FLAGS_fault_inject": "",
                          "FLAGS_eager_step_capture": True})
        prof.sentinel.reset()
        attribution.reset()
    ok = all(checks.values())
    results.append(dict({"scenario": "triage", "ok": ok,
                         "budget_pct": budget_pct}, **checks, **m))
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--overhead-budget-pct", type=float, default=1.0)
    ap.add_argument("--gate-step-ms", type=float, default=None,
                    help="gate the overhead figures against this step time (ms) "
                         "instead of the LeNet step's")
    ap.add_argument("--skip-overhead", action="store_true",
                    help="skip the (timing-sensitive) overhead gate")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the card)")
    args = ap.parse_args(argv)
    paddle.set_device(args.device or "gpu")

    batches = _batches(args.steps, args.batch)
    results = []
    ok = True
    try:
        ok &= scenario_chaos_events(batches, results)
        with tempfile.TemporaryDirectory() as pmdir:
            ok &= scenario_unrecovered_postmortem(batches, results, pmdir)
        ok &= scenario_serving_lanes(results)
        ok &= scenario_diag_server(batches, results,
                                   args.overhead_budget_pct, args.gate_step_ms)
        with tempfile.TemporaryDirectory() as pmdir:
            ok &= scenario_sentinel(batches, results, pmdir)
        # the triage scenario runs SEQUENTIALLY after the other slow
        # probes (never in parallel with them: CPU contention makes the
        # timing-based fleet/elastic gates flake)
        with tempfile.TemporaryDirectory() as pmdir:
            ok &= scenario_triage(batches, results, pmdir,
                                  args.overhead_budget_pct, args.gate_step_ms)
        if not args.skip_overhead:
            ok &= scenario_trace_overhead(batches, results,
                                          args.overhead_budget_pct, args.gate_step_ms)
    finally:
        paddle.set_flags({
            "FLAGS_fault_inject": "",
            "FLAGS_postmortem_dir": "",
            "FLAGS_trace_ring_size": 4096,
            "FLAGS_trace_stall_ms": 0.0,
            "FLAGS_sentinel_pct": 0.0,
            "FLAGS_telemetry": False,
            "FLAGS_numeric_rescue": "",
            "FLAGS_eager_lazy_dispatch": False,
            "FLAGS_eager_step_capture": True,
            "FLAGS_retry_backoff_ms": 5.0,
            "FLAGS_retry_max": 2,
        })
        from paddle_tpu_torch.profiler import diag as _diag

        _diag.stop()
        prof.sentinel.reset()
        res.reset()

    for r in results:
        print(json.dumps(r))
    print("ALL SCENARIOS PASSED" if ok else "OBSERVABILITY GATE FAILED",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
