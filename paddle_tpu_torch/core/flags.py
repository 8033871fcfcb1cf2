"""Global flags: the port's own copy of the registry in ``paddle_tpu/core/flags.py``.

It holds the flags that the port reads, the ones whose feature is not
ported yet (``later=``: only the default is accepted), and the seven core
flags the JAX package defines and reads nowhere (accepted, no effect). Each
keeps the JAX package's name and default, can be overridden from the environment as ``FLAGS_<name>``
when this module is imported, and is read and set at run time through
``get_flags`` / ``set_flags``.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_registry: Dict[str, dict] = {}

_TRUE_WORDS = frozenset(("1", "true", "yes", "on", "y", "t"))
_FALSE_WORDS = frozenset(("0", "false", "no", "off", "n", "f", ""))


def _parse(text: str, default):
    if isinstance(default, bool):
        word = text.strip().lower()
        if word in _TRUE_WORDS:
            return True
        if word in _FALSE_WORDS:
            return False
        raise ValueError(
            f"invalid boolean flag value {text!r}: use 1/0, true/false, "
            "yes/no, or on/off"
        )
    if isinstance(default, int):
        return int(text)
    if isinstance(default, float):
        return float(text)
    return text


def _norm(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def define_flag(name: str, default: Any, doc: str = "", later: str = None):
    """Register a flag. ``later`` names the queue item that ports what the
    flag turns on: setting it to anything but its default raises
    NotImplementedError naming that item."""
    name = _norm(name)
    env = os.environ.get("FLAGS_" + name)
    value = default if env is None else _parse(env, default)
    _registry[name] = {"value": value, "default": default, "doc": doc, "later": later}
    return value


def get_flags(flags):
    """Accepts one name or a list of names; returns ``{"FLAGS_name": value}``."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for n in names:
        key = _norm(n)
        if key not in _registry:
            raise ValueError(f"unknown flag {n!r}")
        out["FLAGS_" + key] = _registry[key]["value"]
    return out


def set_flags(flags: Dict[str, Any]):
    """``{"FLAGS_name": value, ...}``; string values parse like the environment's."""
    for n, v in flags.items():
        key = _norm(n)
        if key not in _registry:
            raise ValueError(f"unknown flag {n!r}")
        entry = _registry[key]
        if isinstance(v, str) and not isinstance(entry["default"], str):
            v = _parse(v, entry["default"])
        if entry["later"] and v != entry["default"]:
            raise NotImplementedError(
                f"FLAGS_{key}={v!r} is not ported yet (ROADMAP, open items, queue 1 "
                f"{entry['later']})")
        entry["value"] = v


def flag(name: str):
    return _registry[_norm(name)]["value"]


def entry(name: str) -> dict:
    """A flag's registry entry, for a hot path that reads ``["value"]`` on
    every call: ``set_flags`` writes the value into this same dict."""
    return _registry[_norm(name)]


def describe_flags(match: str = None):
    """Sorted ``[{"name": "FLAGS_x", "value", "default", "doc"}]`` for every
    flag, or for those whose name contains the substring ``match``."""
    return [
        {"name": "FLAGS_" + n, "value": e["value"], "default": e["default"], "doc": e["doc"]}
        for n, e in sorted(_registry.items()) if match is None or match in n
    ]


define_flag("check_nan_inf", False,
            "scan the floating outputs of every paddle.* tensor function (the ops "
            "core.dispatch.apply runs) for NaN/Inf and raise FloatingPointError naming "
            "the op (debug mode; one host read per op)")
define_flag(
    "use_flash_attention",
    True,
    "route scaled_dot_product_attention through the flash kernel when "
    "shapes/mask allow",
)
define_flag(
    "pallas_fused_update", False,
    "route the fused optimizer update (optimizer.make_fused_update, the one "
    "applier behind the eager step()) through the hand-written fused-update "
    "kernels for Adam / SGD / Momentum: each parameter's whole elementwise "
    "update chain, gated by the step's non-finite sentinel, runs as one "
    "kernel pass (one read and one write per buffer) on the card. On CPU "
    "tensors the kernels' plain PyTorch versions run; unsupported rules and "
    "dtypes keep the rule's torch ops unchanged",
)
define_flag(
    "pallas_update_interpret", False,
    "accepted for parity with the JAX package, where it runs the Pallas "
    "fused-update kernel in interpreter mode on the CPU. The port reads it "
    "nowhere: on a CPU tensor the fused update always runs the kernels' "
    "plain versions, on a CUDA tensor it always launches the kernels",
)
define_flag(
    "numeric_rescue", "",
    "step-level numeric rescue policy: '' (off), 'skip' (drop steps with "
    "non-finite gradients; params/optimizer state untouched), 'lr_backoff' "
    "(skip + multiply lr by FLAGS_numeric_rescue_lr_factor), or 'abort' "
    "(raise FloatingPointError). Detection is one device scalar computed in "
    "the fused update, which gates the update on the device; the host reads "
    "it once per step",
)
define_flag(
    "numeric_rescue_lr_factor", 0.5,
    "lr multiplier applied by the 'lr_backoff' numeric-rescue policy on "
    "each rescued step",
)
# ---------------------------------------------------------------------------
# Checkpointing (paddle.distributed.checkpoint — CheckFreq cadence tuning
# and snapshot pipelining)
# ---------------------------------------------------------------------------
define_flag(
    "ckpt_overhead_pct", 3.5,
    "checkpoint-overhead budget (percent of steady-state compute) the "
    "auto-tuned cadence targets: with save_freq='auto' the CadenceTuner "
    "measures step time and the on-step-path snapshot cost, then picks the "
    "largest save frequency whose overhead stays under this budget "
    "(CheckFreq's ~3.5% discipline), re-tuning when step time drifts",
)
define_flag(
    "ckpt_async", True,
    "pipeline checkpoint persistence with compute: AsyncCheckpointer.save "
    "takes only a fast on-device snapshot of params + optimizer "
    "accumulators at the step boundary (bitwise the boundary state, "
    "enqueued before the next captured step can overwrite those buffers in "
    "place) and runs the device->host transfer + serialization + two-phase "
    "commit on a background thread overlapping the following steps; 0 "
    "restores the fully synchronous on-step-path save",
)
define_flag(
    "ckpt_cadence_max", 1000,
    "cap on the save frequency (steps between checkpoints) the auto "
    "cadence tuner may pick — bounds worst-case lost work when the "
    "snapshot is very cheap relative to the step",
)
define_flag(
    "ckpt_retune_pct", 25.0,
    "percent drift of the step-time EMA from its value at the last tune "
    "that triggers the cadence tuner to re-pick save_freq (e.g. after a "
    "degradation-ladder demotion changes steady-state step time)",
)
define_flag(
    "memory_budget_mb", 0.0,
    "estimated peak device-memory budget (MB): the memory_budget pass reports a "
    "checked program's estimated peak against it (an error above it, raised "
    "under FLAGS_check_programs=2), FLAGS_memory_plan='auto' plans remat to fit "
    "it, and the serving engine with FLAGS_serving_num_blocks 0 sizes its KV "
    "block pool from it (analysis.memory.plan_block_pool); 0 = no budget",
)
# ---------------------------------------------------------------------------
# Serving runtime (paddle_tpu_torch.serving)
# ---------------------------------------------------------------------------
define_flag(
    "serving_block_size", 16,
    "tokens per KV-cache block in the serving engine's paged cache: every "
    "sequence's context is stored as a chain of fixed-size blocks drawn "
    "from one shared pool, so device memory is bounded by the pool, not by "
    "max_seq_len times the number of admitted sequences",
)
define_flag(
    "serving_num_blocks", 0,
    "KV block-pool size of the serving engine (shared logical blocks, each "
    "spanning all layers). 0 = sized by the memory planner from "
    "FLAGS_memory_budget_mb, else from the card's memory, else (on the CPU) "
    "a 256-block default",
)
define_flag(
    "serving_prompt_buckets", "32,64,128",
    "ascending prompt-length pad boundaries for the serving prefill "
    "programs (io/bucketing.py BucketSpec policy): each admitted prompt is "
    "padded up to its bucket so the number of captured prefill programs is "
    "bounded; lengths beyond the table round up to multiples of the "
    "largest boundary. Every boundary must divide evenly into "
    "FLAGS_serving_block_size blocks",
)
define_flag(
    "serving_decode_batch_buckets", "1,2,4,8",
    "ascending decode batch-size buckets for continuous batching: each "
    "decode step pads its active-sequence batch up to a bucket (idle rows "
    "attend a per-slot scratch block), so one captured decode program per "
    "(batch bucket, context bucket) signature serves steady state",
)
define_flag(
    "serving_capture", True,
    "capture each serving prefill/decode signature as ONE program (a CUDA "
    "graph on the card, core/lazy.py) and replay it from an LRU cache; "
    "off = every serve step runs eagerly, op by op",
)
define_flag(
    "serving_capture_donate", True,
    "let the captured program update the paged KV block pool in place (the "
    "CUDA graph writes the pool tensors it was captured over); 0 runs each "
    "step on copies of the pool and puts them back on success, so a failed "
    "step leaves the pool intact",
)
define_flag(
    "serving_capture_cache_size", 16,
    "LRU cap on captured serving programs (prefill + decode signatures; "
    "0 = unbounded); evictions are counted in "
    "paddle_tpu_torch.profiler.dispatch_counters()['serve_capture_evictions']",
)
define_flag(
    "serving_max_new_tokens", 128,
    "default generation cap per serving request when the request does not "
    "set max_new_tokens",
)
define_flag(
    "serving_request_retries", 2,
    "times the serving engine re-enqueues a request whose sequence was "
    "torn down by a fault mid-decode before answering it with an error "
    "response; greedy decode is deterministic, so a re-run reproduces the "
    "same tokens",
)
define_flag(
    "serving_default_deadline_ms", 0.0,
    "default per-request deadline for the serving engine, in ms from "
    "submit: requests that do not set deadline_ms inherit this. The "
    "deadline is enforced at admission (predicted misses are shed with a "
    "retriable 'overloaded' response), in queue (expired requests answer "
    "'timeout' before wasting a prefill), and mid-decode (expired "
    "sequences leave the batch with a partial 'timeout' response, per "
    "FLAGS_serving_deadline_partial). 0 = no default deadline",
)
define_flag(
    "serving_deadline_partial", True,
    "what a sequence that passes its deadline MID-DECODE answers: on (the "
    "default), a 'timeout' response carrying the tokens generated so far "
    "(partial output is usable under greedy decode); off, the 'timeout' "
    "response carries no tokens. Either way the request gets a terminal "
    "response and its KV blocks are recycled, never a hang or a drop",
)
define_flag(
    "serving_queue_max", 256,
    "cap on the serving RequestQueue (queued, not-yet-admitted requests): "
    "a submit past the cap is shed immediately with a structured, "
    "retriable 'overloaded' response instead of growing host memory "
    "without bound. 0 = unbounded",
)
define_flag(
    "serving_queue_wait_p99_ms", 0.0,
    "queue-wait p99 trip wire for SLO-aware admission: when the p99 of "
    "recently observed queue waits exceeds this many ms, newly arriving "
    "batch-priority requests are shed with 'overloaded' until the p99 "
    "recovers, so batch traffic sheds first and cannot starve interactive "
    "under a storm. 0 = trip wire off",
)
# ---------------------------------------------------------------------------
# Resilience runtime (paddle_tpu_torch.resilience)
# ---------------------------------------------------------------------------
define_flag(
    "fault_inject", "",
    "deterministic fault-injection spec for the resilience chaos harness, "
    "e.g. 'execute:p=0.2,compile:step>=3,nan:grads' — comma-separated "
    "clauses of kind (execute/compile/hang/nan/kill) with p=/step>=/x= "
    "qualifiers and an optional site target; decisions are seeded per "
    "(clause, site, step) from FLAGS_fault_seed so failures replay exactly "
    "(empty = off)",
)
define_flag(
    "fault_seed", 0,
    "seed for the fault-injection harness's per-(clause, site, step) "
    "decisions — same seed, same spec: same faults at the same steps",
)
define_flag(
    "fault_hang_ms", 20.0,
    "stall duration of an injected 'hang' fault before the simulated "
    "watchdog raises (classified transient, so the retry path runs)",
)
define_flag(
    "retry_max", 2,
    "max retries of a transiently-failed program launch (serving prefill/"
    "decode rungs, the eager floor, the fused optimizer update) before the "
    "error propagates; 0 disables retrying",
)
define_flag(
    "retry_backoff_ms", 5.0,
    "base delay of the capped exponential retry backoff (doubles per "
    "attempt, multiplied by up to 25% jitter); accumulated delay is "
    "counted in dispatch_counters()['retry_backoff_ms']",
)
define_flag(
    "retry_backoff_max_ms", 1000.0,
    "cap on a single retry backoff delay",
)
define_flag(
    "ladder_demote_after", 2,
    "faults observed at an execution tier (captured / lazy) before the "
    "degradation ladder demotes it one rung (captured→lazy→per-op); "
    "numerics are identical across rungs, only programs-per-step changes",
)
define_flag(
    "ladder_cooldown_steps", 8,
    "clean steps a demoted tier waits before the ladder re-promotes it "
    "and the fast path is attempted again",
)
# ---------------------------------------------------------------------------
# Runtime observability (paddle_tpu_torch.profiler.trace)
# ---------------------------------------------------------------------------
define_flag(
    "trace_ring_size", 4096,
    "capacity of the flight recorder — the bounded in-memory ring of "
    "structured runtime events (paddle_tpu_torch.profiler.trace) emitted "
    "at the execution choke points: retries and faults, ladder demotions, "
    "serving request phases and health transitions, numeric rescues and "
    "preemptions. Default on; 0 disables emission entirely (the off-mode "
    "fast path is one dict read per would-be event)",
)
define_flag(
    "trace_stall_ms", 0.0,
    "step-stall watchdog threshold: when > 0, a background watchdog "
    "observes the step heartbeat (resilience.runtime.on_step_end) and — if "
    "no step boundary lands for this many ms — emits a 'stall' event and "
    "dumps a crash postmortem (FLAGS_postmortem_dir). One postmortem per "
    "stall episode; the next completed step re-arms it. 0 = off",
)
define_flag(
    "postmortem_dir", "",
    "directory for crash postmortems: unrecovered faults, Preempted, "
    "numeric rescues, dead serving engines and step-stall watchdog trips "
    "dump a JSON file here with the flight recorder's event tail, the "
    "dispatch counters and latency histograms, the card's allocator "
    "figures, and the resilience/ladder state. Empty = postmortems disabled",
)
define_flag(
    "postmortem_events", 256,
    "number of trailing flight-recorder events included in each postmortem "
    "dump (the event tail that explains what led up to the crash)",
)
define_flag(
    "postmortem_keep", 32,
    "bound on the number of postmortem JSON files kept in "
    "FLAGS_postmortem_dir: every dump prunes the OLDEST dumps past this "
    "count (a flapping watchdog or a rescue storm cannot grow the "
    "directory without limit); pruned files are counted in "
    "dispatch_counters()['postmortems_pruned']. 0 = unbounded",
)
# ---------------------------------------------------------------------------
# Attribution and the ops plane (profiler/attribution.py, sentinel.py,
# diag.py): the JAX package's names, defaults and docs
# ---------------------------------------------------------------------------
define_flag(
    "telemetry", False,
    "fused numerics telemetry (paddle.profiler.attribution): the fused "
    "optimizer update (and the captured whole-step program) computes one "
    "extra stacked vector output, per-parameter grad, param and update "
    "sums of squares, inside the SAME program (the fused-update kernels' "
    "telemetry variant writes per-block partial sums; no extra program, and "
    "step numerics are bitwise-identical to telemetry-off). The host "
    "records the vector into per-group gauges (telemetry_* metric "
    "families), a bounded history ring (FLAGS_telemetry_history) the "
    "triage postmortems dump, and one 'telemetry' flight event per step. "
    "With FLAGS_numeric_rescue set the vector is read with the sentinel "
    "(one synchronisation); otherwise it is copied behind an event and "
    "recorded at the next step boundary (one step late; flush() records "
    "the last one)",
)
define_flag(
    "telemetry_history", 64,
    "per-step telemetry records kept in the attribution history ring: the "
    "'last N telemetry vectors' a triage postmortem includes so an "
    "out-of-trend parameter group is visible in context",
)
define_flag(
    "telemetry_spike_factor", 10.0,
    "a parameter group whose grad-norm exceeds this multiple of its own "
    "EMA (or goes non-finite) is recorded as a telemetry spike: counted "
    "(telemetry_spikes + the telemetry_spike_groups labeled family), named "
    "in the per-step telemetry flight event, and listed first in the "
    "postmortem triage section",
)
define_flag(
    "diag_port", -1,
    "per-process diagnostics HTTP server (paddle.profiler.diag): the port "
    "diag.start() binds its stdlib ThreadingHTTPServer daemon to, serving "
    "GET /metrics (Prometheus exposition incl. the adopted dispatch "
    "counters), /healthz + /readyz (JSON liveness/readiness with HTTP "
    "200/503), /flight?kind=&site=&last=N (flight-recorder tail), "
    "/postmortems (list + fetch the FLAGS_postmortem_dir dumps), /programz "
    "(attribution), /statusz (human-readable runtime state) and /clockz. "
    "-1 (default) = off; 0 = ephemeral port; > 0 = fixed port. Every read "
    "path is built on detached snapshots, so a scrape never blocks a step",
)
define_flag(
    "diag_host", "127.0.0.1",
    "bind address of the diagnostics server (FLAGS_diag_port); the "
    "loopback interface by default",
)
define_flag(
    "sentinel_pct", 0.0,
    "perf-regression sentinel threshold (paddle.profiler.sentinel): when "
    "> 0, per-(step-signature) step-time EMAs (and serving decode / "
    "queue-wait latencies) are baselined after FLAGS_sentinel_warmup_steps "
    "observations; sustained drift past this percent "
    "(FLAGS_sentinel_sustain_steps consecutive breaches, with hysteresis: "
    "a tripped key re-arms only after drifting back under half the "
    "threshold) emits a 'perf_regression' flight event, increments "
    "perf_regressions, dumps a postmortem and flips /healthz to 503 "
    "'degraded'. Breaches are suppressed while the degradation ladder is "
    "demoted or a checkpoint persist is in flight. 0 = off",
)
define_flag(
    "sentinel_warmup_steps", 10,
    "observations of a (step-signature) key before the perf-regression "
    "sentinel freezes its baseline EMA and starts drift detection",
)
define_flag(
    "sentinel_sustain_steps", 3,
    "consecutive over-threshold observations before the perf-regression "
    "sentinel trips (and, symmetrically, consecutive recovered "
    "observations before a tripped key clears and re-baselines)",
)
define_flag(
    "serving_max_engine_restarts", 3,
    "restarts the serving Supervisor may attempt on a wedged or crashed "
    "engine (tick exceptions escaping the resilience ladder, or the "
    "FLAGS_trace_stall_ms watchdog firing mid-tick) before failing "
    "cleanly: past the cap every queued and in-flight request is answered "
    "with an error response and the engine goes 'dead' — zero hangs",
)

# -- eager dispatch: lazy segments and whole-step capture (core/lazy.py) -----
define_flag("benchmark", False,
            "accepted for parity with the JAX package, where it syncs after each op; "
            "the port reads it nowhere (time with CUDA events instead)")
define_flag("eager_op_jit", True,
            "accepted for parity with the JAX package, where it jits each eager op "
            "into a cached XLA program; the port has no per-op compile: it has no "
            "effect")
define_flag("eager_tape_jit", True,
            "accepted for parity with the JAX package, where it compiles the eager "
            "backward sweep into one XLA program; the port's backward is torch's "
            "autograd sweep (one CUDA graph inside a graphed segment): no effect")
define_flag("eager_jit_cache_size", 4096,
            "LRU cap on the lazy-dispatch output-spec cache (FakeTensorMode "
            "inference per op signature; 0 = unbounded). The JAX package's per-op "
            "jit and vjp caches, which it also bounds, have no counterpart here")
define_flag(
    "eager_lazy_dispatch", False,
    "defer eager Paddle-level calls (an outermost nn.Layer call or "
    "nn.functional call with Tensor arguments, and core.dispatch.apply) onto "
    "a pending per-thread segment whose outputs answer shape and dtype "
    "without running; a host read, backward(), device.synchronize() or an "
    "op that cannot be deferred flushes the whole segment as ONE program: "
    "its op plan run eagerly the first time, a CUDA graph (forward) with a "
    "CUDA graph for its autograd sweep after that, on the card",
)
define_flag("eager_segment_cache_size", 256,
            "LRU cap on the lazy-dispatch segment cache (plans and their CUDA "
            "graphs; 0 = unbounded)")
define_flag("eager_segment_max_ops", 256,
            "flush a pending lazy-dispatch segment once it holds this many ops")
define_flag(
    "eager_step_capture", True,
    "whole-step capture under FLAGS_eager_lazy_dispatch: once a steady-state "
    "train step (forward segment + backward + optimizer.step) repeats with "
    "one signature for FLAGS_eager_capture_warmup steps, the next one runs "
    "forward, backward, grad clip and update as ONE program (one CUDA graph "
    "on the card, parameters and optimizer state written in place); any "
    "signature mismatch, hook, retain_graph or read between backward() and "
    "step() resolves the step on the 3-program path with the same numerics, "
    "counted in capture_fallback_reasons",
)
define_flag("eager_capture_warmup", 2,
            "consecutive identical steady-state steps observed before the whole-step "
            "capture arms")
define_flag("eager_capture_cache_size", 8,
            "LRU cap on captured whole-step programs (0 = unbounded); evictions "
            "are counted")
define_flag("eager_capture_donate", True,
            "accepted for parity with the JAX package, where it donates parameter "
            "and state buffers to the captured program; a CUDA graph writes them in "
            "place either way, so the port's captured step is the same with it off")
define_flag("eager_capture_sharded", True,
            "mesh-aware whole-step capture in the JAX package; the port has no "
            "mesh, so every capture is single-card and only the default is "
            "accepted (ROADMAP queue 1 item 13c)", later="item 13c")
define_flag("check_programs", 0,
            "the program verifier: 0 off; 1 runs the analysis passes over each lazy "
            "segment's first flush, the captured step's donation gate and "
            "compile_train_step's, warning on every finding; 2 also raises "
            "ProgramVerificationError on an error-severity finding and certifies each "
            "captured step (against its 3-program composition), each planned "
            "compile_train_step (against the unplanned step) and each serving "
            "program's rungs equivalent before it replays")
define_flag("memory_plan", "",
            "'auto' turns the memory_budget estimate into a remat plan: with "
            "FLAGS_memory_budget_mb > 0, compile_train_step and the whole-step capture "
            "recompute the layer calls the planner chooses so the step's estimated peak "
            "fits the budget (bitwise the unplanned step's numerics; a failed plan falls "
            "back unplanned, counted in memory_plan_failures); '' (default) builds plans "
            "only when asked (plan_remat(), graph_lint --plan)")
define_flag("offload_overhead_pct", 1.0,
            "measured-overhead budget (% of step time) of the optimizer's host-offload "
            "scheduler (optimizer.offload): cold moment tensors are parked in host "
            "memory between their update reads, and the scheduler shrinks or regrows "
            "the parked set from the measured prefetch time so the stall it adds to a "
            "step stays under this budget")
define_flag(
    "eager_async_compile", True,
    "accepted for parity with the JAX package, where it compiles a new "
    "segment or captured step on a background thread while its first "
    "occurrence runs the plain path; the port's build of a program is a "
    "tuple of plan ops made on the calling thread, so it has no effect",
)
# The core flags the JAX package defines and reads nowhere (its
# ``core/flags.py:223,703-716``): accepted with their defaults and read
# nowhere here either; ``cudnn_deterministic`` does not switch cuDNN.
define_flag("use_standalone_executor", True,
            "compat: the compiled whole-program executor path; read nowhere")
define_flag("max_inplace_grad_add", 0, "compat: grad accumulation chunking; read nowhere")
define_flag("init_allocated_mem", False, "compat: poison fresh allocations; read nowhere")
define_flag("allocator_strategy", "auto_growth",
            "compat: allocator strategy name (torch's caching allocator owns the card's "
            "memory); read nowhere")
define_flag("fraction_of_gpu_memory_to_use", 0.92,
            "compat: preallocation fraction (torch's caching allocator grows on demand); "
            "read nowhere")
define_flag("cudnn_deterministic", False,
            "compat: deterministic kernels; read nowhere (set "
            "torch.backends.cudnn.deterministic for cuDNN's choice)")
define_flag("embedding_deterministic", 0, "compat: deterministic embedding grad; read nowhere")
