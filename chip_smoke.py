#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from ``paddle_tpu_torch/csrc`` with nvcc,
     one process per source, all at once; print each kernel's registers and
     spills, and count the ``HGMMA`` (wgmma) instructions in each sm90 library
     and the TF32 ``HMMA`` (mma.sync) instructions, and all instructions per
     HMMA (in the library, in each kernel and in its tile loop), in the two
     tf32x3 ones;
  3. hold the flash forward against its plain PyTorch version on the card, on
     its three routes (sm90: wgmma + TMA for bf16/fp16; tf32x3: 3xTF32
     mma.sync + TMA for f32; simt: CUDA cores, the shapes neither takes), at
     the main path's shapes and at ragged, non-causal, wide-head and narrow
     ones, check the route each launch took and that a second forward is
     bitwise equal, and time the kernels (the case's route and SIMT), the
     plain version and the PyTorch library call;
  4. the full-sequence forward of GPT-2 345M (random weights from a seed) at
     4 x 1024 tokens through the flash kernel, against the dense path, in f32
     (24 tf32x3 launches), then in bf16 (24 sm90 launches);
  5. serve a few requests: greedy ``generate()`` on 4 prompts, cross-checked
     token by token against the kernel-path forward;
 5b. serve GPT-2 345M f32 (``max_seq_len=2048``) through ``serving.Engine``
     on bench.py ``bench_serving``'s mix (12 prompts of 32-128 tokens, 24
     new tokens each): a warm serve that captures each prefill and decode
     signature as one CUDA graph, a timed serve (requests/s, tokens/s,
     token latency p50/p99 from the engine's step timings, one graph replay
     per decode step, no re-capture, fallback, drop or leaked block, the
     decode steps' host cost split from their device time); then a
     sustained run of 256 requests of the mix
     arriving in a stagger into a 96-block pool, so admissions land
     mid-decode, batch sizes change and backpressure fires (warm, then
     timed, the same checks); the eager rung on both schedules with equal
     tokens, and ``generate()`` per request of the mix, equal but for
     recorded near-ties;
 5c. the same engine configuration and mix under faults, each scenario of
     ``tools/serve_probe.py``'s list answering every request with no drop
     and no leaked block: injected faults at p=0.2 (tokens equal the clean
     serve's); a decode storm the ladder demotes to the retained rung, then
     a clean serve in which the cooldown re-promotes the buckets and their
     graphs replay again (demoted and captured step ms); prefill faults; a
     fault raised after a decode graph wrote the pool (zeroed in place,
     every sequence requeued); under ``serving.Supervisor`` a tick that
     raises once (one restart, re-capture beside another engine's live
     graphs, health degraded then ready, the restart's ms to the next
     token), a permanently wedged one (every request an error, the engine
     dead, a postmortem written); a tick stalled past
     ``FLAGS_trace_stall_ms`` with nothing decoded (a restart, with no other
     graph alive) and one as slow that decoded (none); SIGTERM with the
     preemption handler (a drain); ``inference.create_predictor`` on a
     generative Config and a ``PredictorPool`` routing around a draining
     replica; then the clean mix with ``resilience.execute`` on its fast
     path, a second time on it and bypassed, in turns (the fast path's cost
     per decode step, beside its cost per call in a loop); last, a profiler
     trace of one decode tick (a profiler session leaves every later launch
     ~0.2 ms of host cost, so it follows every timed serving window);
  6. hold the flash backward kernels (dK/dV and dQ, each on its three
     routes: sm90 for bf16/fp16, tf32x3 for f32, both fed by TMA, and simt
     for what neither takes) against their plain version on the card, at the
     training step's shape and at ragged, non-causal, wide-head and tiny
     ones, check the route of each launch (from the eligibility functions)
     and that a second backward is bitwise equal, and time the kernels (the
     case's route and SIMT), the plain version and the PyTorch library
     backward, the pair dK/dV + dQ on its route and on SIMT beside the
     library's; then drive f32 attention whose head dim the tensor-core
     routes refuse through ``nn.functional.scaled_dot_product_attention``
     and autograd, the path that still reaches the SIMT backward;
  7. train GPT-2 345M (random weights from a seed) at 8 x 1024 tokens under
     AMP O2 bf16 with AdamW through ``jit.compile_train_step``: two eager
     warm-up steps, the capture of the whole step as one CUDA graph, then 10
     timed replays, against an eager copy of the model stepped with
     ``loss.backward(); opt.step(); opt.clear_grad()``; every flash forward,
     dK/dV and dQ launch takes the sm90 route;
  7b. the same step with ``GPTConfig(use_recompute=True)``, dropout 0.1 and
     attention dropout 0 (bench.py ``main()`` with ``BENCH_RECOMPUTE=1``):
     two eager steps, the capture, 10 timed replays beside phase 7's step
     (ms, tokens/s, peak memory), 48 sm90 forward launches (24 recomputed)
     and 24 each of dK/dV and dQ per step; two replays at lr 0 draw other
     masks, and at dropout 0 (4 layers) the same; a captured recompute
     replays its forwards' masks (2 layers, against an eager step drawing
     from the same generator states); an eager copy with recompute and one
     without give bitwise-equal losses and gradients over three steps. Then
     the classic fp16 loop: ``auto_cast(level="O1", dtype="float16")``,
     ``GradScaler``, Adam with the fused update on against a deep copy with
     it off (bitwise), 24 fp16 sm90 launches of each flash kernel and 292
     Adam launches per step, two steps with an inf gradient skipped (the
     scale halved), one rescued under ``FLAGS_numeric_rescue="skip"``
     marking the scaler, a good step timed. Then ``compile_train_step(...,
     grad_input_idx=(0,))`` over float rows: the input gradient of three
     replays against eager autograd's;
  8. a ``torch.profiler`` trace of one replayed step: the top device
     operations, the flash kernels' share of the step, the device idle share;
 7c. (after phase 8, which frees phase 7's step) checkpoint and resume of
     phase 7's step over 12 steps of batches from a seed, each run in a
     process of its own that imports only torch and the port: the
     uninterrupted run A and A' (a fresh compiled step where each relaunch
     below starts, so its steps are eager where A replays: the two printed
     side by side); ``train_step_range`` with an ``AsyncCheckpointer``
     (save_freq 2, max_to_keep 2) SIGKILLed after a commit, relaunched
     under a ``PreemptionGuard`` and sent SIGTERM (the step finishes, an
     emergency save, exit 143), relaunched with a ``kill:checkpoint`` fault
     that kills the commit of a snapshot (137, LATEST intact), relaunched
     to the end: every resumed loss bitwise the uninterrupted run's; a
     snapshot loaded into the captured step keeps every ``data_ptr()`` and
     the next replay gives the uninterrupted loss; the snapshot's bytes and
     its step-path and device ms against a replay, the transfer, commit and
     stall ms, a blocking save's ms;
  9. hold the three fused-update kernels (Adam, Momentum, SGD) against their
     plain versions bit for bit, at sizes from 1 element to GPT-2 345M's tied
     word embedding, with the sentinel gate off, clear and set, with and
     without weight decay, and time kernel, plain version and PyTorch's
     fused optimizer call at the embedding's size;
 10. train GPT-2 345M in f32 (random weights from a seed) at 8 x 1024 tokens
     with eager ``loss.backward(); opt.step()``: Adam with L2Decay(0.01),
     ClipGradByGlobalNorm(1.0), LinearWarmup into CosineAnnealingDecay,
     ``FLAGS_numeric_rescue="skip"`` and a NaN-poisoned gradient at one step,
     with ``FLAGS_pallas_fused_update`` on, against a deep copy stepped with
     the flag off: bitwise-equal losses, parameters and moments, one Adam
     kernel launch per parameter per step, and ``opt.step()`` and the
     forward + backward timed; a third copy runs the same steps under
     ``FLAGS_fault_inject="execute:optimizer:p=1:x=1,nan:grads:step=2"``
     (each update launch faulted once and retried, the NaN gradient from
     the fault plan), bitwise equal to the flag-on run; in f32 the flash forward and both backward
     kernels run on the tf32x3 route; then the forward + backward with the
     flash kernels on their route, with the forward forced to SIMT and with
     the backward forced to SIMT, in turns;
 11. the same comparison for Momentum (Nesterov, L2Decay(1e-4)) and SGD at
     full width and 4 layers, 3 steps each;
 12. one JSON line of per-kernel numbers, then the result line.

It needs CUDA and the repository around it; without either it exits non-zero
and prints no result. It imports nothing of JAX or of ``paddle_tpu``.

    python3 chip_smoke.py --tf32-repeat N

runs only the tf32x3 forward's repeat witness: N fresh processes, each
comparing its first two launches bit for bit, then one process under each of
compute-sanitizer's racecheck, synccheck and initcheck where the toolkit has
it and the card is supported.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, bf16/f16
# and TF32 on the tensor cores, and HBM3 bandwidth. Bounds below are stated
# against these.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12, "tf32": 495e12}
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of tests/test_flash_attention.py for the kernel against its plain
# version, on O and on lse.
TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 3e-2}
# ... and on the gradients (tests/test_flash_attention.py:48 in f32)
GRAD_TOL = {"float32": 2e-3, "bfloat16": 3e-2, "float16": 3e-2}

# Flash vs dense logits of the 345M forward: f32 throughout with TF32 off, but
# the kernel sums the softmax online over 64-key tiles while the dense path
# takes one max and one sum over the row. That reorders f32 sums (~1e-6
# relative per layer); 24 layers and the 1024-wide tied head carry it into
# logits of magnitude ~1. 1e-3 leaves a wide margin over that and still
# catches a wrong mask, scale or tile (those move logits by >1e-2).
TOL_LOGITS = 1e-3

SEED = 1234


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


# Cycles of the sleep kernel that holds the stream while timed runs are
# queued behind it: ~50 ms at the H100's clocks, longer than the host takes
# to enqueue any run below.
QUEUE_SLEEP_CYCLES = 100_000_000


def time_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms, each run between two CUDA events.

    A sleep kernel holds the stream while every run and its events are
    queued, so the runs execute back to back and the events measure the
    device, not the host's enqueue rate (which a kernel of tens of
    microseconds would otherwise be waiting on). L2 is not flushed."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def flash_bound(flops, nbytes, dtype_name):
    """Least time for a flash kernel: max(operations / peak, bytes / HBM rate),
    what bounds it, and (f32 only) the operations on the CUDA cores.

    bf16/fp16 products are bounded at the tensor cores' 16-bit peak. An f32
    product is bounded at three TF32 products at the TF32 peak: 3xTF32 is as
    accurate as f32 (the tf32x3 route), so that is the least time the card
    needs for the same work, whatever route the kernel takes; the CUDA-core
    figure (FLOP at 67 TFLOP/s) is returned beside it. Returns
    {"bound_ms", "bound_by", "cuda_core_bound_ms" (f32 only)}."""
    if dtype_name == "float32":
        t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
    else:
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    out = {"bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if dtype_name == "float32":
        out["cuda_core_bound_ms"] = max(flops / PEAK_FLOPS["float32"] * 1e3, t_bytes)
    return out


def attention_bound_ms(b, s, h, d, dtype_name, causal):
    """``flash_bound`` of the flash forward. Operations: 4·D per attended
    (query, key) pair (Q·Kᵀ and P·V, 2 FLOP per FMA); causal attends
    S(S+1)/2 pairs per head. Bytes: q, k, v read once, o written once, lse
    (f32) written once."""
    elem = 4 if dtype_name == "float32" else 2
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * d * pairs * b * h
    nbytes = 4 * b * s * h * d * elem + b * h * s * 4
    return flash_bound(flops, nbytes, dtype_name)


def bwd_bound_ms(kernel, b, s, h, d, dtype_name, causal):
    """``flash_bound`` of one backward kernel. Operations per attended
    (query, key) pair: 8·D for dkv (Q·Kᵀ, dO·Vᵀ, pᵀ·dO, dSᵀ·Q), 6·D for dq
    (Q·Kᵀ, dO·Vᵀ, dS·K). Bytes: q, k, v, dO read once, lse and delta (f32)
    read once, the gradients written once (dK and dV, or dQ)."""
    elem = 4 if dtype_name == "float32" else 2
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = (8 if kernel == "dkv" else 6) * d * pairs * b * h
    n_out = 2 if kernel == "dkv" else 1
    nbytes = (4 + n_out) * b * s * h * d * elem + 2 * b * h * s * 4
    return flash_bound(flops, nbytes, dtype_name)


def check_share(name, bound_ms, ms):
    """A kernel can take no less than its bound: a share over 100% means a
    wrong bound or a wrong timing."""
    check(bound_ms <= ms, f"{name}: {ms:.4f} ms is under its bound {bound_ms:.4f} ms")


def bound_text(t):
    core = (f", CUDA-core bound {t['cuda_core_bound_ms']:.4f}"
            if "cuda_core_bound_ms" in t else "")
    return f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}{core})"


def qkv_on_card(shape, dtype, layout, gen, dev):
    """q, k, v on the card: strided views of one [b, s, h, 3, d] qkv, as GPT
    makes them (``fused``), or three contiguous tensors."""
    import torch

    b, s, h, d = shape
    if layout == "fused":
        qkv = torch.randn((b, s, h, 3, d), generator=gen, device=dev).to(dtype)
        return qkv.unbind(dim=3)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3)]


BWD_MAIN_SHAPE = (8, 1024, 16, 64)  # the 345M training step: batch 8 x 1024, 16 heads of 64

# Eager copy vs graph replays of the 345M step, on the loss. Both run the
# same kernels on the same data in the same order, so they are expected
# equal to the bit; the tolerance admits a library kernel (cuBLAS) that picks
# another algorithm for another memory layout of its workspace, which moves
# bf16 weights by an ulp here and there and the f32 loss (about 10.8) by far
# less than 1e-2. A wrong update (lr, bias correction, decay) moves the loss
# of the later steps by more than 1e-2.
TOL_EAGER_VS_GRAPH = 1e-2


FWD_MAIN_SHAPE = (4, 1024, 16, 64)  # the 345M forward: batch 4 x 1024, 16 heads of 64

# f32 attention the tensor-core routes refuse: a head dim over 128 and a
# ragged one (shape, causal)
SIMT_PATH_CASES = [((1, 200, 2, 160), True), ((1, 7, 1, 5), True)]


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def route_of(fa, tensors):
    """The route of the forward for (q, k, v), or of the backward for
    (q, k, v, dO), from the eligibility functions."""
    if fa.sm90_eligible(tensors):
        return "sm90"
    return "tf32x3" if fa.tf32x3_eligible(tensors) else "simt"


def sass_counts(cuobjdump, library):
    """{kernel: (TF32 HMMA instructions, all instructions, instructions in the
    loop around the HMMAs)} of each kernel function in a library's SASS, a
    static count: each instruction once, however often it runs. The loop is
    the shortest span from a backward branch's target to the branch that
    holds every HMMA: the key- or query-tile loop, with both sides of any
    branch inside it. A kernel is named as ``dq_tf32_kernel<64>``."""
    sass = subprocess.run([cuobjdump, "-sass", library], check=True, capture_output=True,
                          text=True).stdout
    code, name = {}, None  # kernel -> [(address, instruction text)]
    for line in sass.splitlines():
        function = re.search(r"Function : (\S+)", line)
        if function:
            short = re.search(r"\d((?:fwd|dkv|dq)\w*_kernel)ILi(\d+)E", function.group(1))
            name = f"{short.group(1)}<{short.group(2)}>" if short else function.group(1)
            code[name] = []
        elif name:
            at = re.search(r"/\*([0-9a-f]{4,})\*/(.*?);", line)
            if at:
                code[name].append((int(at.group(1), 16), at.group(2)))
    counts = {}
    for name, lines in code.items():
        hmma = [a for a, text in lines if "HMMA" in text and "TF32" in text]
        loops = [(target, a) for a, text in lines
                 for target in [int(t, 16) for t in re.findall(r"BRA.*?0x([0-9a-f]+)", text)]
                 if hmma and target <= hmma[0] and a >= hmma[-1]]
        first, last = min(loops, key=lambda span: span[1] - span[0]) if loops else (0, -1)
        counts[name] = (len(hmma), len(lines), sum(first <= a <= last for a, _ in lines))
    return counts


def check_forward_kernels(torch, fa, gen, dev):
    """Phase 3: the forward on its three routes against ``fwd_plain``; the
    route of each launch and a second forward bitwise equal; timings of the
    case's route and SIMT, the plain version and SDPA at the main shapes.
    Returns {(shape, dtype): numbers}."""
    print("[3] flash_attention_fwd vs plain, sm90, tf32x3 and SIMT routes")
    cases = [  # (shape, causal, dtype, layout)
        (FWD_MAIN_SHAPE, True, torch.float32, "fused"),
        ((1, 600, 2, 24), True, torch.float32, "fused"),  # ragged S
        ((1, 128, 2, 32), False, torch.float32, "contiguous"),  # non-causal
        ((1, 512, 2, 128), True, torch.float32, "contiguous"),  # D = 128
    ]
    # what the tensor-core routes refuse: the SIMT kernel
    cases += [(shape, causal, torch.float32, "contiguous") for shape, causal in SIMT_PATH_CASES]
    for dtype in (torch.bfloat16, torch.float16):
        cases += [
            (FWD_MAIN_SHAPE, True, dtype, "fused"),
            (BWD_MAIN_SHAPE, True, dtype, "fused"),
            ((2, 1000, 4, 64), True, dtype, "contiguous"),  # ragged S
            ((1, 512, 2, 128), False, dtype, "contiguous"),  # non-causal, D = 128
            ((1, 64, 1, 16), True, dtype, "contiguous"),  # one tile, D = 16
        ]
    timed = {(FWD_MAIN_SHAPE, "float32"), (FWD_MAIN_SHAPE, "bfloat16"),
             (BWD_MAIN_SHAPE, "bfloat16"), (BWD_MAIN_SHAPE, "float16")}
    out = {}
    for shape, causal, dtype, layout in cases:
        b, s, h, d = shape
        dname = dtype_name(dtype)
        q, k, v = qkv_on_card(shape, dtype, layout, gen, dev)
        route = route_of(fa, (q, k, v))
        scale = d ** -0.5
        before = dict(fa.flash_attention_fwd.launches_by_route)
        o_k, lse_k = fa.flash_attention_fwd(q, k, v, scale, causal)
        o_2, lse_2 = fa.flash_attention_fwd(q, k, v, scale, causal)
        o_p, lse_p = fa.fwd_plain(q, k, v, scale, causal)
        torch.cuda.synchronize()
        took = {r: n - before[r] for r, n in fa.flash_attention_fwd.launches_by_route.items()}
        err_o = (o_k.float() - o_p.float()).abs().max().item()
        err_lse = (lse_k - lse_p).abs().max().item()
        bitwise = torch.equal(o_k, o_2) and torch.equal(lse_k, lse_2)
        ok = err_o <= TOL[dname] and err_lse <= TOL[dname] and bitwise
        print(f"  {shape} causal={causal} {dname} {layout}: route {route} "
              f"({took}); max|dO|={err_o:.3e} max|dlse|={err_lse:.3e} tol={TOL[dname]:g}; "
              f"second forward bitwise equal: {bitwise} {'ok' if ok else 'FAIL'}")
        if not bitwise:
            # the witness an open fault needs (ROADMAP queue 3): where the
            # two launches differ, by [batch, row, head] of O
            rows = (o_k != o_2).any(dim=-1).nonzero().tolist()
            print(f"    the two forwards differ in {len(rows)} O rows (first {rows[:8]}), "
                  f"by at most {(o_k.float() - o_2.float()).abs().max().item():.3e}; lse in "
                  f"{int((lse_k != lse_2).sum())} entries")
        check(took[route] == 2 and sum(took.values()) == 2,
              f"the forward at {shape} {dname} did not take the {route} route: {took}")
        check(ok, f"forward kernel disagrees with its plain version at {shape} {dname}")
        check(bool(torch.isfinite(o_k).all()), f"non-finite kernel output at {shape}")
        if (shape, dname) not in timed:
            continue
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        numbers = dict(max_abs_err=max(err_o, err_lse))
        numbers["ms"] = time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale, causal))
        if route != "simt":  # the SIMT kernel on the same inputs: its error and time
            o_s, lse_s = fa._fwd_cuda(q, k, v, scale, causal, "simt")
            numbers["simt_max_abs_err"] = max((o_s.float() - o_p.float()).abs().max().item(),
                                              (lse_s - lse_p).abs().max().item())
            check(numbers["simt_max_abs_err"] <= TOL[dname],
                  f"the SIMT forward disagrees at {shape} {dname}")
            numbers["simt_ms"] = time_ms(
                lambda: fa._fwd_cuda(q, k, v, scale, causal, "simt"))
        numbers["plain_ms"] = time_ms(lambda: fa.fwd_plain(q, k, v, scale, causal), reps=10)
        numbers["library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale))
        numbers.update(attention_bound_ms(b, s, h, d, dname, causal))
        out[(shape, dname)] = numbers
        simt = ""
        if "simt_ms" in numbers:
            simt = (f" simt_ms={numbers['simt_ms']:.4f} ({numbers['simt_ms'] / numbers['ms']:.2f}x "
                    f"the {route} time, max|d|={numbers['simt_max_abs_err']:.3e})")
            check_share(f"SIMT forward {shape} {dname}", numbers["bound_ms"], numbers["simt_ms"])
        print(f"  {shape} {dname}: kernel_ms={numbers['ms']:.4f} ({route}){simt} "
              f"plain_ms={numbers['plain_ms']:.4f} library_ms={numbers['library_ms']:.4f} "
              f"(torch SDPA; {route} / SDPA {numbers['ms'] / numbers['library_ms']:.2f}x) "
              f"{bound_text(numbers)}; kernel at {numbers['bound_ms'] / numbers['ms']:.1%} "
              f"of bound")
        check_share(f"forward {shape} {dname}", numbers["bound_ms"], numbers["ms"])
        if route == "tf32x3":
            check(numbers["ms"] < numbers["simt_ms"],
                  f"the tf32x3 forward ({numbers['ms']:.4f} ms) is not faster than the SIMT "
                  f"forward ({numbers['simt_ms']:.4f} ms) at {shape}")
    return out


def check_backward_kernels(torch, fa, gen, dev):
    """Phase 6: the backward kernels against ``bwd_plain`` (dK/dV and dQ,
    each on its three routes), the route of each launch, a second backward
    bitwise equal; timings at the main shape in f32 and bf16. Returns
    {dtype: {kernel: numbers}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print("[6] flash_attention_bwd_dkv / _dq (sm90, tf32x3 and SIMT routes) vs plain")
    cases = [  # (shape, causal, dtype, layout)
        (BWD_MAIN_SHAPE, True, torch.float32, "fused"),
        ((1, 600, 2, 24), True, torch.float32, "fused"),  # ragged S
        ((1, 128, 2, 32), False, torch.float32, "contiguous"),  # non-causal
        ((1, 512, 2, 128), True, torch.float32, "contiguous"),  # D = 128
        ((1, 200, 2, 160), True, torch.float32, "contiguous"),  # D > 128: SIMT
        ((1, 7, 1, 5), True, torch.float32, "contiguous"),  # ragged D: SIMT
    ]
    for dtype in (torch.bfloat16, torch.float16):
        cases += [
            (BWD_MAIN_SHAPE, True, dtype, "fused"),
            (FWD_MAIN_SHAPE, True, dtype, "fused"),
            ((2, 1000, 4, 64), True, dtype, "contiguous"),  # ragged S
            ((1, 512, 2, 128), False, dtype, "contiguous"),  # non-causal, D = 128
            ((1, 64, 1, 16), True, dtype, "contiguous"),  # one tile, D = 16
        ]
    out = {}
    for shape, causal, dtype, layout in cases:
        b, s, h, d = shape
        dname = dtype_name(dtype)
        q, k, v = qkv_on_card(shape, dtype, layout, gen, dev)
        do = torch.randn(shape, generator=gen, device=dev).to(dtype)
        route = route_of(fa, (q, k, v, do))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
        delta = fa.bwd_delta(o, do)
        wrappers = {"dkv": fa.flash_attention_bwd_dkv, "dq": fa.flash_attention_bwd_dq}
        before = {n: dict(fn.launches_by_route) for n, fn in wrappers.items()}
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
        dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
        ref = fa.bwd_plain(q, k, v, do, lse, delta, scale, causal)
        torch.cuda.synchronize()
        took = {n: {r: c - before[n][r] for r, c in fn.launches_by_route.items()}
                for n, fn in wrappers.items()}
        errs = [(g.float() - r.float()).abs().max().item() for g, r in zip((dq, dk, dv), ref)]
        bitwise = all(torch.equal(a, c) for a, c in zip((dq, dk, dv), (dq2, dk2, dv2)))
        ok = max(errs) <= GRAD_TOL[dname] and bitwise
        size = max(r.float().abs().max().item() for r in ref)
        print(f"  {shape} causal={causal} {dname} {layout}: route {route} (dkv {took['dkv']}, "
              f"dq {took['dq']}); max|d dQ|={errs[0]:.3e} max|d dK|={errs[1]:.3e} "
              f"max|d dV|={errs[2]:.3e} tol={GRAD_TOL[dname]:g} (largest gradient "
              f"{size:.3f}); second backward bitwise equal: {bitwise} {'ok' if ok else 'FAIL'}")
        for name in ("dkv", "dq"):
            check(took[name][route] == 2 and sum(took[name].values()) == 2,
                  f"{name} at {shape} {dname} did not take the {route} route: {took[name]}")
        check(ok, f"backward kernels disagree with their plain version at {shape} {dname}")
        check(all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv)),
              f"non-finite gradients at {shape}")
        if shape != BWD_MAIN_SHAPE:
            continue
        kernel = {
            "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal),
            "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal),
        }
        simt_kernel = {  # the SIMT kernels on the same inputs, for comparison
            "dkv": lambda: fa._bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal, "simt"),
            "dq": lambda: fa._bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal, "simt"),
        }
        plain_ms = time_ms(lambda: fa.bwd_plain(q, k, v, do, lse, delta, scale, causal),
                           reps=10)
        # the yardstick: PyTorch's fused attention backward, dq, dk and dv in one call
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
        o_lib = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale)
        do_t = do.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t,
                                                         retain_graph=True))
        if dname == "float32":  # the yardstick's kernels, whose names tell their arithmetic
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.autograd.grad(o_lib, (qt, kt, vt), do_t, retain_graph=True)
                torch.cuda.synchronize()
            names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
            print("  torch SDPA's f32 backward runs: " + "; ".join(n[:140] for n in names))
        out[dname] = {}
        for name, err in (("dkv", max(errs[1], errs[2])), ("dq", errs[0])):
            t = dict(ms=time_ms(kernel[name]), plain_ms=plain_ms,
                     # SDPA's backward computes the pair: stated once, on the dkv row
                     library_ms=library_ms if name == "dkv" else None, max_abs_err=err,
                     route=route)
            t.update(bwd_bound_ms(name, b, s, h, d, dname, causal))
            out[dname][name] = t
            simt = ""
            if route != "simt":  # the SIMT kernel on the same inputs: its error and time
                got = simt_kernel[name]()
                got = got if name == "dkv" else (got,)
                want = ref[1:] if name == "dkv" else ref[:1]
                simt_err = max((g.float() - r.float()).abs().max().item()
                               for g, r in zip(got, want))
                t["simt_ms"] = time_ms(simt_kernel[name])
                out[dname][name + "_simt"] = dict(t, ms=t["simt_ms"], max_abs_err=simt_err,
                                                  route="simt")
                simt = (f" simt_ms={t['simt_ms']:.4f} ({t['simt_ms'] / t['ms']:.1f}x the "
                        f"{route} time, simt at {t['bound_ms'] / t['simt_ms']:.1%} of bound, "
                        f"max|d|={simt_err:.3e})")
                check(simt_err <= GRAD_TOL[dname], f"SIMT {name} disagrees at {shape} {dname}")
                check_share(f"SIMT {name} {dname}", t["bound_ms"], t["simt_ms"])
            print(f"  {shape} {dname} {name}: kernel_ms={t['ms']:.4f} ({route}){simt} "
                  f"{bound_text(t)}; kernel at {t['bound_ms'] / t['ms']:.1%} of bound")
            check_share(f"{name} {dname}", t["bound_ms"], t["ms"])
        # the pair on its route, on SIMT and the library, one after another
        pair_ms = time_ms(lambda: (kernel["dkv"](), kernel["dq"]()))
        out[dname]["pair_ms"] = pair_ms
        simt_pair_ms = time_ms(lambda: (simt_kernel["dkv"](), simt_kernel["dq"]()))
        out[dname]["simt_pair_ms"] = simt_pair_ms
        library_again_ms = time_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t,
                                                               retain_graph=True))
        out[dname]["library_again_ms"] = library_again_ms
        print(f"  {shape} {dname}: plain_ms={plain_ms:.4f} (dQ, dK, dV together) "
              f"library_ms={library_ms:.4f} (torch SDPA backward, dQ, dK, dV together); "
              f"{route} pair dK/dV + dQ {pair_ms:.4f} ms, SIMT pair {simt_pair_ms:.4f} ms, "
              f"SDPA again {library_again_ms:.4f} ms; {route} pair / SDPA "
              f"{pair_ms / library_again_ms:.2f}x, SIMT pair / {route} pair "
              f"{simt_pair_ms / pair_ms:.2f}x, SIMT pair / SDPA "
              f"{simt_pair_ms / library_again_ms:.2f}x")
        if route == "tf32x3":
            check(pair_ms < simt_pair_ms, f"the tf32x3 pair ({pair_ms:.4f} ms) is not faster "
                                          f"than the SIMT pair ({simt_pair_ms:.4f} ms)")
        del qt, kt, vt, o_lib
    return out




def simt_backward_path(torch, pt, fa, gen, dev):
    """Phase 6, last: f32 attention at SIMT_PATH_CASES through the user entry
    point (``nn.functional.scaled_dot_product_attention`` with the flash flag
    on) and autograd, the path that still reaches the SIMT backward kernels.
    Returns the flash launches by route over it."""
    import paddle_tpu_torch.nn.functional as F

    pt.set_flags({"FLAGS_use_flash_attention": True})
    reset_flash_counts(fa)  # the SIMT backward path's count starts here
    for shape, causal in SIMT_PATH_CASES:
        q, k, v = (x.requires_grad_() for x in qkv_on_card(shape, torch.float32, "contiguous",
                                                            gen, dev))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        grads = torch.autograd.grad(out, (q, k, v), torch.randn(shape, generator=gen, device=dev))
        check(all(bool(torch.isfinite(g).all()) for g in grads), f"non-finite grads at {shape}")
    torch.cuda.synchronize()
    launches = flash_counts(fa)  # ... and ends here
    print(f"  the SIMT backward path, f32 {[c[0] for c in SIMT_PATH_CASES]} through "
          f"nn.functional.scaled_dot_product_attention and autograd: {launches}")
    n = len(SIMT_PATH_CASES)
    check(launches["dkv_simt"] == launches["dq_simt"] == launches["fwd_simt"] == n
          and sum(launches.values()) == 3 * n,
          f"the SIMT backward path launched {launches}, not one SIMT fwd, dkv, dq per case")
    return launches


FLASH_WRAPPERS = {"fwd": "flash_attention_fwd", "dkv": "flash_attention_bwd_dkv",
                  "dq": "flash_attention_bwd_dq"}


def reset_flash_counts(fa):
    for attr in FLASH_WRAPPERS.values():
        fn = getattr(fa, attr)
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(fa.ROUTES, 0)


def flash_counts(fa):
    """Launches of each flash kernel by route: {"fwd_sm90": n, "fwd_simt": n, ...}."""
    return {f"{kernel}_{route}": n for kernel, attr in FLASH_WRAPPERS.items()
            for route, n in getattr(fa, attr).launches_by_route.items()}


SERVE_PROMPT_LENS = (32, 64, 48, 128, 64, 32)  # bench.py bench_serving's mix
SERVE_REQUESTS, SERVE_NEW_TOKENS = 12, 24
# execute's fast path, held against a direct call of the thunk at the end
# of phase 5c. Per call (a loop of FAST_PATH_CALLS calls): at most
# FAST_PATH_CALL_US more. Per decode step of the clean mix, execute against
# bypassed in turns: the step's launch and device ms medians at most
# FAST_PATH_STEP_MS apart (the median over rounds of each round's gap). The
# bounds sit several times above the sound readings (PERF.md section 5) and
# far below what a host wait for the card inside execute would add (a
# decode step's ~4 ms)
FAST_PATH_CALLS, FAST_PATH_CALL_US, FAST_PATH_STEP_MS = 200_000, 3.0, 0.1
# the sustained run: the same mix arriving in a stagger (Poisson arrivals per
# scheduler tick) into a pool that holds about 16 of its requests at once,
# so admissions land mid-decode, batch sizes change and backpressure fires
SUSTAINED_REQUESTS, SUSTAINED_ARRIVALS_PER_TICK, SUSTAINED_BLOCKS = 256, 0.7, 96


def staggered_arrivals(n, rate, seed):
    """Requests submitted before each scheduler tick: Poisson(``rate``)
    draws from ``seed`` until ``n`` have arrived."""
    import numpy as np

    rng, out, total = np.random.default_rng(seed), [], 0
    while total < n:
        out.append(min(int(rng.poisson(rate)), n - total))
        total += out[-1]
    return out


def serve_staggered(eng, prompts, arrivals, n_new):
    """Drive ``eng`` as a server loop does: before each tick submit that
    tick's arrivals, then ``step()``; go on stepping once every request has
    arrived, until none is pending. Returns the responses in submit order,
    the ticks that ended with requests still queued (backpressure: the pool
    could not take them) and the deepest queue."""
    ids, waiting, deepest, left, tick = [], 0, 0, iter(prompts), 0
    while tick < len(arrivals) or eng.pending:
        if tick < len(arrivals):
            ids += [eng.submit(next(left), max_new_tokens=n_new) for _ in range(arrivals[tick])]
        eng.step()
        tick += 1
        queued = eng.routing_signals()["queue_depth"]
        waiting += queued > 0
        deepest = max(deepest, queued)
    eng.run_until_idle()  # the drop and leak audit
    return [eng.pop_response(i) for i in ids], waiting, deepest


def serve_window(eng, resps, dt, c, card):
    """The numbers of one timed serve, from its responses, the dispatch
    counters ``c`` and the engine's own step timings (host clock, CUDA
    events for the device)."""
    import numpy as np

    st, steps = eng.stats(), eng.step_timings()
    check(steps, "the engine recorded no step")
    ok = [r for r in resps if r.ok]
    # per-token latency: a request's first token takes its prefill step
    # (feed, launch, wait); each later token the host-clock gap since the
    # request's previous token, which counts the other groups' steps and the
    # prefills between the two
    last, lat = {}, []
    for t in steps:
        for rid in t.request_ids:
            lat.append((t.end - last[rid]) * 1e3 if rid in last
                       else t.feed_ms + t.launch_ms + t.wait_ms)
            last[rid] = t.end
    # the histogram's own samples (launch to tokens on the host, one per row
    # of the step), exact, beside what its log buckets make of them
    hist = [t.launch_ms + t.wait_ms for t in steps for _ in t.request_ids]
    decode = [t for t in steps if t.kind == "decode"]
    ms = {"feeds": [t.feed_ms for t in decode], "launch": [t.launch_ms for t in decode],
          "wait_read": [t.wait_ms for t in decode], "device": [t.device_ms for t in decode]}
    step_ms = [t.feed_ms + t.launch_ms + t.wait_ms for t in decode]
    rows = {}
    for t in decode:
        rows[len(t.request_ids)] = rows.get(len(t.request_ids), 0) + 1
    blocks = st["pool_blocks"]

    def pct(v):
        return [float(np.percentile(v, q)) for q in (50, 99)]

    return {
        "card": card,
        "requests": len(resps), "completed": len(ok), "serve_s": dt,
        "requests_per_s": len(ok) / dt,
        "tokens_per_s": sum(len(r.tokens) for r in ok) / dt,
        "token_lat_p50_p99_ms": pct(lat),
        "token_lat_samples": len(lat),
        "histogram_p50_p99_ms": [st["token_lat_p50_ms"], st["token_lat_p99_ms"]],
        "histogram_samples_p50_p99_ms": pct(hist),
        "ttft_p50_p99_ms": pct([(r.first_token_time - r.submit_time) * 1e3 for r in ok]),
        "request_lat_p50_p99_ms": pct([(r.done_time - r.submit_time) * 1e3 for r in ok]),
        "programs_per_decode_step": (c["serve_capture_replays"] - c["serve_prefills"])
        / max(1, c["serve_decode_steps"]),
        "decode_steps": c["serve_decode_steps"],
        "prefills": c["serve_prefills"],
        "capture_replays": c["serve_capture_replays"],
        "capture_builds_steady": c["serve_capture_builds"],
        "capture_evictions": c["serve_capture_evictions"],
        "serve_capture_fallbacks": c["serve_capture_fallbacks"],
        "dropped": c["serve_requests_dropped"],
        "block_leaks": c["serve_block_leaks"],
        "rows_per_decode_step": dict(sorted(rows.items())),
        "decode_split_ms": {k: statistics.median(v) for k, v in ms.items()},
        "decode_step_ms_p50_p99": pct(step_ms),
        "decode_device_idle_share": 1.0 - sum(ms["device"]) / sum(step_ms),
        "window_device_idle_share": 1.0 - sum(t.device_ms for t in steps) / (dt * 1e3),
        "kv_pool_blocks": blocks,
        "kv_pool_peak_blocks": round(st["pool_peak_occupancy"] * blocks),
        "kv_pool_bytes": 2 * sum(t.numel() * t.element_size() for t in eng._pool.k),
    }


def print_window(label, rec):
    lat, hist, exact = (rec["token_lat_p50_p99_ms"], rec["histogram_p50_p99_ms"],
                        rec["histogram_samples_p50_p99_ms"])
    print(f"  {label}: {rec['completed']} of {rec['requests']} ok in {rec['serve_s']:.3f} s, "
          f"{rec['requests_per_s']:.2f} requests/s, {rec['tokens_per_s']:.1f} tokens/s; token "
          f"latency p50/p99 {lat[0]:.3f}/{lat[1]:.3f} ms over {rec['token_lat_samples']} tokens "
          f"(the engine's histogram {hist[0]}/{hist[1]}, its samples exactly "
          f"{exact[0]:.3f}/{exact[1]:.3f}); first token p50/p99 {rec['ttft_p50_p99_ms'][0]:.1f}/"
          f"{rec['ttft_p50_p99_ms'][1]:.1f} ms from submit, whole request "
          f"{rec['request_lat_p50_p99_ms'][0]:.1f}/{rec['request_lat_p50_p99_ms'][1]:.1f} ms")
    print(f"    {rec['decode_steps']} decode steps (rows per step: {rec['rows_per_decode_step']}), "
          f"{rec['prefills']} prefills, {rec['capture_replays']} graph replays, "
          f"{rec['programs_per_decode_step']:g} programs per decode step, "
          f"{rec['capture_builds_steady']} builds, {rec['capture_evictions']} evictions; pool peak "
          f"{rec['kv_pool_peak_blocks']} of {rec['kv_pool_blocks']} blocks")
    print("    decode step medians in ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in rec["decode_split_ms"].items())
          + f"; step p50/p99 {rec['decode_step_ms_p50_p99'][0]:.3f}/"
            f"{rec['decode_step_ms_p50_p99'][1]:.3f}; device idle "
            f"{rec['decode_device_idle_share']:.1%} of the decode steps' host time, "
            f"{rec['window_device_idle_share']:.1%} of the window")


def check_window(rec, resps, n_new, vocab):
    check(rec["completed"] == rec["requests"], f"{rec['requests'] - rec['completed']} requests "
          f"did not end ok: {sorted({r.status for r in resps})}")
    check(all(len(r.tokens) == n_new and all(0 <= t < vocab for t in r.tokens) for r in resps),
          "a response has the wrong number of tokens or an id out of range")
    check(rec["programs_per_decode_step"] == 1.0 and rec["capture_builds_steady"] == 0,
          "the steady serve did not replay exactly one captured program per decode step")
    check(rec["capture_replays"] > 0, "no CUDA graph was replayed")
    check(rec["serve_capture_fallbacks"] == rec["dropped"] == rec["block_leaks"]
          == rec["capture_evictions"] == 0,
          f"fallbacks, drops, leaked blocks or evictions in the steady serve: {rec}")
    check(rec["token_lat_samples"] == rec["requests"] * n_new, "the step timings miss a token")


def serve_345m(torch, pt, fa, fu, card):
    """Phase 5b: ``serving.Engine`` over GPT-2 345M f32 at full width and
    depth (``gpt2_345m(max_seq_len=2048)``, bench.py's
    BENCH_SERVING_MODEL=345m). First bench_serving's mix: a warm serve that
    captures every signature and a timed one. Then a sustained run of the
    mix with staggered arrivals into a
    small pool (warm, then timed). Then the eager rung (FLAGS_serving_capture
    off) on both schedules, and ``generate()`` per request of the mix.
    Checks that the path launches no hand-written kernel. Returns what phase
    5c serves with: the model, the mix, its tokens and its tokens/s."""
    import numpy as np

    from paddle_tpu_torch import profiler, serving
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt2_345m

    print(f"[5b] serving.Engine, GPT-2 345M f32, {SERVE_REQUESTS} requests, prompts "
          f"{SERVE_PROMPT_LENS} cycled, {SERVE_NEW_TOKENS} new tokens each; {card}")
    pt.seed(0)
    cfg = gpt2_345m(max_seq_len=2048, dropout=0.0, attn_dropout=0.0)
    model = GPTForPretraining(cfg, device="gpu:0").eval()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, SERVE_PROMPT_LENS[i % len(SERVE_PROMPT_LENS)])
               for i in range(SERVE_REQUESTS)]
    n_new = SERVE_NEW_TOKENS

    def engine(**kw):
        return serving.Engine(model, serving.ServingConfig(
            block_size=16, prompt_buckets=[32, 64, 128], **kw))

    def timed(eng, run):
        profiler.reset_dispatch_counters()
        eng.reset_stats()
        t0 = time.perf_counter()
        out = run()
        return out, time.perf_counter() - t0, profiler.dispatch_counters()

    reset_flash_counts(fa)  # the serving path's count starts here
    for kernel in fu.KERNELS.values():
        kernel.launches = 0
    profiler.reset_dispatch_counters()
    eng = engine()
    t0 = time.perf_counter()
    eng.serve(prompts, max_new_tokens=n_new)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm, capture = profiler.dispatch_counters(), lazy.serve_capture_state()
    print(f"  warm serve {warm_s:.2f} s: {warm['serve_capture_builds']} programs built, "
          f"{capture['cuda_graphs']} CUDA graphs, {warm['serve_prefills']} prefills, "
          f"{warm['serve_decode_steps']} decode steps")
    check(capture["cuda_graphs"] == warm["serve_capture_builds"] == capture["cached_programs"],
          "a serve program was built without its CUDA graph")

    resps, dt, c = timed(eng, lambda: eng.serve(prompts, max_new_tokens=n_new))
    rec = serve_window(eng, resps, dt, c, card)
    print_window("timed serve", rec)
    check_window(rec, resps, n_new, cfg.vocab_size)

    # (the torch.profiler trace of one decode tick is taken at the end of
    # phase 5c: after a profiler session every launch costs the host ~0.2 ms
    # more, which would skew every host-clock window after it)
    eng.close()

    # the sustained run: the mix cycled over SUSTAINED_REQUESTS requests,
    # Poisson arrivals per tick, a pool of SUSTAINED_BLOCKS blocks
    lens = [SERVE_PROMPT_LENS[i % len(SERVE_PROMPT_LENS)] for i in range(SUSTAINED_REQUESTS)]
    rng = np.random.default_rng(1)
    many = [rng.integers(1, cfg.vocab_size, n) for n in lens]
    arrivals = staggered_arrivals(SUSTAINED_REQUESTS, SUSTAINED_ARRIVALS_PER_TICK, 2)
    print(f"  sustained: {SUSTAINED_REQUESTS} requests of the mix, Poisson "
          f"{SUSTAINED_ARRIVALS_PER_TICK} arrivals per tick over {len(arrivals)} ticks, "
          f"{n_new} new tokens each, a pool of {SUSTAINED_BLOCKS} blocks")
    sus = engine(num_blocks=SUSTAINED_BLOCKS)
    profiler.reset_dispatch_counters()
    t0 = time.perf_counter()
    warm_out = serve_staggered(sus, many, arrivals, n_new)[0]
    built, capture = profiler.dispatch_counters()["serve_capture_builds"], lazy.serve_capture_state()
    print(f"  sustained warm run {time.perf_counter() - t0:.2f} s, {built} programs built, "
          f"{capture['cuda_graphs']} CUDA graphs")
    check(all(r.ok for r in warm_out), "a request of the sustained warm run did not end ok: "
                                      f"{sorted({r.status for r in warm_out})}")
    check(0 < built == capture["cuda_graphs"],
          "the sustained run's engine did not capture its signatures as CUDA graphs")
    (sresps, waiting, deepest), dt, c = timed(
        sus, lambda: serve_staggered(sus, many, arrivals, n_new))
    srec = serve_window(sus, sresps, dt, c, card)
    srec.update(ticks_with_backpressure=waiting, deepest_queue=deepest,
                arrival_ticks=len(arrivals))
    print_window("sustained timed run", srec)
    print(f"    backpressure: {waiting} ticks ended with requests queued for blocks, "
          f"the deepest queue {deepest}")
    check_window(srec, sresps, n_new, cfg.vocab_size)
    check(waiting > 0, "the sustained run never queued a request for blocks")
    check(len(srec["rows_per_decode_step"]) > 2, "the sustained run's batch sizes never changed")
    rec["sustained"] = srec
    sus.close()

    # the eager rung on both schedules, and generate() per request of the mix
    pt.set_flags({"FLAGS_serving_capture": False})
    try:
        eager_eng = engine(keep_logits=True)
        t0 = time.perf_counter()
        eager = eager_eng.serve(prompts, max_new_tokens=n_new)
        rec["eager_tokens_per_s"] = sum(len(r.tokens) for r in eager) / (
            time.perf_counter() - t0)
        eager_eng.close()
        eager_sus = engine(num_blocks=SUSTAINED_BLOCKS)
        t0 = time.perf_counter()
        eager_many = serve_staggered(eager_sus, many, arrivals, n_new)[0]
        srec["eager_tokens_per_s"] = sum(len(r.tokens) for r in eager_many) / (
            time.perf_counter() - t0)
        eager_sus.close()
    finally:
        pt.set_flags({"FLAGS_serving_capture": True})
    check(all(r.ok for r in eager + eager_many), "an eager request did not end ok")
    check([r.tokens for r in eager] == [r.tokens for r in resps],
          "the captured serve's tokens differ from the eager serve's")
    differ = sum(a.tokens != b.tokens for a, b in zip(eager_many, sresps))
    check(not differ, f"{differ} requests of the sustained run differ from the eager rung's")
    near_ties = []
    for i, (p, r) in enumerate(zip(prompts, eager)):
        want = model.generate(p[None, :], max_new_tokens=n_new).cpu().numpy()[0, len(p):]
        diff = [j for j, (a, b) in enumerate(zip(r.tokens, want.tolist())) if a != b]
        if not diff:
            continue
        j = diff[0]  # past the first difference the two contexts differ
        top2 = np.sort(r.logits[j])[-2:]
        near_ties.append({"request": i, "token": j, "margin": float(top2[1] - top2[0])})
        check(top2[1] - top2[0] < TOL_LOGITS,
              f"request {i} token {j}: engine {r.tokens[j]} vs generate() {want[j]} with a "
              f"top-2 margin {top2[1] - top2[0]:.3e} >= {TOL_LOGITS:g}")
    rec["generate_near_ties"] = near_ties
    print(f"  eager rung: the mix {rec['eager_tokens_per_s']:.1f} tokens/s, the sustained run "
          f"{srec['eager_tokens_per_s']:.1f} tokens/s; both give the captured runs' tokens; "
          f"generate() per request of the mix agrees except {len(near_ties)} near-ties "
          f"(top-2 margin < {TOL_LOGITS:g}): {near_ties}")

    launches = flash_counts(fa)  # the serving path's count ends here
    launches.update({k: n.launches for k, n in fu.KERNELS.items()})
    print(f"  kernel launches over the serving path: {launches}")
    check(not any(launches.values()), "the serving path launched a hand-written kernel: its "
                                      "attention is the paged torch composition")
    print("serving: " + json.dumps(rec))
    torch.cuda.empty_cache()
    return {"model": model, "prompts": prompts, "tokens": [r.tokens for r in resps],
            "tokens_per_s": rec["tokens_per_s"]}


def serve_under_faults(torch, pt, fa, fu, card, served):
    """Phase 5c: phase 5b's 345M f32 engine configuration and mix under the
    resilience runtime, scenario by scenario as ``tools/serve_probe.py``
    lists them: injected faults, a decode storm the ladder demotes and
    re-promotes, prefill faults, a fault after a graph wrote the pool, a
    wedged tick under ``serving.Supervisor`` (restart, then a permanent
    wedge that fails clean), a stalled tick, SIGTERM, the generative
    predictor, then the cost of ``execute``'s fast path (per call in a
    loop, and per decode step of the clean mix in turns against execute
    bypassed), and a profiler
    trace of one decode tick. Every scenario answers every request with no
    drop and no leaked block."""
    import signal
    import tempfile
    import threading

    import numpy as np

    from paddle_tpu_torch import inference, profiler, resilience, serving
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.profiler import trace
    from paddle_tpu_torch.resilience import runtime as rt

    model, prompts, clean = served["model"], served["prompts"], served["tokens"]
    n_new = SERVE_NEW_TOKENS
    clean_tps = served["tokens_per_s"]
    print(f"[5c] serving under faults: the mix of 5b on GPT-2 345M f32, clean "
          f"{clean_tps:.1f} tokens/s in 5b; {card}")
    reset_flash_counts(fa)  # 5c's count starts here
    for kernel in fu.KERNELS.values():
        kernel.launches = 0
    # several engines hold graphs at once here: room for all of them
    pt.set_flags({"FLAGS_serving_capture_cache_size": 64})
    out = {"card": card}

    def engine(**kw):
        return serving.Engine(model, serving.ServingConfig(
            block_size=16, prompt_buckets=[32, 64, 128], **kw))

    def fresh(spec=""):
        resilience.reset()
        profiler.reset_dispatch_counters()
        pt.set_flags({"FLAGS_fault_inject": spec, "FLAGS_retry_backoff_ms": 0.5})

    def audit(name, resps, dt, statuses=("ok",), keys=()):
        c = profiler.dispatch_counters()
        check(all(r is not None for r in resps), f"{name}: a request got no response")
        check(all(r.status in statuses for r in resps),
              f"{name}: statuses {sorted({r.status for r in resps})}, expected {statuses}")
        check(c["serve_requests_dropped"] == c["serve_block_leaks"] == 0,
              f"{name}: {c['serve_requests_dropped']} dropped, "
              f"{c['serve_block_leaks']} leaked blocks")
        toks = sum(len(r.tokens) for r in resps if r.ok)
        rec = {"requests": len(resps), "ok": sum(r.ok for r in resps), "wall_s": dt,
               "tokens_per_s": toks / dt}
        rec.update({k: (dict(c[k]) if hasattr(c[k], "items") else c[k]) for k in keys})
        print(f"  [{name}] {rec['ok']} of {rec['requests']} ok in {dt:.3f} s "
              f"({rec['tokens_per_s']:.1f} tokens/s), 0 dropped, 0 leaked blocks; "
              + ", ".join(f"{k} {rec[k]}" for k in keys))
        out[name] = rec
        return rec

    def serve(eng):
        t0 = time.perf_counter()
        resps = eng.serve(prompts, max_new_tokens=n_new)
        return resps, time.perf_counter() - t0

    def step_ms(eng, rung):
        return [t.feed_ms + t.launch_ms + t.wait_ms for t in eng.step_timings()
                if t.kind == "decode" and t.rung == rung]

    fault_keys = ("injected_faults", "retry_attempts", "retry_exhausted", "fault_events",
                  "ladder_demotions", "ladder_promotions", "serve_capture_fallbacks",
                  "serve_request_requeues", "fault_sites")
    fresh()
    eng = engine()
    check([r.tokens for r in serve(eng)[0]] == clean, "5c's engine gave other tokens")

    # faults: transient injected faults at p=0.2, every one retried
    fresh("execute:p=0.2")
    resps, dt = serve(eng)
    rec = audit("faults", resps, dt, keys=fault_keys)
    check([r.tokens for r in resps] == clean, "faults: tokens differ from the clean serve's")
    check(rec["injected_faults"] > 0, "faults: nothing was injected")
    print(f"    {rec['tokens_per_s']:.1f} tokens/s under p=0.2 against {clean_tps:.1f} clean")

    # storm: every decode step faults past its retries; the ladder demotes
    # the buckets to the retained rung, and after the storm the cooldown
    # re-promotes them and their graphs replay again
    fresh("execute:p=1:x=3:decode")
    eng.reset_stats()
    resps, dt = serve(eng)
    rec = audit("storm", resps, dt, keys=fault_keys)
    check([r.tokens for r in resps] == clean, "storm: tokens differ from the clean serve's")
    check(rec["ladder_demotions"] >= 1 and rec["serve_capture_fallbacks"] > 0,
          "storm: the ladder did not demote")
    storm_ms = {rung: step_ms(eng, rung) for rung in ("captured", "retained", "eager")}
    pt.set_flags({"FLAGS_fault_inject": ""})  # the ladder keeps its state
    profiler.reset_dispatch_counters()
    eng.reset_stats()
    resps, dt = serve(eng)
    rec = audit("storm_cooldown", resps, dt,
                keys=("ladder_promotions", "serve_capture_replays", "serve_capture_builds"))
    rungs = [t.rung for t in eng.step_timings() if t.kind == "decode"]
    check([r.tokens for r in resps] == clean, "storm cooldown: tokens differ")
    check(rec["ladder_promotions"] >= 1, "storm cooldown: no bucket was re-promoted")
    check("retained" in rungs and rungs[-1] == "captured"
          and rungs.index("captured") > rungs.index("retained"),
          f"storm cooldown: no graph replayed after the demotion: {rungs}")
    demoted, captured = step_ms(eng, "retained"), step_ms(eng, "captured")
    rec.update(demoted_step_ms_median=statistics.median(demoted),
               captured_step_ms_median=statistics.median(captured),
               demoted_steps=len(demoted), captured_steps=len(captured),
               storm_step_ms_median={k: statistics.median(v) for k, v in storm_ms.items() if v})
    print(f"    decode step medians: demoted (retained rung, copies of the pool) "
          f"{rec['demoted_step_ms_median']:.3f} ms over {len(demoted)} steps, captured "
          f"{rec['captured_step_ms_median']:.3f} ms over {len(captured)} (x"
          f"{rec['demoted_step_ms_median'] / rec['captured_step_ms_median']:.1f}); in the "
          f"storm, by rung: {rec['storm_step_ms_median']}")

    # prefill: the first prefill of every tick faults once and is retried
    fresh("execute:p=1:x=1:prefill")
    resps, dt = serve(eng)
    rec = audit("prefill", resps, dt, keys=fault_keys)
    check([r.tokens for r in resps] == clean, "prefill: tokens differ")
    check(rec["retry_attempts"] > 0, "prefill: nothing was retried")

    # pool consumed: a real fault raised after a decode graph's replay wrote
    # the pool; the pool is zeroed in place and every sequence requeued
    fresh()
    real_captured = lazy._ServeProgram._captured
    fired = []

    def fails_after_replay(prog, k_pools, v_pools, feeds):
        result = real_captured(prog, k_pools, v_pools, feeds)
        if prog.key[0] == "decode" and not fired:
            fired.append(prog.key)
            raise RuntimeError("simulated fault after the graph replay wrote the pool")
        return result

    pools = list(eng._pool.k + eng._pool.v)
    lazy._ServeProgram._captured = fails_after_replay
    try:
        resps, dt = serve(eng)
    finally:
        lazy._ServeProgram._captured = real_captured
    rec = audit("pool_consumed", resps, dt, keys=fault_keys + ("fatal_faults",))
    check(fired and rec["serve_capture_fallbacks"] == 1 and rec["fatal_faults"] == 1,
          "pool consumed: the fault did not take the captured rung's recovery")
    check(rec["serve_request_requeues"] == SERVE_REQUESTS,
          "pool consumed: not every in-flight sequence was requeued")
    check(all(a is b for a, b in zip(pools, eng._pool.k + eng._pool.v)),
          "pool consumed: the pool tensors were replaced, not zeroed in place")
    check([r.tokens for r in resps] == clean, "pool consumed: tokens differ")

    # wedge: under the Supervisor a tick raises once, with a second engine's
    # graphs alive in the shared graph pool while this one re-captures
    bystander = engine()
    bystander.serve(prompts[:2], max_new_tokens=4)
    fresh()
    sup = serving.Supervisor(eng)
    restarted = []
    real_restart, real_decode = eng.restart, eng._decode_batch

    def timed_restart(err):
        restarted.append(time.perf_counter())
        real_restart(err)

    def wedge_once(chunk, n_blk):
        if not restarted:
            raise RuntimeError("tick bug escaped the ladder")
        return real_decode(chunk, n_blk)

    eng.restart, eng._decode_batch = timed_restart, wedge_once
    trace.clear()
    eng.reset_stats()
    try:
        ids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        t0 = time.perf_counter()
        sup.run_until_idle()
        dt = time.perf_counter() - t0
        resps = [eng.pop_response(i) for i in ids]
    finally:
        sup.close()
        del eng.restart, eng._decode_batch
    rec = audit("wedge", resps, dt,
                keys=("serve_engine_restarts", "serve_request_requeues",
                      "serve_capture_builds", "serve_health_transitions"))
    health = [e.attrs["state"] for e in trace.events(kind="serve")
              if e.attrs.get("phase") == "health" and e.attrs.get("engine") == eng._uid]
    first = min(t.end for t in eng.step_timings() if t.end > restarted[0])
    rec.update(restart_to_next_token_ms=(first - restarted[0]) * 1e3, health=health)
    check(sup.restarts == 1 and rec["serve_engine_restarts"] == 1, "wedge: not one restart")
    check([r.tokens for r in resps] == clean, "wedge: tokens differ from the clean serve's")
    check(health[:2] == ["degraded", "ready"], f"wedge: health went {health}")
    check(rec["serve_capture_builds"] > 0, "wedge: the restarted engine did not re-capture")
    print(f"    restart to the next token {rec['restart_to_next_token_ms']:.1f} ms (re-capture "
          f"included, another engine's graphs alive); health {health}")

    # the permanent wedge: past max_restarts=2 the engine fails clean
    with tempfile.TemporaryDirectory() as pm_dir:
        pt.set_flags({"FLAGS_postmortem_dir": pm_dir})
        dead = engine()
        sup = serving.Supervisor(dead, max_restarts=2)

        def always_wedged(chunk, n_blk):
            raise RuntimeError("permanently wedged")

        dead._decode_batch = always_wedged
        try:
            ids = [dead.submit(p, max_new_tokens=n_new) for p in prompts]
            t0 = time.perf_counter()
            sup.run_until_idle()
            dt = time.perf_counter() - t0
            resps = [dead.pop_response(i) for i in ids]
        finally:
            sup.close()
            pt.set_flags({"FLAGS_postmortem_dir": ""})
        rec = audit("wedge_dead", resps, dt, statuses=("error",),
                    keys=("serve_engine_restarts",))
        dumps = sorted(os.listdir(pm_dir))
        check(dead.health == "dead" and sup.restarts == 3, "permanent wedge: not dead")
        dead_dumps = [d for d in dumps if d.startswith("postmortem_engine_dead")]
        check(dead_dumps, f"permanent wedge: no engine_dead postmortem in {dumps}")
        doc = trace.read_postmortem(os.path.join(pm_dir, dead_dumps[0]))
        rec.update(postmortems=dumps, postmortem_memory=doc["memory"])
        print(f"    health {dead.health}; postmortems {dumps}; memory section {doc['memory']}")
    dead.close()
    bystander.close()

    # stall: a tick sleeps 0.5 s having decoded nothing; the watchdog
    # (FLAGS_trace_stall_ms 200) trips, the Supervisor restarts the engine,
    # this time with no other engine's graphs alive. Then a tick as slow
    # that did decode: no restart
    fresh()
    pt.set_flags({"FLAGS_trace_stall_ms": 200.0})
    for productive in (False, True):
        sup = serving.Supervisor(eng)
        stalled, real_decode = [], eng._decode_batch

        def stall_tick(chunk, n_blk):
            if not stalled:
                stalled.append(eng._tick_no)
                time.sleep(0.5)
            if stalled[0] == eng._tick_no and not productive:
                return True  # no group of the tick decodes
            return real_decode(chunk, n_blk)

        try:
            ids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
            eng.step()  # admit everything and arm the heartbeat
            eng._decode_batch = stall_tick
            t0 = time.perf_counter()
            sup.run_until_idle()
            dt = time.perf_counter() - t0
            resps = [eng.pop_response(i) for i in ids]
        finally:
            sup.close()
            del eng._decode_batch
        name = "stall_productive" if productive else "stall"
        rec = audit(name, resps, dt, keys=("serve_engine_restarts",))
        rec["supervisor_restarts"] = sup.restarts
        check([r.tokens for r in resps] == clean, f"{name}: tokens differ")
        check(sup.restarts == (0 if productive else 1), f"{name}: {sup.restarts} restarts")
        profiler.reset_dispatch_counters()
    pt.set_flags({"FLAGS_trace_stall_ms": 0.0})
    out["watchdog_stalls"] = trace.stall_count()

    # sigterm: SIGTERM from a timer thread mid-serve, the handler installed
    fresh()
    sig = engine()
    sig.install_preemption_handler()
    try:
        ids = [sig.submit(p, max_new_tokens=n_new) for p in prompts]
        t0 = time.perf_counter()
        sig.step()
        killer = threading.Timer(0.01, lambda: os.kill(os.getpid(), signal.SIGTERM))
        killer.start()
        killer.join()
        sig.run_until_idle()
        dt = time.perf_counter() - t0
        late = sig.submit(prompts[0], max_new_tokens=n_new)
        resps = [sig.pop_response(i) for i in ids]
    finally:
        sig.uninstall_preemption_handler()
    rec = audit("sigterm", resps, dt, keys=("serve_preempt_drains",))
    rec["late_submit"] = sig.response(late).status
    check(rec["late_submit"] == "rejected" and rec["serve_preempt_drains"] == 1,
          f"sigterm: late submit {rec['late_submit']}, drains {rec['serve_preempt_drains']}")
    check([r.tokens for r in resps] == clean, "sigterm: tokens differ")
    sig.close()

    # predictor: create_predictor on a generative Config, then a pool of two
    # independent replicas that routes around a draining one
    fresh()
    config = inference.Config()
    config.enable_generative_serving(model, block_size=16, prompt_buckets=[32, 64, 128],
                                     max_new_tokens=n_new)
    rows = [i for i, p in enumerate(prompts) if p.size == 32][:4]
    ids = np.stack([prompts[i] for i in rows])
    pred = inference.create_predictor(config)
    t0 = time.perf_counter()
    (tokens,) = pred.run([ids])
    dt = time.perf_counter() - t0
    check(tokens.shape == (4, n_new), f"predictor: tokens of shape {tokens.shape}")
    check(tokens.tolist() == [clean[i] for i in rows], "predictor: tokens differ")
    pool = inference.PredictorPool(config, size=2, clone=False)
    a, b = pool.retrieve(0), pool.retrieve(1)
    a.engine.begin_drain()
    picks = [pool.acquire() for _ in range(4)]
    check(all(p is b for p in picks), "predictor pool: did not route around the draining one")
    check(b.run([ids])[0].tolist() == tokens.tolist(), "predictor pool: tokens differ")
    out["predictor"] = {"shape": list(tokens.shape), "wall_s": dt, "pool_healths": pool.healths()}
    print(f"  [predictor] run([ids]) on {list(ids.shape)}: tokens {list(tokens.shape)} equal to "
          f"the engine's, {dt:.3f} s; pool healths {pool.healths()}, 4 of 4 acquires on the "
          f"ready replica, its tokens equal")
    for p in (pred, a, b):
        p.engine.close()

    # execute's fast path costs nothing measurable. Per call: a loop of
    # execute over a thunk that returns at once, in turns with the direct
    # call, the smallest of three of each
    fresh()
    pt.set_flags({"FLAGS_retry_backoff_ms": 5.0})
    key = ("decode", eng._uid)

    def per_call_ns(fn):
        t0 = time.perf_counter_ns()
        for _ in range(FAST_PATH_CALLS):
            fn()
        return (time.perf_counter_ns() - t0) / FAST_PATH_CALLS

    calls = {"execute": [], "direct": []}
    for _ in range(3):
        calls["execute"].append(per_call_ns(
            lambda: rt.execute("decode", lambda: key, ladder_key=key, retry_unsafe=True)))
        calls["direct"].append(per_call_ns(lambda: key))
    call_us = (min(calls["execute"]) - min(calls["direct"])) / 1e3

    # per decode step: the clean mix with execute on its fast path (twice, A
    # and A2: the turns' own noise) and bypassed (B, a direct call of the
    # thunk), in turns. The fast path runs inside the step's launch ms, and
    # the device ms (CUDA events) span the launch too. Each round serves
    # A, B, A2, A2, B, A and gives each mode's median step; a gap is the
    # median over the rounds of the round's difference, so neither a drift
    # of the host nor a round in which the card's step time moved decides it
    serve(eng)  # re-capture after the stall restart
    real_execute = rt.execute
    fields, rounds = ("launch_ms", "device_ms"), 4
    rows = {"A": [], "A2": [], "B": []}
    turns = {"A": [], "A2": [], "B": []}
    per_round = []
    rungs = set()
    profiler.reset_dispatch_counters()
    for _ in range(rounds):
        this = {"A": [], "A2": [], "B": []}
        for mode in ("A", "B", "A2", "A2", "B", "A"):
            if mode == "B":
                rt.execute = lambda site, thunk, **kw: thunk()
            eng.reset_stats()
            try:
                resps, dt = serve(eng)
            finally:
                rt.execute = real_execute
            check([r.tokens for r in resps] == clean, f"clean mix ({mode}): tokens differ")
            turns[mode].append(sum(len(r.tokens) for r in resps) / dt)
            this[mode] += [t for t in eng.step_timings() if t.kind == "decode"]
            rungs.update(t.rung for t in eng.step_timings())
        per_round.append({m: {f: statistics.median(getattr(t, f) for t in r) for f in fields}
                          for m, r in this.items()})
        for m, r in this.items():
            rows[m] += r
    c = profiler.dispatch_counters()
    check(rungs == {"captured"} and c["serve_capture_builds"] == c["serve_capture_fallbacks"]
          == c["fault_events"] == 0
          and c["serve_capture_replays"] == c["serve_decode_steps"] + c["serve_prefills"],
          f"the clean mix after 5c left the fast path: rungs {rungs}, counters {dict(c)}")
    med = {m: {f: statistics.median(getattr(t, f) for t in r) for f in fields}
           for m, r in rows.items()}
    gap = {f: {f"{a}-{b}": statistics.median(r[a][f] - r[b][f] for r in per_round)
               for a, b in (("A", "B"), ("A2", "B"), ("A", "A2"))} for f in fields}
    after = statistics.median(turns["A"] + turns["A2"])
    out["fast_path"] = {"per_call_ns": calls, "per_call_us": call_us,
                        "decode_steps_per_mode": len(rows["B"]), "step_medians_ms": med,
                        "round_medians_ms": per_round,
                        "step_gaps_ms": gap, "turns_tokens_per_s": turns,
                        "clean_mix_after_tokens_per_s": after, "clean_mix_5b_tokens_per_s": clean_tps}
    print(f"  [fast path] per call: execute {min(calls['execute']):.1f} ns, the direct call "
          f"{min(calls['direct']):.1f} ns ({call_us:.3f} us more, bound {FAST_PATH_CALL_US} us)")
    print(f"    per decode step, {len(rows['B'])} steps each, medians in ms: "
          + "; ".join(f"{m} launch {v['launch_ms']:.4f} device {v['device_ms']:.4f}"
                      for m, v in med.items())
          + f"; gaps, median of {rounds} rounds: "
          + "; ".join(f"{f} " + " ".join(f"{k} {v:+.4f}" for k, v in g.items())
                      for f, g in gap.items())
          + f" (bound {FAST_PATH_STEP_MS} ms)")
    print("    tokens/s by turn: " + "; ".join(
        f"{m} " + " ".join(f"{v:.1f}" for v in t) for m, t in turns.items())
          + f"; the clean mix after 5c {after:.1f} against {clean_tps:.1f} in 5b (host clock, "
            f"not gated: PERF.md)")
    check(call_us <= FAST_PATH_CALL_US,
          f"execute's fast path costs {call_us:.3f} us a call, more than {FAST_PATH_CALL_US} us")
    for f, g in gap.items():
        check(abs(g["A-B"]) <= FAST_PATH_STEP_MS and abs(g["A2-B"]) <= FAST_PATH_STEP_MS,
              f"execute's fast path moves the decode step's median {f} by {g}, more than "
              f"{FAST_PATH_STEP_MS} ms")

    # a torch.profiler trace of one decode tick: one graph replay per
    # context group (4, 6 and 10 blocks); last, after every timed window
    for p in prompts:
        eng.submit(p, max_new_tokens=n_new)
    eng.step()  # admit, prefill, the first decode of each group
    before = profiler.dispatch_counters()["serve_decode_steps"]
    traced = device_trace(torch, eng.step)
    steps = profiler.dispatch_counters()["serve_decode_steps"] - before
    kinds = print_trace(f" in one decode tick ({steps} graph replays)", *traced)
    eng.run_until_idle()
    n_ops, window, busy, wall_ms, _ = traced
    out["decode_tick_trace"] = {
        "graph_replays": steps, "device_ops": n_ops, "device_ms": window / 1e3,
        "device_idle_share": 1 - busy / window, "host_ms": wall_ms,
        "kinds_ms_count": {k: list(v) for k, v in kinds.items()}}
    eng.close()
    pt.set_flags({"FLAGS_serving_capture_cache_size": 16})
    resilience.reset()

    launches = flash_counts(fa)  # 5c's count ends here
    launches.update({k: n.launches for k, n in fu.KERNELS.items()})
    check(not any(launches.values()), f"5c launched a hand-written kernel: {launches}")
    print("serving under faults: " + json.dumps(out, default=str))


def train_345m(torch, pt, fa, gen, dev):
    """Phase 7: the 345M training step as one CUDA graph, against an eager
    copy. Returns the launches of each flash kernel over the training path,
    its numbers, and what phase 8 traces (the step stays alive for it)."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    print("[7] GPT-2 345M training step, 8 x 1024 tokens, AMP O2 bf16, AdamW, one CUDA graph")
    batch, warmup, replays = 8, pt.jit.WARMUP_STEPS, 10
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    pt.seed(SEED)
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    model = GPTForPretraining(cfg, device=dev)
    eager = copy.deepcopy(model)  # before decorate: the wrapped forward is per model
    model = pt.amp.decorate(model, level="O2", dtype="bfloat16")
    eager = pt.amp.decorate(eager, level="O2", dtype="bfloat16")
    criterion = GPTPretrainingCriterion(cfg)

    def loss_fn(logits, labels):
        return criterion(logits.float(), labels)

    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                             weight_decay=0.01)
    step = pt.jit.compile_train_step(model, loss_fn, opt)
    ids = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1), generator=gen,
                        device=dev)
    x, y = ids[:, :-1], ids[:, 1:]
    # every flash launch of the bf16 step is on the sm90 route
    want = dict.fromkeys(flash_counts(fa), 0)
    want.update(fwd_sm90=cfg.num_layers, dkv_sm90=cfg.num_layers, dq_sm90=cfg.num_layers)
    reset_flash_counts(fa)  # the training path's count starts here
    losses = []
    t0 = time.perf_counter()
    for i in range(warmup):
        before = flash_counts(fa)
        losses.append(step(x, y))
        got = {n: c - before[n] for n, c in flash_counts(fa).items()}
        print(f"  eager warm-up step {i}: flash launches {got}")
        check(got == want, f"eager step {i}: flash launches {got}, expected {want}")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    before = flash_counts(fa)
    t0 = time.perf_counter()
    losses.append(step(x, y))  # capture, then the first replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    in_capture = {n: c - before[n] for n, c in flash_counts(fa).items()}
    print(f"  {warmup} eager warm-up steps {warm_s:.2f} s; capture + first replay "
          f"{capture_s:.2f} s; flash launches in the captured step: {in_capture}")
    check(in_capture == want,
          f"flash launches in the captured step {in_capture}, expected {want}")
    before = flash_counts(fa)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(replays):
        losses.append(step(x, y))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / replays
    step_ms = start.elapsed_time(end) / replays
    launches = flash_counts(fa)  # the training path's count ends here
    # replays that went through the Python wrappers would have counted
    check(launches == before, "the replays did not run the captured graph")
    tokens = batch * cfg.max_seq_len
    mem_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"  {replays} replays: step {step_ms:.2f} ms (CUDA events), {host_ms:.2f} ms "
          f"(host clock), {tokens / step_ms * 1e3:.0f} tokens/s; peak memory "
          f"allocated {mem_gb:.1f} GB ({held_gb:.1f} GB held before the phase)")
    values = [float(v) for v in losses]
    print("  losses: " + " ".join(f"{v:.4f}" for v in values))
    check(all(math.isfinite(v) for v in values), "non-finite training loss")
    check(values[-1] < values[0], "the loss does not fall on a fixed batch")
    check(opt._step_count == len(values), "the optimizer's step count is off")

    opt_e = pt.optimizer.AdamW(learning_rate=1e-4, parameters=eager.parameters(),
                               weight_decay=0.01)
    eager_values = []
    for i in range(len(values)):
        if i == len(values) - replays:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        loss = loss_fn(eager(x), y)
        loss.backward()
        opt_e.step()
        opt_e.clear_grad()
        eager_values.append(loss.detach())
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / replays
    eager_values = [float(v) for v in eager_values]
    print(f"  eager steps (the last {replays}): {eager_ms:.2f} ms per step (host clock), "
          f"{tokens / eager_ms * 1e3:.0f} tokens/s")
    diff = max(abs(a - c) for a, c in zip(values, eager_values))
    print(f"  eager copy (loss.backward(); opt.step(); opt.clear_grad()) vs graph: "
          f"max|d loss|={diff:.3e} over {len(values)} steps, bitwise equal: "
          f"{values == eager_values}, tol={TOL_EAGER_VS_GRAPH:g}")
    check(diff <= TOL_EAGER_VS_GRAPH, "the eager copy and the graph replays disagree")
    del eager, opt_e, loss
    return {"launches": launches, "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_gb": mem_gb - held_gb, "profile": (step, x, y, cfg.num_layers)}


# Phase 7b. 7b-i: bench.py main()'s step with BENCH_RECOMPUTE=1 and GPTConfig's
# hidden-state dropout; 7b-ii: the classic fp16 loop under O1 with a
# GradScaler; 7b-iii: a compiled step that returns its input's gradient.
RECOMPUTE_DROPOUT = 0.1
O1_STEPS = 6  # steps of the O1 loop: 2 good, 2 poisoned, 1 good, 1 rescued
O1_POISONED = (2, 3)  # an inf in one gradient: the scaler skips the step
O1_RESCUED = 5  # an inf under FLAGS_numeric_rescue="skip": the sentinel skips it
O1_TIMED = 3  # good steps timed after the checked ones
# The input gradient of a compiled step against eager autograd's, relative to
# the gradient's largest entry: the same kernels in the same order, expected
# equal to the bit; 1e-6 admits a library matmul choosing another algorithm in
# the graph, and a wrong gradient (a mask, a missing term) moves whole rows
TOL_INPUT_GRAD = 1e-6


def draw_from_pairs(pt, layers, gen, pairs):
    """Make each of ``layers`` draw its random bits from its segment pair's
    forward generator, as a captured recompute step's forwards do."""
    for layer, (fwd, _) in zip(layers, pairs):
        def forward(*args, _forward=layer.forward, _fwd=fwd, **kwargs):
            with pt.core.random.drawing_from(gen, _fwd):
                return _forward(*args, **kwargs)

        layer.forward = forward


def captured_mask_replay(torch, pt, gen, dev):
    """7b-i: a replay of a captured recompute step recomputes each layer with
    the masks its forward drew. GPT-2 345M's width cut to 2 layers, f32, SGD:
    the replay's loss and updated parameters against an eager step without
    recompute whose layers draw from the same generator states (each
    segment pair's forward half, the port generator for the embedding)."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    pt.seed(SEED)
    cfg = dataclasses.replace(gpt2_345m(dropout=RECOMPUTE_DROPOUT, attn_dropout=0.0,
                                        use_recompute=True), num_layers=2)
    model = GPTForPretraining(cfg, device=dev)
    eager = copy.deepcopy(model)
    eager.cfg.use_recompute = False  # the copy's layers share its config
    crit = GPTPretrainingCriterion(cfg)
    opt = pt.optimizer.SGD(learning_rate=1e-2, parameters=model.parameters())
    opt_e = pt.optimizer.SGD(learning_rate=1e-2, parameters=eager.parameters())
    step = pt.jit.compile_train_step(model, lambda lo, lb: crit(lo, lb), opt)
    ids = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len + 1), generator=gen, device=dev)
    x, y = ids[:, :-1], ids[:, 1:]
    for _ in range(pt.jit.WARMUP_STEPS + 1):
        step(x, y)
    (entry,) = step._captured.values()
    with torch.no_grad():
        for p, q in zip(eager.parameters(), model.parameters()):
            p.copy_(q)
    state = pt.get_rng_state()
    before = [p.detach().clone() for p in model.parameters()]
    loss = step(x, y).item()
    # the same random state, and the pairs seeded from it as the replay seeded them
    pt.set_rng_state(state)
    entry.pairs.reseed()
    draw_from_pairs(pt, eager.gpt.layers, pt.core.random.generator(dev), entry.pairs)
    ref = crit(eager(x), y)
    ref.backward()
    opt_e.step()
    err = max((p - q).abs().max().item() for p, q in zip(model.parameters(),
                                                          eager.parameters()))
    moved = max((p - q).abs().max().item() for p, q in zip(model.parameters(), before))
    print(f"  captured recompute (2 layers at full width, f32, SGD): replay loss {loss:.6f}, "
          f"eager without recompute drawing from the segment pairs {ref.item():.6f}; "
          f"updated parameters max|d|={err:.3e}, the update moved them up to {moved:.3e} "
          f"({entry.segments} segments, "
          f"{len(entry.pairs)} pairs registered)")
    check(entry.segments == cfg.num_layers and len(entry.pairs) == cfg.num_layers,
          "the capture did not register one generator pair per recompute segment")
    # the same kernels on the same data: equal but for a library matmul
    # choosing another algorithm in the graph; a wrong mask moves whole
    # gradient rows, a good part of what the update moves
    check(abs(loss - ref.item()) <= 1e-5 and err <= 1e-2 * moved,
          "a captured recompute did not replay its forward's masks")
    # paddle.set_rng_state covers the segments' masks: at lr 0 a replay, the
    # state restored, and a replay again give one loss; the next, another
    opt.set_lr(0.0)
    state = pt.get_rng_state()
    first = step(x, y).item()
    pt.set_rng_state(state)
    again, other = step(x, y).item(), step(x, y).item()
    print(f"  lr 0: a replay {first:.6f}, after set_rng_state {again:.6f}, the next {other:.6f}")
    check(first == again and again != other,
          "set_rng_state did not bring back a captured recompute step's masks")


def recompute_step_345m(torch, pt, fa, gen, dev, phase7):
    """Phase 7b-i: the compiled O2 bf16 AdamW step with recompute and
    dropout 0.1, beside phase 7's step. Returns its flash launches and
    numbers."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    print(f"[7b-i] GPT-2 345M training step with recompute, 8 x 1024 tokens, AMP O2 bf16, "
          f"AdamW, dropout {RECOMPUTE_DROPOUT}, attn_dropout 0, one CUDA graph")
    batch, warmup, replays = 8, pt.jit.WARMUP_STEPS, 10
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9  # phase 7's step, kept for phase 8
    pt.seed(SEED)
    cfg = gpt2_345m(dropout=RECOMPUTE_DROPOUT, attn_dropout=0.0, use_recompute=True)
    n = cfg.num_layers
    model = GPTForPretraining(cfg, device=dev)
    # the initial weights, on the host, for the mask-replay check's two copies
    initial = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    model = pt.amp.decorate(model, level="O2", dtype="bfloat16")
    criterion = GPTPretrainingCriterion(cfg)

    def loss_fn(logits, labels):
        return criterion(logits.float(), labels)

    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                             weight_decay=0.01)
    step = pt.jit.compile_train_step(model, loss_fn, opt)
    ids = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1), generator=gen,
                        device=dev)
    x, y = ids[:, :-1], ids[:, 1:]
    # per step: the forward twice per layer (the recomputation), the pair once
    want = dict.fromkeys(flash_counts(fa), 0)
    want.update(fwd_sm90=2 * n, dkv_sm90=n, dq_sm90=n)
    reset_flash_counts(fa)  # the recompute path's count starts here
    losses = []
    for i in range(warmup + 1):
        before = flash_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(x, y))
        torch.cuda.synchronize()
        got = {k: c - before[k] for k, c in flash_counts(fa).items()}
        what = "capture + first replay" if i == warmup else f"eager warm-up step {i}"
        print(f"  {what}: {time.perf_counter() - t0:.2f} s, flash launches {got}")
        check(got == want, f"{what}: flash launches {got}, expected {want}")
    (entry,) = step._captured.values()
    check(entry.graph is not None and entry.segments == n,
          f"the capture counted {entry.segments} recompute segments, not {n}")
    launches = flash_counts(fa)  # ... and ends here: replays launch through no wrapper
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(replays):
        losses.append(step(x, y))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / replays
    step_ms = start.elapsed_time(end) / replays
    check(flash_counts(fa) == launches, "the replays did not run the captured graph")
    tokens = batch * cfg.max_seq_len
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 - held_gb
    values = [float(v) for v in losses]
    print(f"  {replays} replays: step {step_ms:.2f} ms (CUDA events), {host_ms:.2f} ms (host "
          f"clock), {tokens / step_ms * 1e3:.0f} tokens/s; peak memory allocated "
          f"{peak_gb:.1f} GB above the {held_gb:.1f} GB held before the phase")
    print(f"  beside phase 7 (no recompute, dropout 0): step {phase7['step_ms']:.2f} ms, "
          f"{phase7['tokens_per_s']:.0f} tokens/s, peak {phase7['peak_gb']:.1f} GB above what "
          f"it held; recompute {step_ms / phase7['step_ms']:.3f}x the step, "
          f"{peak_gb / phase7['peak_gb']:.3f}x the memory")
    print("  losses: " + " ".join(f"{v:.4f}" for v in values))
    check(all(math.isfinite(v) for v in values), "non-finite training loss")
    check(values[-1] < values[0], "the loss does not fall on a fixed batch")
    # lr 0: the parameters stay, so only the masks move the loss
    opt.set_lr(0.0)
    a, b = float(step(x, y)), float(step(x, y))
    print(f"  two replays at lr 0, dropout {RECOMPUTE_DROPOUT}: {a:.6f} {b:.6f}")
    check(a != b, "two replays drew the same dropout masks")
    del step, model, opt, entry
    torch.cuda.empty_cache()

    # the same at dropout 0 and 4 layers: the replays are equal
    pt.seed(SEED)
    cfg0 = dataclasses.replace(gpt2_345m(dropout=0.0, attn_dropout=0.0, use_recompute=True),
                               num_layers=4)
    small = pt.amp.decorate(GPTForPretraining(cfg0, device=dev), level="O2", dtype="bfloat16")
    opt0 = pt.optimizer.AdamW(learning_rate=0.0, parameters=small.parameters())
    step0 = pt.jit.compile_train_step(small, loss_fn, opt0)
    zero = [float(step0(x, y)) for _ in range(warmup + 3)][warmup:]
    print(f"  replays at lr 0, dropout 0, {cfg0.num_layers} layers: "
          + " ".join(f"{v:.6f}" for v in zero))
    check(len(set(zero)) == 1, "replays at dropout 0 differ")
    del step0, small, opt0
    torch.cuda.empty_cache()

    captured_mask_replay(torch, pt, gen, dev)

    # the mask replay, eager: with recompute and without, one seed per step
    rec, plain = (GPTForPretraining(gpt2_345m(dropout=RECOMPUTE_DROPOUT, attn_dropout=0.0,
                                              use_recompute=flag), device=dev)
                  for flag in (True, False))
    for m in (rec, plain):
        m.load_state_dict(initial)
    rec, plain = (pt.amp.decorate(m, level="O2", dtype="bfloat16") for m in (rec, plain))
    opts = [pt.optimizer.AdamW(learning_rate=1e-4, parameters=m.parameters(),
                               weight_decay=0.01) for m in (rec, plain)]
    for i in range(3):
        got = []
        for m, o in zip((rec, plain), opts):
            pt.seed(SEED + 10 + i)
            loss = loss_fn(m(x), y)
            loss.backward()
            got.append((loss.detach(), [p.grad.clone() for p in m.parameters()]))
            o.step()
            o.clear_grad()
        same = torch.equal(got[0][0], got[1][0]) and all(
            torch.equal(g, h) for g, h in zip(got[0][1], got[1][1]))
        print(f"  eager step {i}, recompute against none: loss {float(got[0][0]):.6f} "
              f"{float(got[1][0]):.6f}, loss and {len(got[0][1])} gradients bitwise equal: "
              f"{same}")
        check(same, "recompute did not replay the forward's masks")
    del rec, plain, opts, got
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_gb": peak_gb}


def o1_fp16_scaler_345m(torch, pt, fa, fu, gen, dev):
    """Phase 7b-ii: the eager O1 fp16 loop with a GradScaler and Adam, the
    fused update on against a deep copy with it off. Returns its flash and
    Adam launches and its step times."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    print(f"[7b-ii] GPT-2 345M eager AMP O1 fp16, GradScaler, Adam, dropout "
          f"{RECOMPUTE_DROPOUT}, attn_dropout 0, 8 x 1024 tokens, the fused update on and off")
    pt.seed(SEED)
    cfg = gpt2_345m(dropout=RECOMPUTE_DROPOUT, attn_dropout=0.0)
    n = cfg.num_layers
    model = GPTForPretraining(cfg, device=dev)
    ref = copy.deepcopy(model)
    criterion = GPTPretrainingCriterion(cfg)
    ids = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len + 1), generator=gen, device=dev)
    x, y = ids[:, :-1], ids[:, 1:]
    n_params = len(list(model.parameters()))
    per_step = dict.fromkeys(flash_counts(fa), 0)
    per_step.update(fwd_sm90=n, dkv_sm90=n, dq_sm90=n)
    reset_flash_counts(fa)  # the O1 path's count starts here
    adam_before = fu.fused_adam.launches
    runs = {}
    for name, m, flag in (("on", model, True), ("off", ref, False)):
        opt = pt.optimizer.Adam(learning_rate=1e-4, parameters=m.parameters())
        scaler = pt.amp.GradScaler()
        params = list(m.parameters())
        pt.set_flags({"FLAGS_pallas_fused_update": flag})
        pt.resilience.rescue.reset_counters()
        record = {"losses": [], "states": [], "ms": [], "opt_ms": [], "unscale_ms": []}
        try:
            for i in range(O1_STEPS + O1_TIMED):
                bad = i in O1_POISONED or i == O1_RESCUED
                if i == O1_RESCUED:
                    pt.set_flags({"FLAGS_numeric_rescue": "skip"})
                before = flash_counts(fa)
                adam = fu.fused_adam.launches
                kept = bad and ([p.detach().clone() for p in params],
                                [v.clone() for p in params
                                 for v in opt._accumulators.get(id(p), {}).values()])
                pt.seed(SEED + 100 + i)  # both runs draw the same masks
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with pt.amp.auto_cast(level="O1", dtype="float16"):
                    loss = criterion(m(x), y)
                if not bad and i < O1_STEPS:
                    scaler.minimize(opt, scaler.scale(loss))
                else:
                    scaler.scale(loss).backward()
                    if bad:
                        params[0].grad.view(-1)[0] = float("inf")
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    scaler.unscale_(opt)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    scaler.step(opt)
                    torch.cuda.synchronize()
                    t3 = time.perf_counter()
                    scaler.update()
                    if i >= O1_STEPS:
                        record["unscale_ms"].append((t2 - t1) * 1e3)
                        record["opt_ms"].append((t3 - t2) * 1e3)
                opt.clear_grad()
                torch.cuda.synchronize()
                if i >= O1_STEPS:
                    record["ms"].append((time.perf_counter() - t0) * 1e3)
                if i == O1_RESCUED:
                    pt.set_flags({"FLAGS_numeric_rescue": ""})
                got = {k: c - before[k] for k, c in flash_counts(fa).items()}
                adam = fu.fused_adam.launches - adam
                check(got == per_step, f"O1 step {i} ({name}): flash launches {got}, "
                                       f"expected {per_step}")
                stepped = i not in O1_POISONED  # the rescued step launches, gated
                check(adam == (n_params if flag and stepped else 0),
                      f"O1 step {i} ({name}): {adam} Adam kernel launches")
                if bad:
                    same = all(torch.equal(a, b) for a, b in zip(kept[0], params)) and all(
                        torch.equal(a, b) for a, b in zip(kept[1], [
                            v for p in params for v in opt._accumulators[id(p)].values()]))
                    check(same, f"O1 step {i} ({name}) was not skipped")
                record["losses"].append(loss.detach())
                record["states"].append(scaler.state_dict())
            check(pt.resilience.rescue.counters["numeric_rescues"] == 1,
                  "the rescued step was not counted")
        finally:
            pt.set_flags({"FLAGS_pallas_fused_update": False, "FLAGS_numeric_rescue": ""})
        record["opt"] = opt
        runs[name] = record
    on, off = runs["on"], runs["off"]
    scale0 = on["states"][0]["scale"]
    print("  scaler state after each step: " + "; ".join(
        f"{i}: scale {s['scale']:g} good {s['good_steps']} bad {s['bad_steps']}"
        for i, s in enumerate(on["states"][:O1_STEPS])))
    # 2 good, the first poisoned step counts bad and resets good, the second
    # reaches decr_every_n_nan_or_inf (2) and halves the scale; the rescued
    # step is marked by the sentinel as the scaler's own check would
    want = [(scale0, 1, 0), (scale0, 2, 0), (scale0, 0, 1), (scale0 / 2, 0, 0),
            (scale0 / 2, 1, 0), (scale0 / 2, 0, 1)]
    got = [(s["scale"], s["good_steps"], s["bad_steps"]) for s in on["states"][:O1_STEPS]]
    check(got == want, f"scaler states {got}, expected {want}")
    same = (all(torch.equal(a, b) for a, b in zip(on["losses"], off["losses"]))
            and on["states"] == off["states"]
            and bitwise_same(torch, model, ref, on["opt"], off["opt"]))
    values = [float(v) for v in on["losses"]]
    print("  losses: " + " ".join(f"{v:.4f}" for v in values))
    print(f"  flag on vs off: losses, parameters, moments and scaler state bitwise equal: "
          f"{same}")
    check(same, "the fused update on and off disagree under O1")
    check(all(math.isfinite(v) for v in values), "non-finite O1 loss")
    adam_launches = fu.fused_adam.launches - adam_before
    launches = flash_counts(fa)  # the O1 path's count ends here
    times = {k: statistics.median(runs[f][k]) for f in ("on",) for k in
             ("ms", "unscale_ms", "opt_ms")}
    off_times = {k: statistics.median(off[k]) for k in ("ms", "unscale_ms", "opt_ms")}
    print(f"  a good step (median of {O1_TIMED}, host clock): flag on {times['ms']:.2f} ms, "
          f"of which unscale_ {times['unscale_ms']:.2f} ms and opt.step() "
          f"{times['opt_ms']:.2f} ms; flag off {off_times['ms']:.2f} ms, unscale_ "
          f"{off_times['unscale_ms']:.2f} ms, opt.step() {off_times['opt_ms']:.2f} ms; "
          f"{8 * cfg.max_seq_len / times['ms'] * 1e3:.0f} tokens/s")
    print(f"  per step: {n} fp16 sm90 launches each of forward, dK/dV and dQ; "
          f"{n_params} Adam kernel launches (the flag on, f32 parameters)")
    del model, ref, runs, on, off
    torch.cuda.empty_cache()
    return {"launches": launches, "adam": adam_launches, "times": times, "off_times": off_times}


def grad_input_step(torch, pt, fa, gen, dev):
    """Phase 7b-iii: ``compile_train_step(grad_input_idx=(0,))`` over float
    rows, as the parameter-server path feeds pulled embedding rows: GPT-2
    345M's width, 2 decoder layers and a head, f32, AdamW; the input
    gradient of 3 replays against eager autograd's on a copy stepped beside
    it."""
    from paddle_tpu_torch.models.gpt import GPTDecoderLayer, GPTPretrainingCriterion, gpt2_345m

    print("[7b-iii] compile_train_step(grad_input_idx=(0,)): 8 x 1024 float rows in, their "
          "gradient out, 2 layers at GPT-2 345M's width, f32, AdamW")
    cfg = dataclasses.replace(gpt2_345m(dropout=0.0, attn_dropout=0.0), num_layers=2)

    class Rows(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = pt.nn.LayerList([GPTDecoderLayer(cfg, device=dev)
                                           for _ in range(cfg.num_layers)])
            self.final_ln = pt.nn.LayerNorm(cfg.hidden_size, device=dev)
            self.head = pt.nn.Linear(cfg.hidden_size, cfg.vocab_size, device=dev)

        def forward(self, rows):
            for layer in self.layers:
                rows = layer(rows)
            return self.head(self.final_ln(rows))

    pt.seed(SEED)
    model = Rows()
    eager = copy.deepcopy(model)
    crit = GPTPretrainingCriterion(cfg)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())
    opt_e = pt.optimizer.AdamW(learning_rate=1e-4, parameters=eager.parameters())
    step = pt.jit.compile_train_step(model, lambda lo, lb: crit(lo, lb), opt,
                                     grad_input_idx=(0,))
    rows = torch.randn(8, cfg.max_seq_len, cfg.hidden_size, generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len), generator=gen, device=dev)
    errs = []
    for i in range(pt.jit.WARMUP_STEPS + 1 + 3):
        loss, (g,) = step(rows, labels)
        x = rows.clone().requires_grad_()
        ref = crit(eager(x), labels)
        ref.backward()
        opt_e.step()
        opt_e.clear_grad()
        if i > pt.jit.WARMUP_STEPS:  # the replays after the capture
            size = x.grad.abs().max().item()
            errs.append(((g - x.grad).abs().max().item(), size,
                         abs(loss.item() - ref.item())))
            check(g.dtype == rows.dtype and g.shape == rows.shape, "input gradient's dtype "
                                                                   "or shape")
    (entry,) = step._captured.values()
    check(entry.graph is not None, "the grad_input_idx step was not captured")
    print("  replays: " + "; ".join(f"max|d grad|={e:.3e} (largest {s:.3e}), |d loss|={d:.3e}"
                                    for e, s, d in errs))
    check(all(e <= TOL_INPUT_GRAD * s and d <= 1e-5 for e, s, d in errs),
          "the compiled step's input gradient disagrees with eager autograd's")
    del step, model, eager, opt, opt_e
    torch.cuda.empty_cache()


# Phase 7c: checkpoint and resume of phase 7's step (the 345M, 8 x 1024, O2
# bf16, AdamW, compile_train_step, dropout 0), each run in a process of its
# own that imports only torch and the port. Run B is one training run of
# RESUME_STEPS steps saved every RESUME_SAVE_FREQ steps to one directory
# (max_to_keep=2) through train_step_range, cut four times:
#   sigkill  from step 0, SIGKILLs itself after step RESUME_KILLED_AFTER once
#            step 3's snapshot is committed: step 4 is lost;
#   sigterm  resumes at 4 under a PreemptionGuard, sends itself SIGTERM during
#            step RESUME_SIGTERM_AT: the step finishes, is emergency-saved, and
#            the process exits with Preempted (143): no step is lost;
#   fault    resumes at 7, arms FLAGS_fault_inject="kill:checkpoint" in step
#            RESUME_FAULT_AT: the persist of its snapshot dies (137) between
#            the payload write and the rename, LATEST still names 7;
#   resume   resumes at 8 and runs to the end, then loads snapshot
#            RESUME_LOADED into its captured step in place and replays step
#            RESUME_LOADED + 1, then times a blocking save.
# The yardsticks, in one process: A runs every step with one compiled step
# (two eager steps, then the graph); A' builds a fresh compiled step where
# each process of run B starts (RESUME_STARTS), so its steps are eager or
# replayed as B's are. A fresh process's first two steps are eager where A
# replays: if eager and replayed steps differ in the last bit, A' is the
# yardstick (a finding, printed either way).
RESUME_STEPS = 12
RESUME_SAVE_FREQ = 2
RESUME_KILLED_AFTER = 4
RESUME_SIGTERM_AT = 6
RESUME_FAULT_AT = 9
RESUME_STARTS = (0, 4, 7, 8)
RESUME_LOADED = 9
RESUME_CHILD_TIMEOUT_S = 240
RESUME_DISK_GB = 8  # two snapshots of ~2.1 GB, a temporary one and the blocking save's


def resume_setup(torch, pt, dev):
    """Phase 7's model, optimizer and loss, from the seed."""
    from paddle_tpu_torch.models.gpt import (
        GPTForPretraining, GPTPretrainingCriterion, gpt2_345m)

    pt.seed(SEED)
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    model = pt.amp.decorate(GPTForPretraining(cfg, device=dev), level="O2", dtype="bfloat16")
    criterion = GPTPretrainingCriterion(cfg)

    def loss_fn(logits, labels):
        return criterion(logits.float(), labels)

    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                             weight_decay=0.01)
    return cfg, model, opt, loss_fn


def resume_batch(torch, cfg, i, dev):
    """Step i's batch, the same in every process: 8 x 1024 ids from its seed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1000 + i)
    ids = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len + 1), generator=gen, device=dev)
    return ids[:, :-1], ids[:, 1:]


def resume_child(mode: str, directory: str) -> int:
    """One process of phase 7c (``chip_smoke.py --resume-child MODE DIR``).
    Prints one ``TAG {json}`` line per record, flushed, so a killed process
    leaves what it did."""
    import signal

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import checkpoint as dc
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def out(tag, **kw):
        print(tag, json.dumps(kw), flush=True)

    def run_step(step, run, i):
        x, y = resume_batch(torch, cfg, i, dev)
        before = flash_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(x, y).item()
        ms = (time.perf_counter() - t0) * 1e3
        flash = {n: c - before[n] for n, c in flash_counts(fa).items() if c != before[n]}
        out("STEP", run=run, i=i, loss=loss, ms=ms, flash=flash)

    cfg, model, opt, loss_fn = resume_setup(torch, pt, dev)
    if mode == "yardstick":
        for run, starts in (("A", (0,)), ("A'", RESUME_STARTS)):
            if run == "A'":
                del step, model, opt
                torch.cuda.empty_cache()
                cfg, model, opt, loss_fn = resume_setup(torch, pt, dev)
            for i in range(RESUME_STEPS):
                if i in starts:
                    step = pt.jit.compile_train_step(model, loss_fn, opt)
                run_step(step, run, i)
        return 0

    ck = dc.AsyncCheckpointer(directory, max_to_keep=2)
    state = dc.training_state(model, opt)
    guard = pt.resilience.PreemptionGuard() if mode == "sigterm" else None
    step = pt.jit.compile_train_step(model, loss_fn, opt)
    pt.profiler.reset_dispatch_counters()
    first = True

    def events():
        for ev in pt.profiler.trace.events(kind="ckpt"):
            out("CKPT", **ev.as_dict())

    try:
        for i in dc.train_step_range(RESUME_STEPS, ck, state, save_freq=RESUME_SAVE_FREQ,
                                     guard=guard):
            if first:
                out("START", i=i, latest=ck._read_latest())
                first = False
            if mode == "sigterm" and i == RESUME_SIGTERM_AT:
                os.kill(os.getpid(), signal.SIGTERM)  # the guard's handler sets its flag
            run_step(step, mode, i)
            if mode == "fault" and i == RESUME_FAULT_AT:
                pt.set_flags({"FLAGS_fault_inject": "kill:checkpoint"})
            if mode == "sigkill" and i == RESUME_KILLED_AFTER:
                t0 = time.perf_counter()
                while (ck._read_latest() != RESUME_KILLED_AFTER - 1
                       and time.perf_counter() - t0 < 60):
                    time.sleep(0.01)
                events()
                out("KILL", latest=ck._read_latest())
                os.kill(os.getpid(), signal.SIGKILL)
    finally:
        if mode != "sigkill":
            events()
    if mode != "resume":
        out("UNREACHABLE")
        return 1
    counters = pt.profiler.dispatch_counters()
    out("COUNTERS", **{k: v for k, v in counters.items() if k.startswith("ckpt_")})
    # the captured step reads the storage it was captured over: a load must
    # copy into it. Load snapshot RESUME_LOADED, then replay the next step
    live = dc.training_state(model, opt)
    ptrs = {k: v.data_ptr() for k, v in live.items() if isinstance(v, torch.Tensor)}
    loaded = dc.load_state_dict(dc.training_state(model, opt),
                                os.path.join(directory, str(RESUME_LOADED)))
    dc.restore_training_state(loaded, optimizer=opt)
    live.refresh()
    moved = [k for k, v in live.items()
             if isinstance(v, torch.Tensor) and v.data_ptr() != ptrs.get(k)]
    out("INPLACE", tensors=len(ptrs), moved=moved[:8], n_moved=len(moved),
        same_keys=sorted(ptrs) == sorted(k for k, v in live.items()
                                         if isinstance(v, torch.Tensor)))
    run_step(step, "loaded", RESUME_LOADED + 1)
    # the snapshot's copy alone: queued behind a sleep kernel, its events
    # measure the device, not the host's enqueue (which they take in when
    # the stream is idle, as it is at a step boundary that read the loss)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    snap = dc._device_snapshot(state)
    out("SNAPSHOT_DEVICE", ms=snap.device_ms(), bytes=snap.nbytes)
    del snap
    # a blocking save beside the async ones, to a directory of its own
    pt.profiler.trace.clear()
    blocking = dc.AsyncCheckpointer(directory + "-blocking", max_to_keep=1)
    for n in range(2):  # the first allocates and pins the host buffers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocking.save(n, state, blocking=True)
        out("BLOCKING", n=n, ms=(time.perf_counter() - t0) * 1e3)
    for ev in pt.profiler.trace.events(kind="ckpt"):
        out("CKPT", **ev.as_dict())
    return 0


def resume_child_command(mode, directory):
    return [sys.executable, os.path.abspath(__file__), "--resume-child", mode, directory]


def run_resume_child(mode, directory):
    """Run one process of phase 7c; returns its exit code and records."""
    t0 = time.perf_counter()
    proc = subprocess.run(resume_child_command(mode, directory), capture_output=True,
                          text=True, timeout=RESUME_CHILD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    recs = []
    for line in proc.stdout.splitlines():
        tag, _, rest = line.partition(" ")
        if tag.isupper() and (rest.startswith("{") or not rest):
            recs.append((tag, json.loads(rest) if rest else {}))
    print(f"  {mode}: exit {proc.returncode} in {secs:.1f} s, {len(recs)} records")
    if proc.returncode not in (0, -9, 137, 143) or not recs:
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:])
    return proc.returncode, recs


def steps_of(recs, run=None):
    return {r["i"]: r for tag, r in recs if tag == "STEP" and (run is None or r["run"] == run)}


def ckpt_events(recs):
    return [r for tag, r in recs if tag == "CKPT"]


def print_ckpt_events(mode, recs):
    for ev in ckpt_events(recs):
        a = ev.get("attrs") or {}
        extra = "".join(f" {k}={v}" for k, v in a.items() if k not in ("phase", "ms"))
        print(f"    {mode} ckpt step {ev['step']}: {a.get('phase')} {a.get('ms')} ms{extra}")


def checkpoint_resume_345m(torch, card):
    """Phase 7c. Returns the flash launches of its processes (all sm90)."""
    import shutil
    import tempfile

    from paddle_tpu_torch.models.gpt import gpt2_345m

    layers = gpt2_345m().num_layers

    print("[7c] checkpoint and resume of the 345M O2 step (8 x 1024, AdamW, one CUDA "
          f"graph): {RESUME_STEPS} steps, save_freq={RESUME_SAVE_FREQ}, max_to_keep=2, "
          "each run in a process of its own")
    print(f"  {card}")
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free_gb = shutil.disk_usage(directory).free / 1e9
    print(f"  checkpoint directory {directory}: {free_gb:.1f} GB free")
    check(free_gb >= RESUME_DISK_GB, f"{free_gb:.1f} GB free, phase 7c needs {RESUME_DISK_GB}")
    t_phase = time.perf_counter()
    try:
        runs = {}
        for mode in ("yardstick", "sigkill", "sigterm", "fault", "resume"):
            runs[mode] = run_resume_child(mode, os.path.join(directory, "run"))
            print_ckpt_events(mode, runs[mode][1])
            if mode in ("sigkill", "sigterm", "fault"):
                with open(os.path.join(directory, "run", "LATEST")) as f:
                    latest = int(f.read())
                files = sorted(d for d in os.listdir(os.path.join(directory, "run")))
                print(f"    after {mode}: LATEST={latest}, files {files}")
                runs[mode] = runs[mode] + (latest, files)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase

    rc, recs = runs["yardstick"]
    check(rc == 0, f"the yardstick process exited {rc}")
    a, a2 = steps_of(recs, "A"), steps_of(recs, "A'")
    check(sorted(a) == sorted(a2) == list(range(RESUME_STEPS)), "the yardsticks' steps")
    la = [a[i]["loss"] for i in range(RESUME_STEPS)]
    check(all(math.isfinite(v) for v in la), "non-finite loss in run A")
    print("  A:  " + " ".join(f"{v:.6f}" for v in la))
    print("  A': " + " ".join(f"{a2[i]['loss']:.6f}" for i in range(RESUME_STEPS)))
    same = [i for i in range(RESUME_STEPS) if a[i]["loss"] == a2[i]["loss"]]
    print(f"  A vs A' (a fresh compiled step at {list(RESUME_STARTS)}: eager where A "
          f"replays): bitwise equal at steps {same} of {RESUME_STEPS}; max|d loss|="
          f"{max(abs(a[i]['loss'] - a2[i]['loss']) for i in range(RESUME_STEPS)):.3e}; "
          f"eager and replayed steps bitwise equal: {len(same) == RESUME_STEPS}")
    replay_ms = sorted(a[i]["ms"] for i in range(3, RESUME_STEPS))
    step_ms = statistics.median(replay_ms)
    print(f"  A's replayed steps: {step_ms:.2f} ms median (host clock, a loss read per "
          f"step), {replay_ms[0]:.2f}-{replay_ms[-1]:.2f}")

    def yard(i, replayed):
        """The yardstick of step i as a process of run B ran it."""
        return a[i]["loss"] if replayed else a2[i]["loss"]

    def gate(mode, got, kinds):
        rows = []
        for i, replayed in kinds.items():
            check(i in got, f"{mode}: step {i} missing")
            rows.append((i, got[i]["loss"], yard(i, replayed), a[i]["loss"]))
        print(f"  {mode}: " + "; ".join(
            f"step {i} {v:.6f} ({'=' if v == y else '!='} yardstick, "
            f"{'=' if v == va else '!='} A)" for i, v, y, va in rows))
        check(all(v == y for _, v, y, _ in rows),
              f"{mode}: resumed losses differ from the uninterrupted run's")

    per_step = dict.fromkeys(("fwd_sm90", "dkv_sm90", "dq_sm90"), layers)

    def flash_of(recs):
        """The flash launches of a process: each eager or capturing step
        launches every kernel once a layer on the sm90 route, a replay none."""
        total = {}
        for r in steps_of(recs).values():
            check(r["flash"] in ({}, per_step), f"step {r['i']} of {r['run']}: flash "
                                                f"launches {r['flash']}, expected {per_step}")
            for n, c in r["flash"].items():
                total[n] = total.get(n, 0) + c
        return total

    # sigkill: steps 0..4, killed once LATEST names 3
    rc, recs, latest, files = runs["sigkill"]
    got = steps_of(recs, "sigkill")
    kill = [r for tag, r in recs if tag == "KILL"]
    check(rc == -9 and kill and kill[0]["latest"] == RESUME_KILLED_AFTER - 1,
          f"sigkill: exit {rc}, {kill}")
    check(sorted(got) == list(range(RESUME_KILLED_AFTER + 1)), f"sigkill ran {sorted(got)}")
    gate("sigkill", got, {0: False, 1: False, 2: True, 3: True, 4: True})
    lost = [i for i in got if i > latest]
    print(f"  sigkill: SIGKILL after step {RESUME_KILLED_AFTER}, LATEST {latest}: "
          f"steps {lost} lost")
    # sigterm: resumes at LATEST + 1, preempted after step 6 with its emergency save
    rc, recs, latest_t, files = runs["sigterm"]
    got = steps_of(recs, "sigterm")
    start = [r for tag, r in recs if tag == "START"]
    check(start and start[0]["i"] == latest + 1, f"sigterm started at {start}")
    check(rc == 143, f"sigterm: exit {rc}, expected 143 (Preempted)")
    check(sorted(got) == list(range(latest + 1, RESUME_SIGTERM_AT + 1)),
          f"sigterm ran {sorted(got)}")
    check(latest_t == RESUME_SIGTERM_AT, f"sigterm: LATEST {latest_t} after the emergency save")
    gate("sigterm", got, {4: False, 5: False, 6: False})
    print(f"  sigterm: SIGTERM in step {RESUME_SIGTERM_AT}, the step finished, emergency "
          f"save, exit 143; LATEST {latest_t}: 0 steps lost")
    # fault: kill:checkpoint in step 9's commit; LATEST stays 7
    rc, recs, latest_f, files = runs["fault"]
    got = steps_of(recs, "fault")
    start = [r for tag, r in recs if tag == "START"]
    check(start and start[0]["i"] == latest_t + 1, f"fault started at {start}")
    check(rc == 137, f"fault: exit {rc}, expected 137 (kill:checkpoint)")
    check(not any(tag == "UNREACHABLE" for tag, _ in recs), "fault: the process outlived its kill")
    check(latest_f == RESUME_FAULT_AT - 2 and str(RESUME_FAULT_AT) not in files,
          f"fault: LATEST {latest_f}, files {files}")
    gate("fault", got, {7: False, 8: False})
    print(f"  fault: killed in the commit of step {RESUME_FAULT_AT}'s snapshot; LATEST "
          f"{latest_f}, no file {RESUME_FAULT_AT}; ran steps {sorted(got)}")
    # resume: from LATEST + 1 to the end, then the in-place load
    rc, recs = runs["resume"]
    got = steps_of(recs, "resume")
    start = [r for tag, r in recs if tag == "START"]
    check(rc == 0, f"resume: exit {rc}")
    check(start and start[0]["i"] == latest_f + 1, f"resume started at {start}")
    gate("resume", got, {8: False, 9: False, 10: False, 11: False})
    (inplace,) = [r for tag, r in recs if tag == "INPLACE"]
    (loaded,) = steps_of(recs, "loaded").values()
    print(f"  in-place load of snapshot {RESUME_LOADED} into the captured step: "
          f"{inplace['tensors']} parameters and optimizer tensors, {inplace['n_moved']} "
          f"moved; the next replay's loss {loaded['loss']:.6f}, A' step "
          f"{RESUME_LOADED + 1} {a2[RESUME_LOADED + 1]['loss']:.6f}, A "
          f"{a[RESUME_LOADED + 1]['loss']:.6f}")
    check(inplace["n_moved"] == 0 and inplace["same_keys"], f"the load moved {inplace}")
    check(loaded["loss"] == a2[RESUME_LOADED + 1]["loss"],
          "the replay after an in-place load differs from the uninterrupted run")

    # costs, from the resume process: its last async save (host buffers
    # reused) and the blocking saves
    evs = ckpt_events(recs)
    snaps = [e["attrs"] for e in evs if e["attrs"]["phase"] == "snapshot"]
    by_phase = {}
    for e in evs:
        by_phase.setdefault((e["step"], e["attrs"]["phase"]), e["attrs"])
    last = RESUME_STEPS - 1
    snap = by_phase[(last, "snapshot")]
    transfer, commit = by_phase[(last, "transfer")], by_phase[(last, "commit")]
    (counters,) = [r for tag, r in recs if tag == "COUNTERS"]
    blocking = [r["ms"] for tag, r in recs if tag == "BLOCKING"]
    (alone,) = [r for tag, r in recs if tag == "SNAPSHOT_DEVICE"]
    copy_bound_ms = 2 * alone["bytes"] / PEAK_BYTES_PER_S * 1e3  # read once, written once
    print(f"  costs ({card}): snapshot of {snap['bytes'] / 1e9:.3f} GB "
          f"({snap['bytes']} bytes): {snap['ms']:.2f} ms on the step path, "
          f"{snap['device_ms']:.2f} ms between the copy's events (the host's enqueue "
          f"included: the stream is idle), {snap['ms'] / step_ms:.2%} of a "
          f"{step_ms:.2f} ms step; the copy alone (queued behind a sleep) "
          f"{alone['ms']:.3f} ms against a bound of {copy_bound_ms:.3f} ms (bytes); persist "
          f"in the background: transfer {transfer['ms']:.1f} ms, commit {commit['ms']:.1f} ms; pipeline stall "
          f"{counters['ckpt_pipeline_stall_ms']:.1f} ms over the process's "
          f"{counters['ckpt_async_saves']} async saves; a blocking save "
          + ", ".join(f"{v:.1f}" for v in blocking) + " ms (the first pins its buffers)")
    check(snap["bytes"] > 0 and all(s["bytes"] == snap["bytes"] for s in snaps),
          "the snapshots differ in size")
    launches = {}
    for mode, run in runs.items():
        for n, c in flash_of(run[1]).items():
            launches[n] = launches.get(n, 0) + c
    off_route = {n: c for n, c in launches.items() if not n.endswith("_sm90") and c}
    print(f"  flash launches over the phase's processes: {launches}")
    check(not off_route, f"flash launches off the sm90 route: {off_route}")
    print(f"  phase 7c: {phase_s:.1f} s")
    return launches


# Kinds of device operation in the training step's trace, first match wins.
OP_KINDS = [
    ("flash kernels", r"::(fwd|dkv|dq)(_sm90|_tf32)?_kernel<"),
    ("matmul", r"nvjet|gemm|cutlass|xmma"),
    ("softmax / log_softmax", r"softmax"),
    ("reduction", r"reduce_kernel"),
    ("index / gather / scatter", r"index|gather|scatter"),
    ("elementwise", r"elementwise_kernel"),
    ("copy / fill", r"Memcpy|Memset|copy|fill"),
]


def device_trace(torch, fn):
    """Run ``fn`` once under torch.profiler. Returns the device operations'
    count, their window and busy time in µs, the host-clock ms, and
    {name: (µs, count)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    check(spans, "the profiler recorded no device activity")
    spans.sort()
    window = spans[-1][1] - spans[0][0]
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for a, e, _ in spans[1:]:  # union of the device intervals
        if a > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = a, e
        else:
            cur_end = max(cur_end, e)
    busy += cur_end - cur_start
    by_name = {}
    for a, e, name in spans:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + e - a, n + 1)
    return len(spans), window, busy, wall_ms, by_name


def print_trace(label, n_ops, window, busy, wall_ms, by_name):
    """The top device operations and the operations by kind; returns the kinds
    as {kind: (ms, count)}."""
    print(f"  {n_ops} device operations over {window / 1e3:.2f} ms of device time "
          f"({wall_ms:.2f} ms host clock, profiler on); device idle share "
          f"{1 - busy / window:.1%} of that window")
    print(f"  top device operations by time{label}:")
    for name, (total, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {total / 1e3:8.3f} ms {total / window:6.1%} x{n:<5d} {name[:110]}")
    groups = {}  # kind of device operation -> (ms, count)
    for name, (total, n) in by_name.items():
        kind = next((k for k, pattern in OP_KINDS if re.search(pattern, name)), "other")
        ms, count = groups.get(kind, (0.0, 0))
        groups[kind] = (ms + total / 1e3, count + n)
    print("  by kind: " + "; ".join(
        f"{k} {ms:.2f} ms ({ms * 1e3 / window:.1%}, x{n})"
        for k, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    return groups


def profile_replay(torch, step, x, y, n_layers):
    """Phase 8: a torch.profiler trace of one replayed step."""
    print("[8] torch.profiler trace of one replayed step")
    n_ops, window, busy, wall_ms, by_name = device_trace(torch, lambda: step(x, y))
    print_trace("", n_ops, window, busy, wall_ms, by_name)
    # the bf16 step runs the sm90 forward, dK/dV and dQ kernels, each once per
    # layer, and no SIMT or tf32x3 flash kernel
    for label, pattern, want in (("fwd_sm90", r"::fwd_sm90_kernel<", n_layers),
                                 ("dkv_sm90", r"::dkv_sm90_kernel<", n_layers),
                                 ("dq_sm90", r"::dq_sm90_kernel<", n_layers),
                                 ("fwd (SIMT)", r"::fwd_kernel<", 0),
                                 ("fwd (tf32x3)", r"::fwd_tf32_kernel<", 0),
                                 ("dkv (SIMT)", r"::dkv_kernel<", 0),
                                 ("dq (SIMT)", r"::dq_kernel<", 0),
                                 ("dkv (tf32x3)", r"::dkv_tf32_kernel<", 0),
                                 ("dq (tf32x3)", r"::dq_tf32_kernel<", 0)):
        hits = [(total, n) for name, (total, n) in by_name.items() if re.search(pattern, name)]
        total = sum(t for t, _ in hits)
        count = sum(n for _, n in hits)
        print(f"  flash {label}: {count} launches in the replay, {total / 1e3:.3f} ms, "
              f"{total / window:.1%} of the step")
        check(count == want,
              f"the replayed step ran the {label} kernel {count} times, not {want}")


# The 345M embedding, the largest parameter, and the sizes the update kernels
# are held to their plain versions at: one element, ragged, one TPU tile, a
# float4 tail, 2^20 + 3.
EMBED_NUMEL = 50304 * 1024
UPDATE_SIZES = [1, 1000, 1024, 4097, 2 ** 20 + 3, EMBED_NUMEL]
# Per element: f32 buffers read and written (p, g and the state read, p and
# the state written) and floating-point operations with weight decay on.
UPDATE_BYTES = {"adam": 28, "momentum": 20, "sgd": 12}
UPDATE_FLOPS = {"adam": 14, "momentum": 8, "sgd": 4}


def update_bound_ms(kind, n):
    """Least time for one fused update of n f32 elements: max(bytes / HBM
    rate, operations / the f32 peak). Bytes: each buffer read once and each
    output written once, plus lr and the sentinel."""
    t_bytes = (UPDATE_BYTES[kind] * n + 5) / PEAK_BYTES_PER_S * 1e3
    t_ops = UPDATE_FLOPS[kind] * n / PEAK_FLOPS["float32"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def check_update_kernels(torch, fu, gen, dev):
    """Phase 9: the three fused-update kernels against their plain versions,
    bitwise, and their times at the embedding's size."""
    print("[9] fused_update kernels vs plain, bitwise")
    lr = torch.full((), 3e-4, device=dev)
    gates = {"off": None, "clear": torch.tensor(False, device=dev),
             "set": torch.tensor(True, device=dev)}
    cases = [("sgd", None), ("momentum", False), ("momentum", True), ("adam", None)]

    def run(kind, nesterov, bufs, wd, bad, plain):
        p, g, m, v = bufs
        if plain:
            if kind == "sgd":
                return (fu.sgd_plain(p, g, lr, wd=wd, bad=bad),)
            if kind == "momentum":
                return fu.momentum_plain(p, g, m, lr, mu=0.9, nesterov=nesterov, wd=wd, bad=bad)
            return fu.adam_plain(p, g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, wd=wd, bad=bad)
        if kind == "sgd":
            fu.fused_sgd(p, g, lr, wd=wd, bad=bad)
            return (p,)
        if kind == "momentum":
            fu.fused_momentum(p, g, m, lr, mu=0.9, nesterov=nesterov, wd=wd, bad=bad)
            return p, m
        fu.fused_adam(p, g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, wd=wd, bad=bad)
        return p, m, v

    checked = 0
    max_err = {"sgd": 0.0, "momentum": 0.0, "adam": 0.0}
    for n in UPDATE_SIZES:
        bufs = [torch.randn(n, generator=gen, device=dev) for _ in range(3)]
        bufs.append(torch.rand(n, generator=gen, device=dev))
        for kind, nesterov in cases:
            for wd in (0.0, 0.01):
                for gate, bad in gates.items():
                    got = run(kind, nesterov, [b.clone() for b in bufs], wd, bad, plain=False)
                    want = run(kind, nesterov, bufs, wd, bad, plain=True)
                    torch.cuda.synchronize()
                    ok = all(torch.equal(a, b) for a, b in zip(got, want))
                    max_err[kind] = max([max_err[kind]] + [(a - b).abs().max().item()
                                                           for a, b in zip(got, want)])
                    if gate == "set":  # p, then the state: m (velocity) and v
                        ok = ok and all(torch.equal(a, bufs[i])
                                        for a, i in zip(got, (0, 2, 3)))
                    check(ok, f"fused_update {kind} nesterov={nesterov} n={n} wd={wd} "
                              f"gate={gate}: kernel and plain version differ")
                    checked += 1
        print(f"  n={n}: {len(cases) * 2 * len(gates)} cases bitwise equal "
              f"(sgd, momentum, momentum nesterov, adam x wd 0, 0.01 x gate off, clear, set)")
        del bufs
    print(f"  {checked} cases, every one bitwise equal on p and every state tensor; "
          f"a set gate leaves every buffer as it was")

    # times at the embedding's size, the sentinel clear (the main path's gate)
    n = EMBED_NUMEL
    p, g, m = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    v = torch.rand(n, generator=gen, device=dev)
    bad = gates["clear"]
    step = torch.ones((), device=dev)
    kernel = {
        "adam": lambda: fu.fused_adam(p, g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.01,
                                      bad=bad),
        "momentum": lambda: fu.fused_momentum(p, g, m, lr, mu=0.9, nesterov=True, wd=1e-4,
                                              bad=bad),
        "sgd": lambda: fu.fused_sgd(p, g, lr, wd=0.01, bad=bad),
    }
    plain = {
        "adam": lambda: fu.adam_plain(p, g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.01,
                                      bad=bad),
        "momentum": lambda: fu.momentum_plain(p, g, m, lr, mu=0.9, nesterov=True, wd=1e-4,
                                              bad=bad),
        "sgd": lambda: fu.sgd_plain(p, g, lr, wd=0.01, bad=bad),
    }
    # the yardsticks, never called by the port: torch.optim's fused updates.
    # SGD's is the same formula for SGD and Momentum; Adam's puts eps after
    # dividing sqrt(v) by sqrt(1 - b2^t), so it is not the same function.
    library = {
        "adam": lambda: torch._fused_adam_(
            [p], [g], [m], [v], [], [step], lr=3e-4, beta1=0.9, beta2=0.999,
            weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
        "momentum": lambda: torch._fused_sgd_(
            [p], [g], [m], weight_decay=1e-4, momentum=0.9, lr=3e-4, dampening=0.0,
            nesterov=True, maximize=False, is_first_step=False),
        "sgd": lambda: torch._fused_sgd_(
            [p], [g], [], weight_decay=0.01, momentum=0.0, lr=3e-4, dampening=0.0,
            nesterov=False, maximize=False, is_first_step=False),
    }
    out = {}
    for kind in ("adam", "momentum", "sgd"):
        before = fu.KERNELS[kind].launches
        ms = time_ms(kernel[kind])
        plain_ms = time_ms(plain[kind])
        library_ms = time_ms(library[kind])
        check(fu.KERNELS[kind].launches == before + 23, f"{kind}: timed launches not counted")
        bound_ms, bound_by = update_bound_ms(kind, n)
        out[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, max_abs_err=max_err[kind])
        print(f"  {kind} n={n}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
              f"{UPDATE_BYTES[kind]} B/elem); kernel at {bound_ms / ms:.1%} of bound, "
              f"{UPDATE_BYTES[kind] * n / ms / 1e6:.0f} GB/s")
    del p, g, m, v
    return out


def bitwise_same(torch, model_a, model_b, opt_a, opt_b):
    """Whether two models' parameters and their optimizers' states are equal
    to the bit."""
    for a, b in zip(model_a.parameters(), model_b.parameters()):
        if not torch.equal(a, b):
            return False
        sa, sb = opt_a._accumulators[id(a)], opt_b._accumulators[id(b)]
        if sorted(sa) != sorted(sb) or not all(torch.equal(sa[k], sb[k]) for k in sa):
            return False
    return True


def train_f32_adam(torch, pt, fa, fu, gen, dev):
    """Phase 10: eager f32 GPT-2 345M with Adam through the fused kernel,
    against a flag-off copy and against a copy stepped under the resilience
    runtime's optimizer fault and nan:grads; then the forward + backward of
    the step with the flash kernels on their route, the forward forced to
    SIMT and the backward forced to SIMT, in turns. Returns ({"adam": launches over the path},
    {"flash": flash launches over the path, "fwd_bwd_ms", "turns": {config:
    median ms}, "steps", "layers"})."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    batch, steps, nan_at = 8, 6, 2
    print(f"[10] GPT-2 345M f32 eager training, {batch} x 1024 tokens, Adam + L2Decay(0.01) + "
          f"ClipGradByGlobalNorm(1.0) + LinearWarmup(CosineAnnealingDecay), "
          f"numeric_rescue=skip, NaN gradient at step {nan_at}")
    torch.cuda.reset_peak_memory_stats(dev)
    pt.seed(SEED)
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    model = GPTForPretraining(cfg, device=dev)
    copy_off = copy.deepcopy(model)  # before any step
    copy_fault = copy.deepcopy(model)
    n_params = len(list(model.parameters()))
    numel = sum(p.numel() for p in model.parameters())
    largest = max(p.numel() for p in model.parameters())
    print(f"  {n_params} parameters, {numel} f32 elements, largest {largest}")
    criterion = GPTPretrainingCriterion(cfg)
    ids = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1), generator=gen,
                        device=dev)
    x, y = ids[:, :-1], ids[:, 1:]
    pt.set_flags({"FLAGS_numeric_rescue": "skip"})

    def run(m, flag, spec=None):
        """Steps of ``m`` with the fused-update flag ``flag``: the NaN
        gradient poisoned by hand, or through the fault spec ``spec`` (the
        resilience runtime reset first, so its step counts from here)."""
        sched = pt.optimizer.lr.LinearWarmup(
            pt.optimizer.lr.CosineAnnealingDecay(1e-4, T_max=10), warmup_steps=2,
            start_lr=1e-5, end_lr=1e-4)
        opt = pt.optimizer.Adam(learning_rate=sched, parameters=m.parameters(),
                                weight_decay=pt.regularizer.L2Decay(0.01),
                                grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
        pt.set_flags({"FLAGS_pallas_fused_update": flag})
        pt.resilience.rescue.reset_counters()
        if spec is not None:
            pt.resilience.reset()
            pt.set_flags({"FLAGS_fault_inject": spec, "FLAGS_retry_backoff_ms": 0.5})
        losses, step_ms, per_step, fwd_bwd_ms = [], [], [], []
        for i in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = criterion(m(x), y)
            loss.backward()
            end.record()
            end.synchronize()
            if i > 0:  # the first allocates the gradients
                fwd_bwd_ms.append(start.elapsed_time(end))
            snap = None
            if i == nan_at:
                if spec is None:
                    next(m.parameters()).grad.fill_(float("nan"))
                snap = ([p.detach().clone() for p in m.parameters()],
                        [{k: t.clone() for k, t in opt._accumulators[id(p)].items()}
                         for p in m.parameters()])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = fu.fused_adam.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            opt.step()
            end.record()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            per_step.append(fu.fused_adam.launches - before)
            if i not in (0, nan_at):  # the first creates the state; the NaN step is rescued
                step_ms.append((start.elapsed_time(end), host))
            opt.clear_grad()
            sched.step()
            losses.append(loss.item())
            if snap is not None:
                same = all(torch.equal(a, b) for a, b in zip(m.parameters(), snap[0])) and all(
                    torch.equal(opt._accumulators[id(p)][k], st[k])
                    for p, st in zip(m.parameters(), snap[1]) for k in st)
                check(same, f"flag {flag}: the NaN step changed params or optimizer state")
                del snap
        check(pt.resilience.rescue.counters["numeric_rescues"] == 1,
              f"flag {flag}: numeric_rescues is "
              f"{pt.resilience.rescue.counters['numeric_rescues']}, not 1")
        pt.set_flags({"FLAGS_fault_inject": "", "FLAGS_retry_backoff_ms": 5.0})
        return opt, losses, step_ms, per_step, fwd_bwd_ms

    for kernel in fu.KERNELS.values():
        kernel.launches = 0  # the f32 Adam path's count starts here
    t0 = time.perf_counter()
    opt_on, losses_on, ms_on, per_step_on, fb_on = run(model, True)
    on_s = time.perf_counter() - t0
    opt_off, losses_off, ms_off, per_step_off, fb_off = run(copy_off, False)
    # the same run through the resilience runtime: every step's update
    # launch faults once (injected before the launch, so retried) and the
    # NaN gradient comes from a nan:grads clause
    spec = f"execute:optimizer:p=1:x=1,nan:grads:step={nan_at}"
    pt.profiler.reset_dispatch_counters()
    opt_fault, losses_fault, _, per_step_fault, _ = run(copy_fault, True, spec)
    faults = pt.profiler.dispatch_counters()
    launches = fu.fused_adam.launches  # ... and ends here
    pt.set_flags({"FLAGS_pallas_fused_update": False, "FLAGS_numeric_rescue": ""})
    mem_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"  flag on: {steps} steps in {on_s:.1f} s; Adam kernel launches per step "
          f"{per_step_on}; flag off: {per_step_off}; peak memory allocated {mem_gb:.1f} GB "
          f"(the three models)")
    check(all(n == n_params for n in per_step_on), "not one Adam launch per parameter per step")
    check(all(n == 0 for n in per_step_off), "the flag-off run launched the kernel")
    check(launches == 2 * n_params * steps, "Adam launches over the path")
    check(fu.fused_momentum.launches == fu.fused_sgd.launches == 0,
          "Adam's path launched another update kernel")
    print("  losses (flag on):  " + " ".join(f"{v:.6f}" for v in losses_on))
    print("  losses (flag off): " + " ".join(f"{v:.6f}" for v in losses_off))
    check(all(math.isfinite(v) for v in losses_on), "non-finite f32 training loss")
    check(losses_on[-1] < losses_on[0], "the f32 loss does not fall on a fixed batch")
    same = bitwise_same(torch, model, copy_off, opt_on, opt_off)
    print(f"  flag on vs flag off: losses bitwise equal {losses_on == losses_off}; every "
          f"parameter, moment and beta-pow bitwise equal {same}; NaN step rescued in both, "
          f"leaving params, moments and beta-pows unchanged")
    check(losses_on == losses_off and same, "the fused kernel and the rule disagree")
    same_fault = bitwise_same(torch, model, copy_fault, opt_on, opt_fault)
    print(f"  under FLAGS_fault_inject={spec!r}: {faults['retry_attempts']} retries, "
          f"{faults['injected_faults']} injected faults (sites {dict(faults['fault_sites'])}), "
          f"Adam kernel launches per step {per_step_fault}; losses bitwise equal to the flag-on "
          f"run {losses_fault == losses_on}; parameters and moments {same_fault}")
    check(faults["retry_attempts"] > 0, "the faulted run retried nothing")
    check(all(n == n_params for n in per_step_fault),
          "the faulted run: not one Adam launch per parameter per step")
    check(losses_fault == losses_on and same_fault,
          "the faulted run is not bitwise equal to the flag-on run")
    med = {name: (statistics.median(d for d, _ in t), statistics.median(h for _, h in t))
           for name, t in (("on", ms_on), ("off", ms_off))}
    print(f"  opt.step() (clip, sentinel, update, host read of the sentinel), median of "
          f"{len(ms_on)} steps: flag on {med['on'][0]:.2f} ms (CUDA events), "
          f"{med['on'][1]:.2f} ms (host clock); flag off {med['off'][0]:.2f} ms, "
          f"{med['off'][1]:.2f} ms")
    fwd_bwd = statistics.median(fb_on + fb_off)
    print(f"  forward + backward (loss, loss.backward()), median of {len(fb_on + fb_off)} "
          f"steps of both runs: {fwd_bwd:.2f} ms (CUDA events); flag on "
          + " ".join(f"{v:.2f}" for v in fb_on) + "; flag off "
          + " ".join(f"{v:.2f}" for v in fb_off))
    flash = flash_counts(fa)  # the f32 training path's flash count ends here

    # what the tf32x3 routes do to the step: forward + backward of the
    # trained model with the flash kernels on their route, with the forward
    # forced to SIMT and with the backward forced to SIMT (through
    # `_fwd_route` and `_bwd_route`), in turns, two steps each
    forced_by = {"route": (), "fwd_simt": ("_fwd_route",), "bwd_simt": ("_bwd_route",)}

    def fwd_bwd_ms(config):
        routes = {name: getattr(fa, name) for name in ("_fwd_route", "_bwd_route")}
        for name in forced_by[config]:
            setattr(fa, name, lambda tensors: "simt")
        try:
            times = []
            before = flash_counts(fa)
            for _ in range(2):
                opt_on.clear_grad()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                criterion(model(x), y).backward()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        finally:
            for name, fn in routes.items():
                setattr(fa, name, fn)
        took = {n: c - before[n] for n, c in flash_counts(fa).items() if c != before[n]}
        n = 2 * cfg.num_layers
        want = {"fwd_" + ("simt" if config == "fwd_simt" else "tf32x3"): n,
                "dkv_" + ("simt" if config == "bwd_simt" else "tf32x3"): n,
                "dq_" + ("simt" if config == "bwd_simt" else "tf32x3"): n}
        check(took == want, f"forward + backward ({config}) launched {took}, expected {want}")
        return times

    turns = {config: [] for config in forced_by}
    for config in ("route", "fwd_simt", "bwd_simt", "bwd_simt", "fwd_simt", "route"):
        turns[config] += fwd_bwd_ms(config)
    opt_on.clear_grad()
    med = {config: statistics.median(t) for config, t in turns.items()}
    print(f"  forward + backward, in turns, median of {len(turns['route'])} steps each (CUDA "
          f"events): flash kernels on tf32x3 {med['route']:.2f} ms; the forward forced to "
          f"SIMT {med['fwd_simt']:.2f} ms ({med['fwd_simt'] - med['route']:.2f} ms more); the "
          f"backward forced to SIMT {med['bwd_simt']:.2f} ms "
          f"({med['bwd_simt'] - med['route']:.2f} ms more); "
          + "; ".join(f"{config} " + " ".join(f"{v:.2f}" for v in t)
                      for config, t in turns.items()))
    del model, copy_off, copy_fault, opt_on, opt_off, opt_fault
    torch.cuda.empty_cache()
    return {"adam": launches}, {"flash": flash, "fwd_bwd_ms": fwd_bwd, "turns": med,
                                "steps": 3 * steps, "layers": cfg.num_layers}


def train_momentum_sgd(torch, pt, fu, gen, dev):
    """Phase 11: Momentum (Nesterov) and SGD at full width and 4 layers, flag
    on against flag off. Returns their kernels' launches over the path."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    batch, steps = 8, 3
    cfg = dataclasses.replace(gpt2_345m(dropout=0.0, attn_dropout=0.0), num_layers=4)
    print(f"[11] Momentum (Nesterov, L2Decay(1e-4)) and SGD, f32, full width, "
          f"{cfg.num_layers} layers, {batch} x 1024 tokens, {steps} steps each")
    criterion = GPTPretrainingCriterion(cfg)
    ids = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1), generator=gen,
                        device=dev)
    x, y = ids[:, :-1], ids[:, 1:]
    makers = {
        "momentum": lambda ps: pt.optimizer.Momentum(
            learning_rate=1e-3, momentum=0.9, parameters=ps, use_nesterov=True,
            weight_decay=pt.regularizer.L2Decay(1e-4)),
        "sgd": lambda ps: pt.optimizer.SGD(learning_rate=1e-2, parameters=ps),
    }
    pt.set_flags({"FLAGS_numeric_rescue": "skip"})
    launches = {}
    for kind, make in makers.items():
        pt.seed(SEED)
        model = GPTForPretraining(cfg, device=dev)
        copy_off = copy.deepcopy(model)
        n_params = len(list(model.parameters()))
        for kernel in fu.KERNELS.values():
            kernel.launches = 0  # this optimizer's path starts here
        results = []
        for m, flag in ((model, True), (copy_off, False)):
            pt.set_flags({"FLAGS_pallas_fused_update": flag})
            opt = make(m.parameters())
            losses = []
            for _ in range(steps):
                loss = criterion(m(x), y)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(loss.item())
            results.append((opt, losses, fu.KERNELS[kind].launches))
        launches[kind] = fu.KERNELS[kind].launches  # ... and ends here
        pt.set_flags({"FLAGS_pallas_fused_update": False})
        (opt_on, l_on, n_on), (opt_off, l_off, n_off) = results
        same = bitwise_same(torch, model, copy_off, opt_on, opt_off)
        others = sum(k.launches for name, k in fu.KERNELS.items() if name != kind)
        print(f"  {kind}: launches {n_on} in the flag-on run ({n_params} parameters x "
              f"{steps} steps), {n_off - n_on} with the flag off; losses "
              + " ".join(f"{v:.6f}" for v in l_on)
              + f"; flag on vs off: losses bitwise equal {l_on == l_off}, params and state "
              f"bitwise equal {same}")
        check(n_on == n_params * steps and n_off == n_on and others == 0,
              f"{kind}: expected {n_params * steps} launches, got {n_on} ({n_off - n_on} "
              f"flag-off, {others} other kernels)")
        check(all(math.isfinite(v) for v in l_on), f"{kind}: non-finite loss")
        check(l_on == l_off and same, f"{kind}: the fused kernel and the rule disagree")
        del model, copy_off, opt_on, opt_off, results
    pt.set_flags({"FLAGS_numeric_rescue": ""})
    torch.cuda.empty_cache()
    return launches


# The tf32x3 forward's repeat witness (``--tf32-repeat N``): N fresh processes
# each build (or load) the library and compare the first two launches of the
# process at phase 3's first case bit for bit; then, where the toolkit has
# compute-sanitizer, one process under each of its hazard tools
SANITIZER_TOOLS = ("racecheck", "synccheck", "initcheck")
SANITIZER_TIMEOUT_S = 300


def tf32_repeat_once(torch, fa, dev) -> bool:
    """The first two tf32x3 forwards of this process at (4, 1024, 16, 64)
    causal f32 on fused-qkv views, made as phase 3 makes them; prints where
    they differ. True when they are bitwise equal."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    q, k, v = qkv_on_card(FWD_MAIN_SHAPE, torch.float32, "fused", gen, dev)
    check(route_of(fa, (q, k, v)) == "tf32x3", "the witness's inputs are not on tf32x3")
    scale = FWD_MAIN_SHAPE[3] ** -0.5
    o_1, lse_1 = fa.flash_attention_fwd(q, k, v, scale, True)
    o_2, lse_2 = fa.flash_attention_fwd(q, k, v, scale, True)
    torch.cuda.synchronize()
    check(fa.flash_attention_fwd.launches_by_route["tf32x3"] == 2, "not two tf32x3 launches")
    same = torch.equal(o_1, o_2) and torch.equal(lse_1, lse_2)
    o_p, lse_p = fa.fwd_plain(q, k, v, scale, True)
    err = max((o_1 - o_p).abs().max().item(), (lse_1 - lse_p).abs().max().item(),
              (o_2 - o_p).abs().max().item(), (lse_2 - lse_p).abs().max().item())
    print(f"  pid {os.getpid()}: first two launches bitwise equal: {same}; max|d| against "
          f"fwd_plain {err:.3e}")
    if not same:
        rows = (o_1 != o_2).any(dim=-1).nonzero().tolist()
        print(f"    differ in {len(rows)} O rows [batch, row, head] (first {rows[:8]}), by at "
              f"most {(o_1 - o_2).abs().max().item():.3e}; lse in "
              f"{int((lse_1 != lse_2).sum())} entries")
    return same


def tf32_repeat_witness(n: int) -> int:
    """``--tf32-repeat N``: see SANITIZER_TOOLS. Exits 0 when every process
    found its two launches equal and no sanitizer tool reported an error."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(f"[0] the tf32x3 forward's first two launches, {n} fresh processes; {card}")
    _build.build([fa.TF32_FWD_KERNEL_NAME])
    me = [sys.executable, os.path.abspath(__file__), "--tf32-repeat-once"]
    equal = 0
    for _ in range(n):
        run = subprocess.run(me, capture_output=True, text=True, timeout=300)
        sys.stdout.write(run.stdout + run.stderr)
        equal += run.returncode == 0
    print(f"  {equal} of {n} fresh processes gave two bitwise-equal launches")
    failed = equal != n
    sanitizer = os.path.join(os.path.dirname(_build.nvcc()), "compute-sanitizer")
    if not os.path.isfile(sanitizer):
        print(f"  no compute-sanitizer at {sanitizer}: the hazard tools did not run")
    for tool in SANITIZER_TOOLS if os.path.isfile(sanitizer) else ():
        cmd = [sanitizer, "--tool", tool, "--kernel-name", "kns=fwd_tf32_kernel",
               "--print-limit", "20", "--error-exitcode", "9", *me]
        try:
            run = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=SANITIZER_TIMEOUT_S)
            out, rc = run.stdout + run.stderr, run.returncode
        except subprocess.TimeoutExpired as e:
            # the captured output of a timed-out run is bytes, whatever text= says
            out = b"".join(x or b"" for x in (e.stdout, e.stderr)).decode(errors="replace")
            rc = "timeout"
        if "Device not supported" in out:
            # the sanitizer does not support this card: no verdict
            print(f"  compute-sanitizer --tool {tool}: did not run, the sanitizer does not "
                  f"support this device (rc {rc})")
            continue
        tail = "\n".join(out.strip().splitlines()[-25:])
        print(f"  compute-sanitizer --tool {tool}: rc {rc}\n{tail}")
        failed |= rc != 0
    return 1 if failed else 0


def main() -> int:
    import torch

    if "--tf32-repeat" in sys.argv:
        return tf32_repeat_witness(int(sys.argv[sys.argv.index("--tf32-repeat") + 1]))
    if "--resume-child" in sys.argv:
        at = sys.argv.index("--resume-child")
        return resume_child(sys.argv[at + 1], sys.argv[at + 2])
    if "--tf32-repeat-once" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from paddle_tpu_torch.ops.kernels import flash_attention as fa

        return 0 if tf32_repeat_once(torch, fa, torch.device("cuda", 0)) else 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt2_345m
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_update as fu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print("[1] card")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    sm90_sources = [fa.SM90_FWD_KERNEL_NAME, fa.SM90_DKV_KERNEL_NAME, fa.SM90_DQ_KERNEL_NAME]
    tf32_sources = [fa.TF32_FWD_KERNEL_NAME, fa.TF32_BWD_KERNEL_NAME]
    sources = [fa.KERNEL_NAME, fa.BWD_KERNEL_NAME, *sm90_sources, *tf32_sources, fu.KERNEL_NAME]
    logs = _build.build(sources)
    print(f"[2] built {sources} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        # ptxas -v: each instantiation, its registers and spills, and any
        # warning that it serialized the wgmmas
        for line in log.splitlines():
            if any(w in line for w in ("Function properties", "registers", "spill", "wgmma")):
                print(f"  {name}: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    for name in sm90_sources:
        sass = subprocess.run([cuobjdump, "-sass", _build.library_path(name)], check=True,
                              capture_output=True, text=True).stdout
        hgmma = sum(1 for line in sass.splitlines() if "HGMMA" in line)
        print(f"  {name}: {hgmma} HGMMA (wgmma) instructions in the library's SASS")
        check(hgmma > 0, f"{name} has no HGMMA instruction: its products are not on the "
                         f"tensor cores")
    for name in tf32_sources:
        counts = sass_counts(cuobjdump, _build.library_path(name))
        hmma = sum(h for h, _, _ in counts.values())
        total = sum(n for _, n, _ in counts.values())
        print(f"  {name}: {hmma} HMMA TF32 (mma.sync) instructions in the library's SASS, of "
              f"{total} ({total / max(hmma, 1):.1f} per HMMA: the operand splits, shared "
              f"loads and exps run beside them); by kernel, HMMA of all and of the tile "
              f"loop's: " + ", ".join(f"{fn} {h} of {n} ({n / max(h, 1):.1f} per HMMA) and of "
                                       f"{loop} ({loop / max(h, 1):.1f})"
                                       for fn, (h, n, loop) in counts.items()))
        check(hmma > 0, f"{name} has no TF32 HMMA instruction")

    # 3. the forward kernels against their plain version
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    fwd = check_forward_kernels(torch, fa, gen, dev)

    # 4. full-sequence forward of GPT-2 345M through the kernel
    print("[4] GPT-2 345M forward, 4 x 1024 tokens")
    pt.seed(SEED)
    cfg = gpt2_345m()
    model = GPTForPretraining(cfg, device="gpu:0").eval()
    n_params = sum(p.numel() for p in model.parameters())
    batch, seq = 4, cfg.max_seq_len
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
    reset_flash_counts(fa)  # the inference path's count starts here
    with torch.no_grad():
        logits = model(ids)
        torch.cuda.synchronize()
        per_forward = flash_counts(fa)
        print(f"  params={n_params} layers={cfg.num_layers}; flash launches in one f32 "
              f"forward: {per_forward}")
        check(per_forward["fwd_tf32x3"] == cfg.num_layers
              and sum(per_forward.values()) == cfg.num_layers,
              f"expected {cfg.num_layers} tf32x3 forward launches per f32 forward, got "
              f"{per_forward}")
        check(tuple(logits.shape) == (batch, seq, cfg.vocab_size), "logits shape")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        fwd_ms = time_ms(lambda: model(ids), reps=5, warmup=1)
        print(f"  f32 forward: {fwd_ms:.2f} ms, {batch * seq / fwd_ms * 1e3:.0f} tokens/s")

        pt.set_flags({"FLAGS_use_flash_attention": False})
        before = fa.flash_attention_fwd.launches
        dense = model(ids)
        torch.cuda.synchronize()
        check(fa.flash_attention_fwd.launches == before, "dense path launched the kernel")
        pt.set_flags({"FLAGS_use_flash_attention": True})
        logit_err = (logits - dense).abs().max().item()
        print(f"  flash vs dense logits: max|d|={logit_err:.3e} tol={TOL_LOGITS:g} "
              f"(max|logit|={logits.abs().max().item():.3f})")
        check(logit_err <= TOL_LOGITS, "flash and dense logits disagree")
        del dense, logits

        model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
        before = flash_counts(fa)
        logits16 = model_bf16(ids)
        torch.cuda.synchronize()
        per_forward = {n: c - before[n] for n, c in flash_counts(fa).items()}
        print(f"  flash launches in one bf16 forward: {per_forward}")
        check(per_forward["fwd_sm90"] == cfg.num_layers
              and sum(per_forward.values()) == cfg.num_layers,
              f"expected {cfg.num_layers} sm90 forward launches per bf16 forward, got "
              f"{per_forward}")
        check(bool(torch.isfinite(logits16.float()).all()), "non-finite bf16 logits")
        bf16_ms = time_ms(lambda: model_bf16(ids), reps=5, warmup=1)
        print(f"  bf16 forward: {bf16_ms:.2f} ms, {batch * seq / bf16_ms * 1e3:.0f} tokens/s")
        del model_bf16, logits16

    # 5. serve a few requests
    print("[5] generate(): 4 prompts x 32 tokens, 32 new tokens each, greedy")
    n_prompts, prompt_len, new = 4, 32, 32
    prompts = torch.randint(0, cfg.vocab_size, (n_prompts, prompt_len), generator=gen,
                            device=dev)
    out = model.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = model.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(torch.equal(out, again), "greedy generate() is not deterministic")
    check(tuple(out.shape) == (n_prompts, prompt_len + new), "generate() shape")
    check(torch.equal(out[:, :prompt_len], prompts), "generate() changed the prompt")
    print(f"  decode: {n_prompts * new / gen_s:.1f} tokens/s ({gen_s * 1e3:.1f} ms for "
          f"{n_prompts} x {new} new tokens, prefill included)")
    with torch.no_grad():
        full = model(out)  # the kernel path over each returned buffer
    torch.cuda.synchronize()
    total = prompt_len + new
    pred = full[:, prompt_len - 1:total - 1].argmax(dim=-1)
    want = out[:, prompt_len:total]
    top2 = full[:, prompt_len - 1:total - 1].topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    mismatch = pred != want
    excused = int((mismatch & (margin < TOL_LOGITS)).sum())
    unexcused = int((mismatch & (margin >= TOL_LOGITS)).sum())
    print(f"  cross-check vs the kernel-path forward: {int(mismatch.numel())} positions, "
          f"{int(mismatch.sum())} differ, {excused} excused as near-ties "
          f"(top-2 margin < {TOL_LOGITS:g}), min margin {margin.min().item():.3e}")
    check(unexcused == 0, f"{unexcused} generated tokens disagree with the kernel path")
    inference = flash_counts(fa)  # the inference path's count ends here
    del model, full, out, again
    torch.cuda.empty_cache()

    # 5b. the serving engine
    served = serve_345m(torch, pt, fa, fu, card)
    # 5c. serving under faults
    serve_under_faults(torch, pt, fa, fu, card, served)
    del served
    torch.cuda.empty_cache()

    bwd = check_backward_kernels(torch, fa, gen, dev)
    simt_path = simt_backward_path(torch, pt, fa, gen, dev)
    train = train_345m(torch, pt, fa, gen, dev)
    # 7b. recompute with dropout, the O1 fp16 loop, an input's gradient;
    # before phase 8's trace: a torch.profiler run leaves every later launch
    # dearer on the host
    recompute = recompute_step_345m(torch, pt, fa, gen, dev, train)
    o1 = o1_fp16_scaler_345m(torch, pt, fa, fu, gen, dev)
    grad_input_step(torch, pt, fa, gen, dev)
    profile_replay(torch, *train.pop("profile"))
    torch.cuda.empty_cache()
    # 7c. checkpoint and resume, in processes of its own (after phase 8: the
    # phase 7 step is freed)
    resume = checkpoint_resume_345m(torch, card)
    update = check_update_kernels(torch, fu, gen, dev)
    reset_flash_counts(fa)  # the f32 training path's flash count starts here
    launches_f32, f32_step = train_f32_adam(torch, pt, fa, fu, gen, dev)
    f32_train = f32_step["flash"]  # ... and ends inside, before the route comparison
    # every f32 step: the forward, dK/dV and dQ on tf32x3, once per layer
    n = f32_step["layers"] * f32_step["steps"]
    want = dict.fromkeys(f32_train, 0)
    want.update(fwd_tf32x3=n, dkv_tf32x3=n, dq_tf32x3=n)
    print(f"  flash launches over the f32 training run ({f32_step['steps']} steps): "
          f"{f32_train}, {f32_train['fwd_tf32x3'] / f32_step['steps']:g} forward, "
          f"{f32_train['dkv_tf32x3'] / f32_step['steps']:g} dK/dV and "
          f"{f32_train['dq_tf32x3'] / f32_step['steps']:g} dQ tf32x3 launches per step")
    check(f32_train == want, f"f32 training flash launches {f32_train}, expected {want}")
    launches_f32.update(train_momentum_sgd(torch, pt, fu, gen, dev))

    # 12. per-kernel numbers, then the result
    fwd16, fwd32 = fwd[(FWD_MAIN_SHAPE, "bfloat16")], fwd[(FWD_MAIN_SHAPE, "float32")]
    fwd16_train = fwd[(BWD_MAIN_SHAPE, "bfloat16")]
    bwd16 = bwd["bfloat16"]
    print(f"[12] side by side, bf16, ms: forward at {FWD_MAIN_SHAPE} sm90 {fwd16['ms']:.4f} "
          f"SIMT {fwd16['simt_ms']:.4f} SDPA {fwd16['library_ms']:.4f}; forward at "
          f"{BWD_MAIN_SHAPE} sm90 {fwd16_train['ms']:.4f} SIMT {fwd16_train['simt_ms']:.4f} "
          f"SDPA {fwd16_train['library_ms']:.4f}; at {BWD_MAIN_SHAPE}: dK/dV sm90 "
          f"{bwd16['dkv']['ms']:.4f} SIMT {bwd16['dkv']['simt_ms']:.4f}, dQ sm90 "
          f"{bwd16['dq']['ms']:.4f} SIMT {bwd16['dq']['simt_ms']:.4f}, the sm90 pair "
          f"{bwd16['pair_ms']:.4f} against SDPA's backward (all three gradients) "
          f"{bwd16['dkv']['library_ms']:.4f}")
    bwd32 = bwd["float32"]
    print(f"    f32 at {BWD_MAIN_SHAPE}: dK/dV tf32x3 {bwd32['dkv']['ms']:.4f} SIMT "
          f"{bwd32['dkv']['simt_ms']:.4f}, dQ tf32x3 {bwd32['dq']['ms']:.4f} SIMT "
          f"{bwd32['dq']['simt_ms']:.4f}, the tf32x3 pair {bwd32['pair_ms']:.4f}, the SIMT "
          f"pair {bwd32['simt_pair_ms']:.4f}, SDPA's f32 backward {bwd32['library_again_ms']:.4f} "
          f"(and {bwd32['dkv']['library_ms']:.4f})")
    turns = f32_step["turns"]
    print(f"    f32 forward at {FWD_MAIN_SHAPE}: tf32x3 {fwd32['ms']:.4f} SIMT "
          f"{fwd32['simt_ms']:.4f} SDPA {fwd32['library_ms']:.4f}; f32 step forward + backward "
          f"{f32_step['fwd_bwd_ms']:.2f} ms; in turns {turns['route']:.2f} ms on tf32x3, "
          f"{turns['fwd_simt']:.2f} ms with the forward forced to SIMT, "
          f"{turns['bwd_simt']:.2f} ms with the backward forced to SIMT")
    fwd_h, bwd_h = fwd[(BWD_MAIN_SHAPE, "float16")], bwd["float16"]
    print(f"    fp16 at {BWD_MAIN_SHAPE} (the O1 path's shape): forward sm90 {fwd_h['ms']:.4f} "
          f"SIMT {fwd_h['simt_ms']:.4f} SDPA {fwd_h['library_ms']:.4f} (bound "
          f"{fwd_h['bound_ms']:.4f}); dK/dV sm90 {bwd_h['dkv']['ms']:.4f}, dQ sm90 "
          f"{bwd_h['dq']['ms']:.4f}, the pair {bwd_h['pair_ms']:.4f} against SDPA's backward "
          f"{bwd_h['library_again_ms']:.4f} (and {bwd_h['dkv']['library_ms']:.4f}); bounds "
          f"dK/dV {bwd_h['dkv']['bound_ms']:.4f}, dQ {bwd_h['dq']['bound_ms']:.4f}")
    print(f"    launches per path: the recompute step (7b-i, 2 eager steps and the capture) "
          f"{recompute['launches']}; the O1 loop (7b-ii, both runs) {o1['launches']}, Adam "
          f"{o1['adam']}")
    print(f"forward f32 at {FWD_MAIN_SHAPE}: " + json.dumps(fwd32))
    print(f"backward f32 at {BWD_MAIN_SHAPE}: " + json.dumps(bwd32))

    def row(name, source, line, launches, t):
        r = {
            "name": name,
            "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": launches,
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        }
        if "cuda_core_bound_ms" in t:  # f32: the CUDA cores' bound beside the 3xTF32 one
            r["cuda_core_bound_ms"] = t["cuda_core_bound_ms"]
        return r

    rows = [
        row("flash_attention_fwd", "flash_attention_fwd_sm90.cu", 69,
            inference["fwd_sm90"] + train["launches"]["fwd_sm90"] + resume["fwd_sm90"]
            + recompute["launches"]["fwd_sm90"] + o1["launches"]["fwd_sm90"], fwd16),
        row("flash_attention_fwd_tf32", "flash_attention_fwd_tf32.cu", 69,
            inference["fwd_tf32x3"] + f32_train["fwd_tf32x3"], fwd32),
        # the SIMT kernel at the main f32 shape, on the tf32x3 case's inputs
        row("flash_attention_fwd_simt", "flash_attention_fwd.cu", 69, simt_path["fwd_simt"],
            dict(fwd32, ms=fwd32["simt_ms"], max_abs_err=fwd32["simt_max_abs_err"])),
        row("flash_attention_bwd_dkv", "flash_attention_bwd_dkv_sm90.cu", 151,
            train["launches"]["dkv_sm90"] + resume["dkv_sm90"] + recompute["launches"]["dkv_sm90"]
            + o1["launches"]["dkv_sm90"], bwd["bfloat16"]["dkv"]),
        row("flash_attention_bwd_dkv_tf32", "flash_attention_bwd_tf32.cu", 151,
            f32_train["dkv_tf32x3"], bwd32["dkv"]),
        row("flash_attention_bwd_dkv_simt", "flash_attention_bwd.cu", 151,
            simt_path["dkv_simt"], bwd32["dkv_simt"]),
        row("flash_attention_bwd_dq", "flash_attention_bwd_dq_sm90.cu", 197,
            train["launches"]["dq_sm90"] + resume["dq_sm90"] + recompute["launches"]["dq_sm90"]
            + o1["launches"]["dq_sm90"], bwd["bfloat16"]["dq"]),
        row("flash_attention_bwd_dq_tf32", "flash_attention_bwd_tf32.cu", 197,
            f32_train["dq_tf32x3"], bwd32["dq"]),
        row("flash_attention_bwd_dq_simt", "flash_attention_bwd.cu", 197,
            simt_path["dq_simt"], bwd32["dq_simt"]),
    ]
    for r in rows:
        check(r["launches"] > 0, f"the {r['name']} kernel was launched no time on its path")
    for kind, line in (("adam", 145), ("momentum", 127), ("sgd", 116)):
        t = update[kind]
        rows.append({
            "name": f"fused_update_{kind}",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_update.cu",
            "replaces": f"paddle_tpu/ops/pallas/fused_update.py:{line}",
            "launches": launches_f32[kind] + (o1["adam"] if kind == "adam" else 0),
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
