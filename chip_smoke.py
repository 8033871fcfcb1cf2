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
 5a. the tensor surface's host cost per op (phase 11b-iii's loops) before
     any profiler session;
 5b. serve GPT-2 345M f32 (``max_seq_len=2048``) through ``serving.Engine``
     on bench.py ``bench_serving``'s mix (12 prompts of 32-128 tokens, 24
     new tokens each): a warm serve that captures each prefill and decode
     signature as one CUDA graph, a timed serve (requests/s, tokens/s,
     token latency p50/p99 from the engine's step timings, one graph replay
     per decode step, no re-capture, fallback, drop or leaked block, the
     decode steps' host cost split from their device time); then a
     sustained run of 64 requests of the mix
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
  8. a ``torch.profiler`` trace of one replayed step (phase 7's, built again
     in a process of its own: a session late in a process that traced tens
     of thousands of operations before loses records): the top device
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
 7d. (after 7c) BERT-base pretraining, bench.py ``bench_bert``'s step
     (``BertConfig(max_seq_len=512, dropout=0, attn_dropout=0)``, 8 x 512
     tokens, MLM + NSP, O2 bf16, AdamW through ``compile_train_step``, ids
     and packed labels from numpy's generator seeded 0): two eager steps, the
     capture, 10 timed replays (ms, tokens/s under bench.py's metric name,
     peak memory), against an eager copy, every flash launch the non-causal
     sm90 kernel, 12 of each per step; the same with Lamb, whose first
     update turns the O2 parameters f32 as the JAX package's does (its later
     steps on the tf32x3 route); BertConfig's defaults (dropout and attention
     dropout 0.1) with a padded attention_mask and MLM labels at 15%: the
     dense route, no flash launch, new masks per replay, f32 output; the f32
     eval forward (12 tf32x3 launches) against the dense path; Adamax,
     Adagrad, Adadelta, RMSProp, Lamb and Lars in captured steps of a
     2-layer f32 BERT against eager copies; the three kernels at (8, 512,
     12, 64) non-causal on BERT's qkv views, bf16 and f32, against their
     plain versions and timed beside SDPA and their bounds;
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
 8b. (after 11) a ``torch.profiler`` trace of one replayed BERT step, in a
     process of its own;
 11b. the tensor surface (``paddle.Tensor``, ``to_tensor``, the ``paddle.*``
     functions, Paddle autograd): GPT-2 345M f32 eager Adam steps at 8 x 1024
     tokens written as a Paddle user writes them (ids and labels from
     ``paddle.to_tensor``, ``loss = criterion(model(ids), labels)``,
     ``loss.backward(); opt.step(); opt.clear_grad(); float(loss)``), with
     the fused update on, against the same steps with torch inputs on a second
     model from the same seed: losses, parameters and moments bitwise equal
     over 3 steps, 24 tf32x3 launches of each flash kernel and 292 Adam
     launches per step, then 4 more in turns, timed; the eval forward under
     ``paddle.no_grad()`` (the accuracy expression equal to torch's, nothing
     recorded); ``paddle.grad(loss, logits)`` bitwise ``torch.autograd.grad``.
     Then every function of the CPU op sweep (tests/test_torch_op_sweep.py)
     on the card at the 345M's widths against the port on the CPU, outputs
     and gradients, sort orders on ties; then the host cost per op of four
     surface calls against the bare torch calls;
 12. ``paddle.nn`` and ResNet-50: (12a) BASELINE.json config 2 as bench.py
     ``bench_resnet50`` writes it: ``resnet50(num_classes=1000)`` under
     ``amp.decorate(level="O2", dtype="bfloat16")``, ``Momentum(0.1, 0.9)``,
     ``CrossEntropyLoss`` on ``out.astype("float32")`` through
     ``compile_train_step``, ``paddle.to_tensor`` inputs of 256 x 3 x 224^2
     from ``numpy.random.default_rng(0)``: two eager steps, the capture, 10
     timed replays (ms per replay, images/s under bench.py's metric name
     ``resnet50_amp_o2_imgs_per_sec_per_chip``, peak memory), against an
     eager copy within 1e-2 on the loss; every BN ``_mean`` / ``_variance``
     keeps its ``data_ptr()``, has moved and equals the eager copy's within
     3e-2, and eval mode normalises by them; (12b) f32 eager ResNet-50 at 64
     images with ``FLAGS_pallas_fused_update`` on and off in turns: 161
     Momentum kernel launches per step, losses, parameters, velocities and BN
     statistics bitwise over 3 steps, ``opt.step()`` and step ms; (12c)
     ``TransformerEncoderLayer(768, 12, 3072)`` x 12 and a Linear head at
     8 x 512: O2 AdamW through ``compile_train_step`` with 12 non-causal
     sm90 launches of each flash kernel a step, against an eager copy at
     dropout 0, a dropout-0.1 replay, a bool ``src_mask`` on the dense route,
     the f32 forward's 12 tf32x3 launches against the dense route within
     1e-3; (12d) in a process of its own, a ``torch.profiler`` trace of one
     12a replay by kind and the Momentum rule's ms as a graph of its own;
 13. eager lazy dispatch and whole-step capture (``core/lazy.py``): (13a)
     BASELINE.json config 1 as bench.py ``bench_mnist_eager`` writes it
     (``LeNet()``, ``Adam(1e-3)``, ``CrossEntropyLoss``, 64 x 1 x 28^2 from
     ``default_rng(0)``, ``paddle.to_tensor`` inputs, the plain eager loop)
     per-op, lazy (capture off) and captured, ``FLAGS_pallas_fused_update``
     off and on: 5 steps of each regime bitwise per-op (cuDNN
     deterministic), programs a step (3 lazy, 1 captured), 10 fused Adam
     launches in the captured graph and none through the wrapper on its
     replays, steps/s under ``mnist_lenet_eager_steps_per_sec`` timed as
     bench's ``_timed(median_best=True)``, the host breakdown of bench's
     ``_host_breakdown``, 0 capture fallbacks in every timed window; (13b)
     phase 11b's Paddle-style 345M f32 step under lazy dispatch with capture:
     one graph a step holding 24 tf32x3 launches of each flash kernel and
     292 fused Adam launches, bitwise the per-op steps of a twin model over
     2 warm-up and 3 captured steps, ms a step in turns; (13c) the medium
     PTB LSTM language model (Zaremba, Sutskever and Vinyals 2014, PaddleNLP
     ``examples/language_model/rnnlm``: vocab 10000, 2 x 650 LSTM, 20 x 35
     tokens, SGD(1.0), ``ClipGradByGlobalNorm(5.0)``, uniform init +-0.05,
     random token ids) per-op, lazy and captured with the fused SGD kernel
     once per parameter inside the graph: bitwise per-op at dropout 0, new
     masks each replay at 0.5 (and the same masks after
     ``paddle.set_rng_state``), ms a step and tokens/s;
 14. frozen parameters, O1 casts, ``paddle.linalg``, ``paddle.autograd``'s
     functional API and the serve-probe CLI: (14a) 13b's Paddle-style 345M
     f32 step with ``wte`` and ``wpe`` frozen by ``trainable = False`` (the
     LM head is tied to ``wte``) and blocks 0-11 by ``stop_gradient =
     True``, 5 per-op steps and 2 warm-up + 3 captured steps on twin models:
     frozen parameters bitwise unchanged, the trainable ones (and their
     moments) bitwise equal between the paths, each step 146 fused Adam
     launches, 24 tf32x3 forwards and 12 of each tf32x3 backward kernel (the
     backward stops at block 12), the captured step one program, ms a step
     in turns beside 13b's unfrozen step, peak memory; (14b) inside
     ``auto_cast(level="O1", dtype="bfloat16")`` at 8192 x 1024 by 1024 x
     4096: ``paddle.matmul``, ``@``, ``mm``, ``bmm`` and ``einsum`` of f32
     Tensors give bf16, ``exp``, ``log``, ``mean``, ``sum``, ``Tensor.sum``,
     ``pow``, ``cumsum``, ``square`` and ``norm`` of bf16 Tensors f32, each
     against its f32 result; (14c) every ``paddle.linalg`` function on a
     2048 x 2048 f32 matrix (SPD where needed; ``eig`` and ``eigvals`` at
     1024) and a 256 x 64 x 64 batch, held by its residual and against the
     port on the CPU, timed by CUDA events, its host synchronisations
     listed (torch's sync debug mode); the Jacobian and Hessian of a 2-layer
     MLP loss against the CPU port; (14d) ``python -m
     paddle_tpu_torch.tools.serve_probe`` in a process of its own on the
     card: exit 0 and ``ALL SCENARIOS PASSED``;
 15. the parameter-server tables and BASELINE.json config 5, the ERNIE CTR
     loop, and ``paddle.io``: (15a) the tf32x3 flash forward and backward at
     config 5's attention shape (32, 128, 8, 32), f32, non-causal: against
     their plain versions, a second launch bitwise equal, timed beside SDPA
     f32 and the 3xTF32 bound; (15b) bench.py ``bench_ernie_ctr`` on the
     port's ``examples/ernie_ctr.py`` (``ErnieCtrConfig()``: hidden 256, 4
     layers, 8 heads, seq 128, 16 slots of dim 64, batch 32, Adam 1e-3 dense,
     a ``MemorySparseTable`` with AdaGrad 0.05 in 16 shards): one sync
     ``train_step``, then ``train_pipelined`` over 8 batches, best of 3
     windows, printed as ``ernie_ctr_sparse_ps_tokens_per_sec_per_chip``
     beside the sync loop's tokens/s (the sync loop, the pipelined loop and
     the pipelined loop at a 0.1 ms switch interval of the interpreter lock
     timed in turns) and a sync step split into pull, upload, replay (CUDA
     events), read-back and push; the step is one
     captured graph holding 4 tf32x3 launches of each flash kernel, never
     captured again and launching nothing through a wrapper on a replay;
     every push lands by ``flush()`` and ``len(table)`` is the distinct slot
     ids; the replays' row gradients against eager autograd's; 10 sync steps
     on one batch bring the loss under 0.9 of its first; an SSD-overflow
     table (``ram_budget=64``) spills; a ``torch.profiler`` trace of one
     replay in a process of its own (by kind, 4 launches of each tf32x3
     kernel and none of another route); (15c) ``bench_ps_table`` and
     ``bench_ps_wire`` (65536 keys x 64, 2 local servers over framed TCP,
     the wire's rows equal a local table's of the same seed) under their
     bench.py names with the host's CPU model, and ``SparseEmbedding`` in an
     eager card loop: its block on the card, its pushed rows equal the CPU
     port's, lazy dispatch equal to per-op; (15d) ``bench_dataloader`` (1024
     synthetic 224^2 uint8 images, batch 64, 4 forked workers after CUDA is
     up, ``return_numpy=True``) as ``dataloader_mp_imgs_per_sec``, the same
     loader's card Tensors equal to the single-process loader's, and a
     worker's exception reaching the parent with its traceback. The PS
     libraries are built by g++ in threads while nvcc builds the kernels;
 16. the profiler and the ops plane: (16a) the fused updates' telemetry
     variants against the kernels (updates bitwise, rows within 1e-5 of
     float64 sums and bitwise on a second launch) at every size, gate and
     decay, timed at the embedding's size beside the kernel, the bound, the
     plain version and the library call, and Momentum and SGD with
     FLAGS_telemetry through 2-layer 345M-width steps; (16b) phase 13b's
     Paddle-style 345M f32 step captured whole, twin models with
     FLAGS_telemetry on and off in turns: bitwise, one program a step, 292
     telemetry-variant Adam and 24 tf32x3 launches of each flash kernel in
     the graph, the telemetry against float64, the captured program's static
     profile (top op a matmul, matmul FLOPs within 2% of the analytic count,
     the flash kernels counted) and the planner's peak within 0.5-2x of the
     measured one; (16c, a process of its own) phase 7's O2 bench step with
     telemetry on against off, a Profiler session over it (RecordEvent
     spans, flight events, a counter lane for the captured key, 48 launches
     of each sm90 kernel in the device trace) and its costs; (16d) the
     serving engine on bench_serving's mix with the diagnostics server
     scraped at 10 Hz from a process of its own and the sentinel on, each
     decode program's device ms with scraping against without, then a
     slowed decode that trips
     the sentinel once; (16e) ``tools/obs_probe.py`` on the card;
 17. static analysis and the memory plan: (17a) every analysis pass over
     GPT-2 345M and ResNet-50 with no error; phase 13b's Paddle-style 345M
     f32 step captured whole under FLAGS_check_programs=2, certified
     against a recorded 3-program step before its first replay, its graph
     still 24 tf32x3 launches of each flash kernel and 292 Adam; an injected
     divergence a counted fallback with its diagnostic; each serving
     program's rungs certified once; (17b) bench.py main()'s O2 step with a
     remat plan at a budget halfway between the unplanned and the
     use_recompute peaks: feasible, cheaper than uniform recompute, bitwise
     the unplanned step over 3 steps, 24 sm90 launches of each kernel plus
     one forward per recomputed decoder layer, the planned step's measured
     peak within its budget, the three steps' peaks and replay times in
     turns; (17c) phase 13b's step per-op and captured with the Adam
     moments parked on the host against without, on twin models: bitwise,
     the memory each twin holds at its step's peak (per-op its transient
     peak, captured its graph's pool) lower by most of the parked bytes,
     blocked and step ms; (17d) a serving engine whose KV pool the planner
     sizes from FLAGS_memory_budget_mb: its overhead against the serve's
     measured non-pool memory, and less the inputs against the decode
     program run at the planned geometry, bench_serving's mix, requests waiting for
     blocks, the "no room" error; a default engine sized from the card's
     free memory serves the mix, and half the headroom is allocated beside
     it; (17e) ``python -m paddle_tpu_torch.tools.graph_lint`` and
     ``.mem_probe`` in processes of their own;
 18. multi-GPU, part one, the ranks processes of their own started by
     ``paddle_tpu_torch.distributed.launch`` on the one card (NCCL refuses
     two ranks on one card: the launcher's refusal is checked first): the
     flash kernels at a rank's shape (2, 1024, 8, 64), causal, sm90 bf16 and
     tf32x3 f32, against their plain versions and timed; (18a) world 1 under
     NCCL, every collective on card tensors; 4 ranks over gloo
     with card tensors, each collective against numpy, which of them gloo
     takes on card tensors itself, each one's ms at 64 MB; (18b) GPT-2 345M
     at full width as dp2 x mp2 x sharding2 (ZeRO-2), O2 bf16, AdamW, global
     batch 8 x 1024 through ``fleet.distributed_train_step``, 8 ranks over
     gloo: losses within 3e-2 of phase 7's single-card step, 24 sm90
     launches of each flash kernel a step per rank at (2, 1024, 8, 64), every
     parameter a group replicates bitwise equal across it after each step
     (also at hidden and attention dropout 0.1, where the attention is dense
     and its masks come from one stream per mp rank), half of each moment
     per rank, ms a step split into compute and collectives, peak memory;
     (18c) f32 at full width and 4 layers, the same hybrid and ZeRO-3
     (sharding 4 x mp 2), losses, every gathered parameter and each rank's
     moment shards within rtol 1e-4 and atol 1e-5 of the single-card step,
     ZeRO-3 parameters at rest a quarter of their mp
     shard; (18d) world 1 under NCCL through ``fleet``, bench.py main()'s O2
     step, bitwise an eager ``compile_train_step`` copy;
 19. one JSON line of per-kernel numbers, the script's time, then the
     result line.

It needs CUDA and the repository around it; without either it exits non-zero
and prints no result. It imports nothing of JAX or of ``paddle_tpu``.

    python3 chip_smoke.py --tf32-repeat N

runs only the tf32x3 forward's repeat witness: N fresh processes, each
comparing its first two launches bit for bit, then one process under each of
compute-sanitizer's racecheck, synccheck and initcheck where the toolkit has
it and the card is supported.

    python3 chip_smoke.py --eager-dispatch

runs only phase 13, after building the libraries its paths launch.

    python3 chip_smoke.py --phase14

runs only phase 14, after building the libraries its paths launch.

    python3 chip_smoke.py --phase15

runs only phase 15, after building the libraries its paths launch.

    python3 chip_smoke.py --phase16

runs only phase 16, after building the libraries its paths launch.

    python3 chip_smoke.py --phase17

runs only phase 17, after building the libraries its paths launch.

    python3 chip_smoke.py --phase18

runs only phase 18, after building the libraries its paths launch (its 18b
reference is then bench.py main()'s O2 step run for it).

    python3 chip_smoke.py --host-cost-vs DIR

times the per-op path's host cost (phase 5a's four ops and 13a's per-op
LeNet step) of the port checked out at DIR (an unpacked ``git archive`` of
another commit) and of this one, in turns, each in a fresh process.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import types
import warnings

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
# 5b's sustained run: the queue for blocks forms within its first ticks, as 8
# rows a decode step serve fewer than the 0.7 arrivals a tick bring
SUSTAINED_REQUESTS, SUSTAINED_ARRIVALS_PER_TICK, SUSTAINED_BLOCKS = 64, 0.7, 96


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
        # the pool of earlier runs: a default engine on the card is sized
        # from the card's memory by the planner since phase 17
        kw.setdefault("num_blocks", 256)
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
        # the pool of earlier runs: a default engine on the card is sized
        # from the card's memory by the planner since phase 17
        kw.setdefault("num_blocks", 256)
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
                                     max_new_tokens=n_new, num_blocks=256)
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
    copy. Returns the launches of each flash kernel over the training path
    and its numbers."""
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
            "peak_gb": mem_gb - held_gb, "first_losses": values[:P18_STEPS],
            "ids": ids.cpu().numpy()}


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
    held_gb = torch.cuda.memory_allocated(dev) / 1e9  # what earlier phases still hold
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


# Phase 7d: BERT-base pretraining, BASELINE.json config 3, as bench.py
# bench_bert times it: BertConfig(max_seq_len=512, dropout=0, attn_dropout=0),
# 8 x 512 tokens, MLM + NSP, AMP O2 bf16, AdamW(lr 1e-4) through
# compile_train_step. Its attention takes the flash route, non-causal: the
# first model path through the non-causal kernels.
BERT_BATCH = 8
BERT_CFG = dict(max_seq_len=512)  # BertConfig's defaults are BERT-base's widths
BERT_SHAPE = (8, 512, 12, 64)  # the step's attention: batch, seq, heads, head dim
BERT_REPLAYS = 10
# the padded batch of the masked step: row lengths drawn in [128, 512], MLM
# labels at 15% of the real tokens
BERT_MIN_LEN = 128
BERT_MLM_SHARE = 0.15
# The six optimizers without a fused kernel, on a 2-layer f32 BERT at 4 x 128
# tokens: eager copy against captured steps. Both run the same kernels on the
# same data in the same order; the tolerance admits a library matmul picking
# another algorithm inside the graph (f32, ~1e-7 relative on losses ~10 and
# parameters ~1), and a wrong or host-read rule moves parameters by ~lr.
BERT_OPT_CFG = dict(max_seq_len=128, num_layers=2, dropout=0.0, attn_dropout=0.0)
BERT_OPT_BATCH = 4
BERT_OPTIMIZERS = [  # (name, keyword arguments besides the parameters): each at an lr
    # that moves the weights by ~1e-3 a step
    ("Adamax", {"learning_rate": 1e-3}), ("Adagrad", {"learning_rate": 1e-2}),
    ("Adadelta", {"learning_rate": 1.0}),
    ("RMSProp", {"learning_rate": 1e-3, "momentum": 0.9, "centered": True}),
    ("Lamb", {"learning_rate": 1e-3}),
    ("Lars", {"learning_rate": 1.0, "lars_coeff": 0.01}),
]
TOL_OPT_REPLAY = 1e-5


@contextlib.contextmanager
def flash_launch_log(fa):
    """Every flash kernel launch while active, as (kernel, route, causal):
    the private launchers the wrappers call are wrapped for the duration."""
    log, saved = [], {}
    for attr, kernel in (("_fwd_cuda", "fwd"), ("_bwd_dkv_cuda", "dkv"),
                         ("_bwd_dq_cuda", "dq")):
        saved[attr] = fn = getattr(fa, attr)

        def spy(*args, _fn=fn, _kernel=kernel):
            log.append((_kernel, args[-1], bool(args[-2])))  # (..., causal, route)
            return _fn(*args)

        setattr(fa, attr, spy)
    try:
        yield log
    finally:
        for attr, fn in saved.items():
            setattr(fa, attr, fn)


def bert_batch(torch, cfg, batch, dev):
    """bench.py bench_bert's batch: ids, and ``packed`` = MLM labels then the
    NSP label per row, from numpy's generator seeded 0 (bench.py:173-179)."""
    import numpy as np

    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq_len))
    packed = np.concatenate([rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq_len)),
                             rng.integers(0, 2, (batch, 1))], axis=1)
    return torch.as_tensor(ids).to(dev), torch.as_tensor(packed).to(dev)


def bert_loss_fn(crit, masked=False):
    """bench.py bench_bert's loss over f32 logits; ``masked``: the mean over
    the positions whose label is not -100 (``mlm_mask``)."""

    def loss_fn(out, packed):
        mlm, nsp = out
        labels = packed[:, :-1]
        mask = (labels != -100).float() if masked else None
        return crit(mlm.float(), nsp.float(), labels, packed[:, -1], mask)

    return loss_fn


def bert_step_launches(torch, fa, fn, n, route, what, kernels=tuple(FLASH_WRAPPERS)):
    """Run ``fn``; check it launched each of ``kernels`` (the forward, dK/dV
    and dQ) ``n`` times, all on ``route`` (none at all when ``route`` is
    None) and none causal. Returns fn's result."""
    before = flash_counts(fa)
    with flash_launch_log(fa) as log:
        out = fn()
        torch.cuda.synchronize()
    got = {k: c - before[k] for k, c in flash_counts(fa).items() if c != before[k]}
    want = {} if route is None else {f"{k}_{route}": n for k in kernels}
    causal = sum(c for _, _, c in log)
    print(f"  {what}: flash launches {got}, {causal} causal")
    check(got == want and causal == 0, f"{what}: flash launches {got} ({causal} causal), "
                                       f"expected {want}, none causal")
    return out


def bert_train_step(torch, pt, fa, dev, opt_name, routes):
    """Phase 7d, steps 1-2: bench_bert's step through compile_train_step with
    ``opt_name``: two eager steps, the capture, BERT_REPLAYS timed replays,
    against an eager copy stepped with ``loss.backward(); opt.step()``.
    ``routes``: the flash route of the eager steps and the capture, in
    order. Returns its numbers."""
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              BertPretrainingCriterion)

    cfg = BertConfig(**BERT_CFG, dropout=0.0, attn_dropout=0.0)
    print(f"[7d] BERT-base pretraining step (bench.py bench_bert), {BERT_BATCH} x "
          f"{cfg.max_seq_len} tokens, MLM + NSP, AMP O2 bf16, {opt_name}(lr 1e-4), one CUDA "
          f"graph")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    pt.seed(SEED)
    model = BertForPretraining(cfg, device=dev)
    eager = copy.deepcopy(model)  # before decorate: the wrapped forward is per model
    model = pt.amp.decorate(model, level="O2", dtype="bfloat16")
    eager = pt.amp.decorate(eager, level="O2", dtype="bfloat16")
    loss_fn = bert_loss_fn(BertPretrainingCriterion())
    make = getattr(pt.optimizer, opt_name)
    opt = make(learning_rate=1e-4, parameters=model.parameters())
    opt_e = make(learning_rate=1e-4, parameters=eager.parameters())
    step = pt.jit.compile_train_step(model, loss_fn, opt)
    ids, packed = bert_batch(torch, cfg, BERT_BATCH, dev)
    n = cfg.num_layers
    losses = []
    for i, route in enumerate(routes):
        what = ("capture + first replay" if i == pt.jit.WARMUP_STEPS
                else f"eager warm-up step {i}") + f" ({next(model.parameters()).dtype})"
        t0 = time.perf_counter()
        losses.append(bert_step_launches(torch, fa, lambda: step(ids, packed), n, route, what))
        print(f"    {time.perf_counter() - t0:.2f} s")
    (entry,) = step._captured.values()
    check(entry.graph is not None, "the BERT step was not captured")
    before = flash_counts(fa)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(BERT_REPLAYS):
        losses.append(step(ids, packed))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / BERT_REPLAYS
    step_ms = start.elapsed_time(end) / BERT_REPLAYS
    check(flash_counts(fa) == before, "the replays did not run the captured graph")
    tokens = BERT_BATCH * cfg.max_seq_len
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 - held_gb
    print(f"  {BERT_REPLAYS} replays: step {step_ms:.3f} ms (CUDA events), {host_ms:.3f} ms "
          f"(host clock); bert_base_pretrain_tokens_per_sec_per_chip "
          f"{tokens / step_ms * 1e3:.1f}; peak memory allocated {peak_gb:.2f} GB above the "
          f"{held_gb:.2f} GB held before")
    values = [float(v) for v in losses]
    print("  losses: " + " ".join(f"{v:.4f}" for v in values))
    check(all(math.isfinite(v) for v in values), "non-finite BERT loss")
    check(values[-1] < values[0], "the BERT loss does not fall on a fixed batch")
    def eager_step():
        loss = loss_fn(eager(ids), packed)
        loss.backward()
        opt_e.step()
        opt_e.clear_grad()
        return loss.detach()

    # the eager copy's first steps on the compiled step's routes, then the rest
    eager_values = [bert_step_launches(torch, fa, eager_step, n, route, f"eager copy, step {i}")
                    for i, route in enumerate(routes)]
    eager_values += [eager_step() for _ in range(len(values) - len(routes))]
    eager_values = [float(v) for v in eager_values]
    diff = max(abs(a - c) for a, c in zip(values, eager_values))
    print(f"  eager copy (loss.backward(); opt.step(); opt.clear_grad()) vs graph: "
          f"max|d loss|={diff:.3e} over {len(values)} steps, bitwise equal: "
          f"{values == eager_values}, tol={TOL_EAGER_VS_GRAPH:g}")
    check(diff <= TOL_EAGER_VS_GRAPH, f"BERT {opt_name}: the eager copy and the replays "
                                      f"disagree")
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    print(f"  parameter dtypes after the steps: {dtypes}")
    del eager, opt_e
    return {"step_ms": step_ms, "host_ms": host_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_gb": peak_gb, "losses": values, "dtypes": dtypes}


def bert_masked_step(torch, pt, fa, dev, unmasked_ms):
    """Phase 7d, step 3: the step as Paddle users configure BERT: BertConfig's
    dropout 0.1 and attention dropout 0.1, a padded attention_mask, MLM labels
    at 15% of the real tokens with ``mlm_mask``, token types. The dense
    attention route (a mask and attention dropout): no flash launch. Returns
    its numbers."""
    import numpy as np

    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              BertPretrainingCriterion)

    cfg = BertConfig(**BERT_CFG)
    print(f"[7d] BERT-base step as configured by default: dropout {cfg.dropout}, attention "
          f"dropout {cfg.attn_dropout}, padded attention_mask (rows of {BERT_MIN_LEN}-"
          f"{cfg.max_seq_len} tokens), MLM labels at {BERT_MLM_SHARE:.0%} with mlm_mask, O2 "
          f"bf16, AdamW")
    rng = np.random.default_rng(1)
    b, s = BERT_BATCH, cfg.max_seq_len
    lengths = rng.integers(BERT_MIN_LEN, s + 1, b)
    pos = np.arange(s)[None, :]
    mask = (pos < lengths[:, None]).astype(np.int64)
    types = ((pos >= lengths[:, None] // 2) & (mask == 1)).astype(np.int64)  # sentence B
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    chosen = (rng.random((b, s)) < BERT_MLM_SHARE) & (mask == 1)
    labels = np.full((b, s), -100)
    labels[chosen] = rng.integers(0, cfg.vocab_size, int(chosen.sum()))
    packed = np.concatenate([labels, rng.integers(0, 2, (b, 1))], axis=1)
    batch = [torch.as_tensor(a).to(dev) for a in (ids, types, mask, packed)]
    pt.seed(SEED)
    model = pt.amp.decorate(BertForPretraining(cfg, device=dev), level="O2", dtype="bfloat16")
    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = pt.jit.compile_train_step(model, bert_loss_fn(BertPretrainingCriterion(), True), opt)
    losses = []
    for i in range(pt.jit.WARMUP_STEPS + 1):
        what = "capture + first replay" if i == pt.jit.WARMUP_STEPS else f"eager step {i}"
        losses.append(bert_step_launches(torch, fa, lambda: step(*batch), 0, None, what))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(BERT_REPLAYS):
        losses.append(step(*batch))
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / BERT_REPLAYS
    values = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in values), "non-finite masked BERT loss")
    with torch.no_grad():
        mlm, nsp = model(*batch[:3])
    print(f"  {BERT_REPLAYS} replays: step {step_ms:.3f} ms (CUDA events), "
          f"{b * s / step_ms * 1e3:.1f} tokens/s ({int(mask.sum())} of {b * s} positions real, "
          f"{int(chosen.sum())} MLM labels); {step_ms / unmasked_ms:.2f}x the unmasked "
          f"dropout-0 step's {unmasked_ms:.3f} ms; output dtypes {mlm.dtype}, {nsp.dtype}")
    print("  losses: " + " ".join(f"{v:.4f}" for v in values))
    check(mlm.dtype == nsp.dtype == torch.float32,
          "the masked O2 forward's output is not f32, as the JAX model's is")
    opt.set_lr(0.0)  # the parameters stay, so only the dropout masks move the loss
    a, c = float(step(*batch)), float(step(*batch))
    print(f"  two replays at lr 0: {a:.6f} {c:.6f}")
    check(a != c, "two masked BERT replays drew the same dropout masks")
    del step, model, opt, mlm, nsp
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "losses": values}


def bert_eval_forward(torch, pt, fa, dev):
    """Phase 7d, step 4: the f32 eval forward of BertForPretraining, unmasked:
    the tf32x3 forward once per layer, against the dense path."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

    cfg = BertConfig(**BERT_CFG)
    print(f"[7d] BERT-base f32 eval forward, {BERT_BATCH} x {cfg.max_seq_len} tokens")
    pt.seed(SEED)
    model = BertForPretraining(cfg, device=dev).eval()
    ids, _ = bert_batch(torch, cfg, BERT_BATCH, dev)
    with torch.no_grad():
        mlm, nsp = bert_step_launches(torch, fa, lambda: model(ids), cfg.num_layers, "tf32x3",
                                      "one f32 forward", kernels=("fwd",))
        fwd_ms = time_ms(lambda: model(ids), reps=5, warmup=1)
        pt.set_flags({"FLAGS_use_flash_attention": False})
        try:
            d_mlm, d_nsp = bert_step_launches(torch, fa, lambda: model(ids), 0, None,
                                              "the dense path")
        finally:
            pt.set_flags({"FLAGS_use_flash_attention": True})
    err = max((mlm - d_mlm).abs().max().item(), (nsp - d_nsp).abs().max().item())
    print(f"  {fwd_ms:.3f} ms, {BERT_BATCH * cfg.max_seq_len / fwd_ms * 1e3:.1f} tokens/s; "
          f"flash vs dense logits: max|d|={err:.3e} tol={TOL_LOGITS:g} "
          f"(max|logit|={mlm.abs().max().item():.3f})")
    check(err <= TOL_LOGITS, "BERT's flash and dense logits disagree")
    del model, mlm, nsp, d_mlm, d_nsp
    return {"fwd_ms": fwd_ms, "err": err}


def bert_new_optimizers(torch, pt, fa, dev):
    """Phase 7d, step 5: each optimizer without a fused kernel through
    compile_train_step (two eager steps, the capture, two replays) on a
    2-layer f32 BERT, against an eager copy stepped beside it."""
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              BertPretrainingCriterion)

    cfg = BertConfig(**BERT_OPT_CFG)
    print(f"[7d] the six optimizers without a fused kernel in a captured step: "
          f"{cfg.num_layers}-layer f32 BERT-base, {BERT_OPT_BATCH} x {cfg.max_seq_len} tokens")
    ids, packed = bert_batch(torch, cfg, BERT_OPT_BATCH, dev)
    # token types, so that every parameter has a gradient: the compiled step
    # updates an unused one from a zero gradient (as jax.grad gives it), the
    # eager step() skips it, and decay moves it
    types = (torch.arange(cfg.max_seq_len, device=dev) >= cfg.max_seq_len // 2).long()
    types = types.expand(BERT_OPT_BATCH, -1)
    loss_fn = bert_loss_fn(BertPretrainingCriterion())
    out = {}
    for name, kw in BERT_OPTIMIZERS:
        pt.seed(SEED)
        model = BertForPretraining(cfg, device=dev)
        eager = copy.deepcopy(model)
        initial = [p.detach().clone() for p in model.parameters()]
        make = getattr(pt.optimizer, name)
        opt = make(parameters=model.parameters(), **kw)
        opt_e = make(parameters=eager.parameters(), **kw)
        step = pt.jit.compile_train_step(model, loss_fn, opt)
        d_loss = 0.0
        for _ in range(pt.jit.WARMUP_STEPS + 3):
            loss = step(ids, types, packed)
            ref = loss_fn(eager(ids, types), packed)
            ref.backward()
            opt_e.step()
            opt_e.clear_grad()
            d_loss = max(d_loss, abs(loss.item() - ref.item()))
        (entry,) = step._captured.values()
        check(entry.graph is not None, f"{name}: the step was not captured")
        d_param = max((p - q).abs().max().item()
                      for p, q in zip(model.parameters(), eager.parameters()))
        moved = max((p - q).abs().max().item()
                    for p, q in zip(model.parameters(), initial))
        out[name] = (d_loss, d_param)
        print(f"  {name}: eager vs captured over {pt.jit.WARMUP_STEPS + 3} steps: "
              f"max|d loss|={d_loss:.3e}, max|d param|={d_param:.3e} tol={TOL_OPT_REPLAY:g} "
              f"(the steps moved a parameter by up to {moved:.3e}); last loss "
              f"{loss.item():.4f}")
        check(d_loss <= TOL_OPT_REPLAY and d_param <= TOL_OPT_REPLAY,
              f"{name}: the captured steps and the eager copy disagree")
        check(moved > TOL_OPT_REPLAY, f"{name}: the steps left the parameters where they were")
        del step, model, eager, opt, opt_e, entry
    torch.cuda.empty_cache()
    return out


def bert_noncausal_kernels(torch, fa, gen, dev):
    """Phase 7d, step 6: the three flash kernels at BERT_SHAPE, non-causal,
    on BERT's projection-major qkv views ([b, s, 3, h, d])."""
    b, s, h, d = BERT_SHAPE
    print(f"[7d] the flash kernels at BERT's shape {BERT_SHAPE}, non-causal, on [b, s, 3, h, d] "
          f"qkv views")

    def views(dtype):
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev).to(dtype)
        return qkv.unbind(dim=2)

    return flash_kernels_at(torch, fa, gen, dev, BERT_SHAPE, False, views, "BERT's")


def flash_kernels_at(torch, fa, gen, dev, shape, causal, make_qkv, what, routes=None):
    """The three flash kernels at ``shape`` on each (dtype, route) of
    ``routes`` (bf16 on sm90 and f32 on tf32x3 when None), q, k and v from
    ``make_qkv(dtype)``: each against its plain version, a second launch
    bitwise equal, and the kernel, plain and SDPA times beside the bound.
    Returns {dtype: {kernel: numbers}}."""
    b, s, h, d = shape
    out = {}
    for dtype, route in routes or ((torch.bfloat16, "sm90"), (torch.float32, "tf32x3")):
        dname = dtype_name(dtype)
        q, k, v = make_qkv(dtype)
        do = torch.randn(shape, generator=gen, device=dev).to(dtype)
        check(route_of(fa, (q, k, v)) == route_of(fa, (q, k, v, do)) == route,
              f"{what} {dname} q, k, v do not take the {route} route")
        scale = d ** -0.5
        with flash_launch_log(fa) as log:
            o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
            o2, lse2 = fa.flash_attention_fwd(q, k, v, scale, causal)
            delta = fa.bwd_delta(o, do)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
            dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
            dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
        check(len(log) == 6 and all(r == route and c == causal for _, r, c in log),
              f"{what} kernels at {dname} launched {log}")
        o_p, lse_p = fa.fwd_plain(q, k, v, scale, causal)
        ref = fa.bwd_plain(q, k, v, do, lse, delta, scale, causal)
        torch.cuda.synchronize()
        err_fwd = max((o.float() - o_p.float()).abs().max().item(),
                      (lse - lse_p).abs().max().item())
        err_dq = (dq.float() - ref[0].float()).abs().max().item()
        err_dkv = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip((dk, dv), ref[1:]))
        bitwise = (torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(dk, dk2)
                   and torch.equal(dv, dv2) and torch.equal(dq, dq2))
        print(f"  {dname} ({route}): max|d O, lse|={err_fwd:.3e} tol={TOL[dname]:g}; "
              f"max|d dK, dV|={err_dkv:.3e} max|d dQ|={err_dq:.3e} tol={GRAD_TOL[dname]:g}; "
              f"second launches bitwise equal: {bitwise}")
        check(err_fwd <= TOL[dname] and max(err_dkv, err_dq) <= GRAD_TOL[dname],
              f"{what} {dname} kernels disagree with their plain versions")
        check(bitwise, f"{what} {dname} kernels are not bitwise equal on a second launch")
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
        o_lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                                                 is_causal=causal)
        do_t = do.transpose(1, 2)
        fwd = dict(max_abs_err=err_fwd, route=route,
                   ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale, causal)),
                   plain_ms=time_ms(lambda: fa.fwd_plain(q, k, v, scale, causal), reps=10),
                   library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, scale=scale, is_causal=causal)))
        fwd.update(attention_bound_ms(b, s, h, d, dname, causal))
        plain_bwd = time_ms(lambda: fa.bwd_plain(q, k, v, do, lse, delta, scale, causal),
                            reps=10)
        library_bwd = time_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t,
                                                          retain_graph=True))
        dkv = dict(max_abs_err=err_dkv, route=route, plain_ms=plain_bwd, library_ms=library_bwd,
                   ms=time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                                                 causal)))
        dkv.update(bwd_bound_ms("dkv", b, s, h, d, dname, causal))
        dq_t = dict(max_abs_err=err_dq, route=route, plain_ms=plain_bwd, library_ms=None,
                    ms=time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                                                 causal)))
        dq_t.update(bwd_bound_ms("dq", b, s, h, d, dname, causal))
        pair_ms = time_ms(lambda: (fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                                              causal),
                                   fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                                             causal)))
        for name, t in (("fwd", fwd), ("dkv", dkv), ("dq", dq_t)):
            print(f"  {dname} {name}: kernel_ms={t['ms']:.4f} ({route}) plain_ms="
                  f"{t['plain_ms']:.4f} {bound_text(t)}; kernel at "
                  f"{t['bound_ms'] / t['ms']:.1%} of bound")
            check_share(f"{what} {name} {dname}", t["bound_ms"], t["ms"])
        sdpa = f"SDPA forward (is_causal={causal})"
        print(f"  {dname}: {sdpa} {fwd['library_ms']:.4f} ms, "
              f"{route} / SDPA {fwd['ms'] / fwd['library_ms']:.2f}x; the {route} pair dK/dV + "
              f"dQ {pair_ms:.4f} ms against SDPA's backward (all three gradients) "
              f"{library_bwd:.4f} ms, {pair_ms / library_bwd:.2f}x")
        out[dname] = {"fwd": fwd, "dkv": dkv, "dq": dq_t, "pair_ms": pair_ms}
        del qt, kt, vt, o_lib
    return out


def bert_pretraining(torch, pt, fa, gen, dev):
    """Phase 7d: BERT-base pretraining. Returns its numbers and the flash
    launches of its path (the steps, the eval forward and the optimizers'
    steps; the kernels' comparisons after it count none)."""
    reset_flash_counts(fa)  # the BERT path's count starts here
    warm = pt.jit.WARMUP_STEPS
    adamw = bert_train_step(torch, pt, fa, dev, "AdamW", ["sm90"] * (warm + 1))
    # JAX's Lamb under O2: the f32 bias corrections turn the parameters f32 at
    # the first update, so the later steps run in f32, on the tf32x3 route
    lamb = bert_train_step(torch, pt, fa, dev, "Lamb", ["sm90"] + ["tf32x3"] * warm)
    print(f"  Lamb's step {lamb['step_ms']:.3f} ms (f32 from the second step, as the JAX "
          f"package's) beside AdamW's {adamw['step_ms']:.3f} ms (bf16)")
    check(lamb["dtypes"] == ["torch.float32"], "Lamb's O2 parameters did not turn f32 as the "
                                               "JAX package's do")
    torch.cuda.empty_cache()
    masked = bert_masked_step(torch, pt, fa, dev, adamw["step_ms"])
    evalf = bert_eval_forward(torch, pt, fa, dev)
    optimizers = bert_new_optimizers(torch, pt, fa, dev)
    launches = flash_counts(fa)  # ... and ends here
    print(f"  flash launches over the BERT path: {launches}")
    kernels = bert_noncausal_kernels(torch, fa, gen, dev)
    return {"adamw": adamw, "lamb": lamb, "masked": masked, "eval": evalf,
            "optimizers": optimizers, "launches": launches, "kernels": kernels}


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


def kind_of(name, kinds):
    """The first of ``kinds`` (``(kind, pattern)`` pairs) whose pattern a
    device operation's name matches, else "other"."""
    return next((k for k, pattern in kinds if re.search(pattern, name)), "other")


def print_trace(label, n_ops, window, busy, wall_ms, by_name, kinds=None):
    """The top device operations and the operations by ``kinds`` (OP_KINDS
    unless given); returns the kinds as {kind: (ms, count)}."""
    print(f"  {n_ops} device operations over {window / 1e3:.2f} ms of device time "
          f"({wall_ms:.2f} ms host clock, profiler on); device idle share "
          f"{1 - busy / window:.1%} of that window")
    print(f"  top device operations by time{label}:")
    for name, (total, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {total / 1e3:8.3f} ms {total / window:6.1%} x{n:<5d} {name[:110]}")
    groups = {}  # kind of device operation -> (ms, count)
    for name, (total, n) in by_name.items():
        kind = kind_of(name, kinds or OP_KINDS)
        ms, count = groups.get(kind, (0.0, 0))
        groups[kind] = (ms + total / 1e3, count + n)
    print("  by kind: " + "; ".join(
        f"{k} {ms:.2f} ms ({ms * 1e3 / window:.1%}, x{n})"
        for k, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    return groups


def profile_replay(torch, step, batch, n_layers, title="[8] torch.profiler trace of one "
                                                      "replayed step", route="sm90"):
    """Phase 8 (and 8b, BERT's; 15b's, ERNIE's): a torch.profiler trace of one
    replayed step."""
    print(title)
    n_ops, window, busy, wall_ms, by_name = device_trace(torch, lambda: step(*batch))
    print_trace("", n_ops, window, busy, wall_ms, by_name)
    # the step runs the forward, dK/dV and dQ kernels of ``route``, each once
    # per layer, and no flash kernel of another route
    for label, pattern, kernel_route in (("fwd_sm90", r"::fwd_sm90_kernel<", "sm90"),
                                         ("dkv_sm90", r"::dkv_sm90_kernel<", "sm90"),
                                         ("dq_sm90", r"::dq_sm90_kernel<", "sm90"),
                                         ("fwd (SIMT)", r"::fwd_kernel<", "simt"),
                                         ("fwd (tf32x3)", r"::fwd_tf32_kernel<", "tf32x3"),
                                         ("dkv (SIMT)", r"::dkv_kernel<", "simt"),
                                         ("dq (SIMT)", r"::dq_kernel<", "simt"),
                                         ("dkv (tf32x3)", r"::dkv_tf32_kernel<", "tf32x3"),
                                         ("dq (tf32x3)", r"::dq_tf32_kernel<", "tf32x3")):
        want = n_layers if kernel_route == route else 0
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
    to the bit (a frozen parameter has no state in either)."""
    for a, b in zip(model_a.parameters(), model_b.parameters()):
        if not torch.equal(a, b):
            return False
        sa, sb = opt_a._accumulators.get(id(a), {}), opt_b._accumulators.get(id(b), {})
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


# ---------------------------------------------------------------------------
# Phase 11b: the tensor surface (paddle.Tensor, to_tensor, the paddle.*
# functions, Paddle autograd) on the card
# ---------------------------------------------------------------------------
SURFACE_STEPS = 3  # Paddle-style steps held bitwise against the torch-input steps
SURFACE_TIMED = 8  # steps timed after them, in turns (surface, torch, torch, surface)
HOST_COST_CALLS = 10_000

# The card sweep runs the case table of tests/torch_surface_cases.py (the CPU
# parity test's own) at GPT-2 345M's widths over fewer tokens (its CARD_345M):
# activations of 8 x 128 tokens x 1024 hidden (1M elements) for the
# elementwise, reduction, logic and manipulation functions; 1024 x 1024
# weights and the (16 heads, 128 tokens, 64) attention operands for the
# products; rows of the 50304-word vocabulary for the search functions.
#
# Each case's outputs and gradients on the card are compared with the
# port's own CPU result on the same inputs. Integer, bool
# and index outputs exact. Floats, |card - cpu| <= atol + rtol * |cpu|:
#   elem   elementwise math: libdevice and ATen's CPU functions differ by
#          a few ulps (1e-5 is ~80 ulps of f32);
#   reduce sums, means, norms, std over up to 1M elements and cumulative
#          sums over 128-1024: the card reduces in a tree, the CPU in another
#          order (f32 error ~ eps * sqrt(n) * scale, ~7e-5 of a sum of
#          1M unit values);
#   prod   the product of all 1M factors in (0.999, 1.001), and its gradient
#          (w * product / x): each level of the card's tree rounds products
#          of factors near 1 onto f32's grid (6e-8 below 1, 1.2e-7 above),
#          and the roundings do not cancel as a random walk's would (sqrt(n)
#          eps ~ 3.5e-4 at 8M factors): 1.5e-2 absolute seen against the CPU's sequential
#          product, on a product of order 1 (the logs of its factors sum to
#          ~N(0, 1.7)) at 8M factors; at 1M the log-sum is ~N(0, 0.6) and
#          the tree is three levels shallower, so the bound keeps its room;
#   scan   cumulative products and logcumsumexp over 1024 steps, and their
#          gradients (reverse sums over 1024): the rounding of each step
#          compounds (~1024 eps of values up to ~30);
#   flatscan prefix sums over all 1M elements of the flattened input, and
#          their reverse for the gradient: the partial sums reach ~1.5e3
#          (~4e3 at 8M), where f32's grid is 1.2e-4 (2.4e-4 to 4.9e-4 at
#          8M), and the card adds each block's prefix in f32 where the CPU
#          accumulates in double;
#   matmul products over K = 1024 with TF32 off: FMA order of cuBLAS and
#          the CPU BLAS, ~sqrt(K) eps of terms ~30 (4e-4 seen at 5 sigma);
#   atomic index_add, scatter_nd_add, put_along_axis(reduce="add"),
#          scatter(overwrite=False), bincount and histogram sum through
#          atomics on the card, in no fixed order: up to ~8K terms a bin
#          (bincount's weights), 9e-4 seen on sums of ~90;
#   special lgamma, digamma and the Bessel functions: libdevice's and ATen's
#          series differ most near the functions' zeros, where a relative
#          bound means nothing (~2e-6 absolute seen);
# A case names one kind, or "out/grad": its outputs under the first, its
# gradients under the second (the gradient of a broadcast is a reduction).
# The bounds were set at 8 x 1024 tokens (8M elements); every error they
# cover grows with the count of terms, so none is loosened by the 8x fewer,
# and the sweep prints each kind's worst share of its bound.
SURFACE_TOL = {"elem": (1e-5, 1e-6), "reduce": (1e-4, 1e-4), "prod": (2e-2, 1e-4),
               "scan": (1e-3, 1e-3), "flatscan": (1e-4, 2e-2), "matmul": (1e-4, 1e-3),
               "atomic": (1e-4, 1e-3), "special": (1e-5, 1e-5)}


def surface_flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in surface_flat(o)]
    return [out]


def surface_differ(a, b, kind):
    """``(why, share)``: why numpy arrays ``a`` (card) and ``b`` (CPU) disagree
    under ``kind``'s tolerance (None when they agree), and the largest
    ``|a - b|`` as a share of its bound (0 for exact outputs)."""
    import numpy as np

    if a.shape != b.shape or a.dtype != b.dtype:
        return f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}", 0.0
    if a.dtype.kind not in "fc":
        bad = int((a != b).sum())
        return (f"{bad} of {a.size} differ (exact)" if bad else None), 0.0
    rtol, atol = SURFACE_TOL[kind]
    a64, b64 = a.astype(np.complex128 if a.dtype.kind == "c" else np.float64), b.astype(
        np.complex128 if b.dtype.kind == "c" else np.float64)
    nan = np.isnan(a64) | np.isnan(b64)
    if (np.isnan(a64) != np.isnan(b64)).any():
        return "NaN at different places", 0.0
    diff = np.where(nan, 0, np.abs(a64 - b64))
    limit = atol + rtol * np.abs(np.where(nan, 0, b64))
    share = float((diff / limit).max()) if diff.size else 0.0
    bad = int((diff > limit).sum())
    return (f"{bad} of {a.size} beyond rtol {rtol:g} atol {atol:g}, max|d| {diff.max():.3e}"
            if bad else None), share


def surface_sweep(torch, pt, dev):
    """Phase 11b-ii: every case of tests/torch_surface_cases.py on the card and
    on the CPU through the port on the same inputs, at the 345M's widths over
    8 x 128 tokens (its ``CARD_345M``);
    outputs, dtypes, shapes, stop_gradient and the gradients of the
    differentiable ones compared. Returns the failures (printed)."""
    import numpy as np
    from tests import torch_surface_cases as surface_cases

    cases = surface_cases.CASES
    arrays = surface_cases.inputs(surface_cases.CARD_345M, SEED)
    places = {"cpu": (pt.CPUPlace(), "cpu"), "card": (pt.CUDAPlace(dev.index or 0),
                                                    f"gpu:{dev.index or 0}")}
    failures, checked, worst = [], 0, {}
    previous = pt.get_device()
    t0 = time.perf_counter()
    for name, fn, specs, diff, kind in cases:
        res = {}
        for where, (place, device) in places.items():
            pt.set_device(device)
            xs = [pt.to_tensor(arrays[s], place=place,
                               stop_gradient=not (diff and arrays[s].dtype.kind == "f"))
                  for s in specs]
            try:
                outs = surface_flat(fn(pt, *xs))
                grads = []
                if diff:
                    wrt = [x for x in xs if not x.stop_gradient]
                    loss = None
                    for k, o in enumerate(o for o in outs if not o.stop_gradient):
                        w = pt.to_tensor(np.random.default_rng(k).standard_normal(
                            o.shape, dtype=np.float32), dtype=o.dtype, place=place)
                        term = (o * w).sum()
                        loss = term if loss is None else loss + term
                    if loss is not None:
                        grads = pt.grad([loss], wrt, allow_unused=True)
                res[where] = (outs, grads)
            except Exception as e:  # a case that raises is a failure, reported below
                res[where] = e
        pt.set_device(previous)
        out_kind, _, grad_kind = kind.partition("/")
        grad_kind = grad_kind or out_kind
        errors = []
        if isinstance(res["card"], Exception) or isinstance(res["cpu"], Exception):
            errors.append(f"raised: card {res['card']!r} cpu {res['cpu']!r}"[:300])
        else:
            (outs_c, grads_c), (outs_h, grads_h) = res["card"], res["cpu"]
            if len(outs_c) != len(outs_h) or len(grads_c) != len(grads_h):
                errors.append("output counts differ")
            for i, (a, b) in enumerate(zip(outs_c, outs_h)):
                if a.place.device_type != "gpu":
                    errors.append(f"output {i} on {a.place}")
                if a.stop_gradient != b.stop_gradient:
                    errors.append(f"output {i} stop_gradient {a.stop_gradient} vs "
                                  f"{b.stop_gradient}")
                why, share = surface_differ(a.numpy(), b.numpy(), out_kind)
                worst[out_kind] = max(worst.get(out_kind, (0.0, "")), (share, name))
                if why:
                    errors.append(f"output {i}: {why}")
            for i, (a, b) in enumerate(zip(grads_c, grads_h)):
                if (a is None) != (b is None):
                    errors.append(f"gradient {i}: None on one side")
                elif a is not None:
                    why, share = surface_differ(a.numpy(), b.numpy(), grad_kind)
                    worst[grad_kind] = max(worst.get(grad_kind, (0.0, "")), (share, name))
                    if why:
                        errors.append(f"gradient {i}: {why}")
            checked += len(outs_c) + len(grads_c)
        if errors:
            failures.append(name)
            print(f"  FAIL {name}: " + "; ".join(errors))
        del res
    print(f"  {len(cases)} functions, {checked} outputs and gradients compared card against "
          f"CPU in {time.perf_counter() - t0:.1f} s; {len(failures)} failures")
    print("  the largest |card - cpu| as a share of its bound, by kind: " + ", ".join(
        f"{k} {v[0]:.3g} ({v[1]})" for k, v in sorted(worst.items())))
    return failures


def host_cost_per_op(torch, pt, dev):
    """Phase 11b-iii: microseconds of host time per call of four surface ops
    on small card tensors, against the bare torch calls (the loop, then one
    synchronise)."""
    xt = torch.randn(16, 16, device=dev)
    yt = torch.randn(16, 16, device=dev)
    x, y = pt.to_tensor(xt), pt.to_tensor(yt)
    pairs = [
        ("paddle.add(x, y)", lambda: pt.add(x, y), lambda: torch.add(xt, yt)),
        ("x + y", lambda: x + y, lambda: xt + yt),
        ("x.reshape([256])", lambda: x.reshape([256]), lambda: xt.reshape(256)),
        ("x.sum()", lambda: x.sum(), lambda: xt.sum()),
    ]
    out = {}
    for label, surface, bare in pairs:
        us = {}
        for kind, fn in (("surface", surface), ("torch", bare), ("torch", bare),
                         ("surface", surface)):
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_COST_CALLS):
                fn()
            torch.cuda.synchronize()
            us.setdefault(kind, []).append((time.perf_counter() - t0) / HOST_COST_CALLS * 1e6)
        out[label] = {k: min(v) for k, v in us.items()}
        print(f"  {label}: {out[label]['surface']:.2f} us per call through the surface, "
              f"{out[label]['torch']:.2f} us bare torch (best of 2 loops of "
              f"{HOST_COST_CALLS}, host clock, one synchronise per loop)")
    return out


def paddle_style_step_345m(torch, pt, fa, fu, dev):
    """Phase 11b-i: the 345M f32 eager step written as a Paddle user writes it
    (to_tensor inputs, ``loss = crit(model(ids), labels)``, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``, ``float(loss)``) against the same
    steps with torch inputs on a second model from the same seed; then the eval
    forward under ``paddle.no_grad()`` and ``paddle.grad(loss, logits)``.
    Returns its flash and Adam launches and step times."""
    import numpy as np
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    batch = 8
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    print(f"[11b] the tensor surface: GPT-2 345M f32 eager Adam steps written as a Paddle "
          f"user writes them, {batch} x {cfg.max_seq_len} tokens, FLAGS_pallas_fused_update on")
    data = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1))
    pt.set_flags({"FLAGS_pallas_fused_update": True})
    pt.seed(SEED)
    model = GPTForPretraining(cfg)  # on the current device: the card
    pt.seed(SEED)
    twin = GPTForPretraining(cfg, device=dev)
    check(all(torch.equal(a, b) for a, b in zip(model.parameters(), twin.parameters())),
          "two models from one seed differ")
    n_params = len(list(model.parameters()))
    crit = GPTPretrainingCriterion(cfg)
    opt = pt.optimizer.Adam(learning_rate=1e-4, parameters=model.parameters())
    opt_t = pt.optimizer.Adam(learning_rate=1e-4, parameters=twin.parameters())
    ids = pt.to_tensor(data[:, :-1], dtype="int64")
    labels = pt.to_tensor(data[:, 1:], dtype="int64")
    check(ids.place == pt.CUDAPlace(dev.index or 0) and ids.dtype == pt.int64
          and ids.stop_gradient, f"to_tensor gave {ids.place} {ids.dtype}")
    x_t, y_t = ids._value.clone(), labels._value.clone()

    def paddle_step():
        loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss)

    def torch_step():
        loss = crit(twin(x_t), y_t)
        loss.backward()
        opt_t.step()
        opt_t.clear_grad()
        return loss.item()

    reset_flash_counts(fa)  # phase 11b's path (the Paddle-style steps) starts here
    fu.fused_adam.launches = 0
    losses_p, per_step = [], []
    for _ in range(SURFACE_STEPS):
        before, adam_before = flash_counts(fa), fu.fused_adam.launches
        losses_p.append(paddle_step())
        torch.cuda.synchronize()
        got = {k: c - before[k] for k, c in flash_counts(fa).items() if c != before[k]}
        per_step.append((got, fu.fused_adam.launches - adam_before))
    surface_flash, surface_adam = flash_counts(fa), fu.fused_adam.launches  # ... ends here
    losses_t = [torch_step() for _ in range(SURFACE_STEPS)]
    torch.cuda.synchronize()
    want = {"fwd_tf32x3": cfg.num_layers, "dkv_tf32x3": cfg.num_layers,
            "dq_tf32x3": cfg.num_layers}
    print(f"  launches per Paddle-style step (flash by route, Adam): {per_step}")
    check(all(g == want and a == n_params for g, a in per_step),
          f"expected {want} and {n_params} Adam launches per step")
    print("  losses, Paddle-style: " + " ".join(repr(v) for v in losses_p))
    print("  losses, torch inputs: " + " ".join(repr(v) for v in losses_t))
    same = bitwise_same(torch, model, twin, opt, opt_t)
    print(f"  losses bitwise equal {losses_p == losses_t}; parameters and Adam moments "
          f"bitwise equal {same}")
    check(losses_p == losses_t and same, "the Paddle-style step and the torch-input step differ")
    check(all(math.isfinite(v) for v in losses_p) and losses_p[-1] < losses_p[0],
          "the Paddle-style loss is not finite or does not fall")

    # the same steps timed, in turns
    times = {"surface": [], "torch": []}
    for kind in ("surface", "torch", "torch", "surface") * (SURFACE_TIMED // 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (paddle_step if kind == "surface" else torch_step)()
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3)
    check(bitwise_same(torch, model, twin, opt, opt_t), "the timed steps left the models apart")
    step_ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"  step (forward, backward, Adam, clear, host read of the loss), host clock, "
          f"median of {len(times['surface'])} in turns: Paddle-style {step_ms['surface']:.2f} "
          f"ms, torch inputs {step_ms['torch']:.2f} ms "
          f"({batch * cfg.max_seq_len / step_ms['surface'] * 1e3:.0f} tokens/s)")

    # eval under paddle.no_grad(): nothing records a backward
    with pt.no_grad():
        logits = model(ids)
        acc = (pt.argmax(logits, axis=-1) == labels).astype("float32").mean()
    with torch.no_grad():
        logits_t = twin(x_t)
        acc_t = (logits_t.argmax(-1) == y_t).float().mean()
    recorded = [t._value.grad_fn for t in (logits, acc)] + [logits._value.requires_grad]
    print(f"  eval under paddle.no_grad(): accuracy {float(acc)!r} (torch expression "
          f"{acc_t.item()!r}), logits bitwise equal {torch.equal(logits._value, logits_t)}, "
          f"recorded {recorded}")
    check(float(acc) == acc_t.item() and torch.equal(logits._value, logits_t),
          "eval accuracy or logits differ from the torch expression")
    check(acc.stop_gradient and logits.stop_gradient and not any(recorded),
          "something under paddle.no_grad() recorded a backward")
    del logits, logits_t, acc, acc_t

    # paddle.grad(loss, logits) against torch.autograd.grad
    logits = model(ids)
    (g,) = pt.grad(crit(logits, labels), [logits])
    logits_t = twin(x_t)
    (g_t,) = torch.autograd.grad(crit(logits_t, y_t), logits_t)
    print(f"  paddle.grad(loss, logits) against torch.autograd.grad: bitwise equal "
          f"{torch.equal(g._value, g_t)}, stop_gradient {g.stop_gradient}")
    check(torch.equal(g._value, g_t) and g.stop_gradient, "paddle.grad differs from torch's")
    del logits, logits_t, g, g_t
    pt.set_flags({"FLAGS_pallas_fused_update": False})
    del model, twin, opt, opt_t
    torch.cuda.empty_cache()
    return {"flash": surface_flash, "adam": surface_adam, "step_ms": step_ms}


def tensor_surface(torch, pt, fa, fu, dev):
    """Phase 11b: the Paddle-style 345M step, the surface sweep on the card,
    the host cost per op."""
    step = paddle_style_step_345m(torch, pt, fa, fu, dev)
    print("[11b-ii] the CPU op sweep's cases (tests/torch_surface_cases.py) on the card at "
          "the 345M's widths, against the port on the CPU")
    failures = surface_sweep(torch, pt, dev)
    check(not failures, f"the surface disagrees with the CPU in {failures}")
    print("[11b-iii] host cost per op of the surface, small card tensors (16 x 16), after "
          "phase 8b's profiler session")
    step["host_us"] = host_cost_per_op(torch, pt, dev)
    return step


# ---------------------------------------------------------------------------
# Phase 12: paddle.nn and ResNet-50 (BASELINE.json config 2) on the card.
# 12a: bench.py bench_resnet50's step as a Paddle user writes it; 12b: the
# Momentum kernel at ResNet-50's width (f32, eager); 12c: nn.TransformerEncoder
# on the flash kernels; 12d: a traced ResNet-50 replay by kind.
# ---------------------------------------------------------------------------
RESNET_BATCH, RESNET_IMAGE = 256, 224  # bench_resnet50's batch and images (BASELINE config 2)
RESNET_REPLAYS = 10
# The eager copy and the captured step run the same kernels on the same
# batch; at lr 0.1 bf16 rounding and cuDNN's atomic weight-gradient sums move
# the loss (about 7 at the start) by far less than 1e-2 over 13 steps.
TOL_RESNET_LOSS = 1e-2
# BN running statistics after the same steps, eager copy against the graph:
# bf16 buffers, a few ulps of statistics of magnitude ~1 apart.
TOL_BN_STATS = 3e-2
RESNET_F32_BATCH, RESNET_F32_STEPS = 64, 3  # 12b
# 12c: TransformerEncoderLayer(768, 12, 3072) x 12 at 8 x 512, a Linear head
ENCODER = dict(d_model=768, nhead=12, dim_feedforward=3072, layers=12, batch=8, seq=512,
               classes=1024)
TOL_ENCODER_FLASH_VS_DENSE = 1e-3  # f32 forward: online vs one-pass softmax sums (phase 4's)
# A ResNet replay's device operations by kind (12d): pooling (first: its
# backward kernel's name holds "nchw"), cuDNN convolution kernels and their
# layout transposes, GEMM-named kernels (the fc layer's and CUTLASS GEMMs
# cuDNN picks), the composed batch norm's reductions, elementwise work
# (batch norm's arithmetic, ReLU, the residual adds, the Momentum update),
# and the rest.
RESNET_KINDS = [
    ("pooling", r"pool"),
    ("convolution", r"conv|cudnn|implicit|fprop|dgrad|wgrad|xmma|nhwc|nchw"),
    ("matmul", r"nvjet|gemm|cutlass"),
    ("reduction (batch norm statistics, loss)", r"reduce_kernel"),
    ("elementwise (batch norm arithmetic, ReLU, adds, Momentum)", r"elementwise_kernel"),
    ("copy / fill", r"Memcpy|Memset|copy|fill"),
]


def resnet_batch(pt, batch, seed=0):
    """bench_resnet50's inputs: ``numpy.random.default_rng(seed)``'s normal
    images and labels in [0, 1000), as ``paddle.to_tensor`` on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = pt.to_tensor(rng.standard_normal((batch, 3, RESNET_IMAGE, RESNET_IMAGE))
                     .astype(np.float32))
    y = pt.to_tensor(rng.integers(0, 1000, (batch,)).astype(np.int64))
    return x, y


def bn_buffers(model):
    return [(n, b) for n, b in model.named_buffers() if n.endswith(("_mean", "_variance"))]


def resnet50_o2(torch, pt, dev):
    """Phase 12a: bench_resnet50's step, O2 bf16 ResNet-50 with Momentum(0.1,
    0.9) through compile_train_step on ``paddle.to_tensor`` inputs, against an
    eager copy. Returns its numbers."""
    from paddle_tpu_torch.vision.models import resnet50

    batch, warmup = RESNET_BATCH, pt.jit.WARMUP_STEPS
    print(f"[12a] ResNet-50 training step (BASELINE.json config 2, bench.py bench_resnet50), "
          f"{batch} x 3 x {RESNET_IMAGE}^2, AMP O2 bf16, Momentum(0.1, 0.9), one CUDA graph")
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    pt.seed(SEED)
    model = resnet50(num_classes=1000)
    eager = copy.deepcopy(model)  # before decorate: the wrapped forward is per model
    model = pt.amp.decorate(model, level="O2", dtype="bfloat16")
    eager = pt.amp.decorate(eager, level="O2", dtype="bfloat16")
    n_params = len(list(model.parameters()))
    opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9, parameters=model.parameters())
    loss_fn = pt.nn.CrossEntropyLoss()
    step = pt.jit.compile_train_step(model, lambda out, y: loss_fn(out.astype("float32"), y),
                                     opt)
    x, y = resnet_batch(pt, batch)
    buffers = bn_buffers(model)
    ptrs = [b.data_ptr() for _, b in buffers]
    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(step(x, y))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses.append(step(x, y))  # capture, then the first replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(RESNET_REPLAYS):
        losses.append(step(x, y))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / RESNET_REPLAYS
    step_ms = start.elapsed_time(end) / RESNET_REPLAYS
    imgs = batch / step_ms * 1e3
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    values = [float(v) for v in losses]
    print(f"  {n_params} parameters, {len(buffers)} BN statistics buffers; {warmup} eager "
          f"warm-up steps {warm_s:.2f} s, capture + first replay {capture_s:.2f} s")
    print(f"  {RESNET_REPLAYS} replays: {step_ms:.3f} ms per replay (CUDA events), "
          f"{host_ms:.3f} ms (host clock); resnet50_amp_o2_imgs_per_sec_per_chip "
          f"{imgs:.1f}; peak memory allocated {peak_gb:.2f} GB ({held_gb:.2f} GB held "
          f"before the phase)")
    print("  losses: " + " ".join(f"{v:.4f}" for v in values))
    check(isinstance(losses[-1], pt.Tensor), "the step's loss is not a paddle.Tensor")
    check(all(math.isfinite(v) for v in values), "non-finite ResNet-50 loss")
    check([b.data_ptr() for _, b in buffers] == ptrs,
          "a BN statistics buffer was rebound: the graph would read a stale one")

    opt_e = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                  parameters=eager.parameters())
    eager_values = []
    for _ in range(len(values)):
        loss = loss_fn(eager(x).astype("float32"), y)
        loss.backward()
        opt_e.step()
        opt_e.clear_grad()
        eager_values.append(float(loss))
    diff = max(abs(a - c) for a, c in zip(values, eager_values))
    print(f"  eager copy (loss.backward(); opt.step(); opt.clear_grad()) vs the warm-up steps "
          f"and replays: max|d loss|={diff:.3e} over {len(values)} steps, bitwise equal "
          f"{values == eager_values}, tol={TOL_RESNET_LOSS:g}")
    check(diff <= TOL_RESNET_LOSS, "the eager copy and the captured step disagree")
    worst = 0.0
    for (name, b), (_, be) in zip(buffers, bn_buffers(eager)):
        d = ((b.float() - be.float()).abs() / (1.0 + be.float().abs())).max().item()
        worst = max(worst, d)
        check(d <= TOL_BN_STATS, f"BN statistics {name} differ from the eager copy's by {d:.3e}")
    moved = sum(not torch.equal(b, torch.zeros_like(b) if n.endswith("_mean") else
                                torch.ones_like(b)) for n, b in buffers)
    print(f"  BN statistics after {len(values)} steps: {moved} of {len(buffers)} buffers moved "
          f"from their initial values, every data_ptr() kept, max |graph - eager| / (1 + |eager|)"
          f" = {worst:.3e} (tol {TOL_BN_STATS:g})")
    check(moved == len(buffers), "the captured step did not accumulate every BN statistic")
    model.eval()
    eager.eval()
    with torch.no_grad():
        xs = x._value[:32]
        out = model(xs).float()
        half = model(xs[:8]).float()
        out_e = eager(xs).float()
    model.train()
    eval_diff = (out[:8] - half).abs().max().item()
    eval_eager = (out - out_e).abs().max().item()
    scale = out_e.abs().max().item()
    print(f"  eval mode: logits of 8 images alone against within a batch of 32 max|d|="
          f"{eval_diff:.3e}; against the eager copy max|d|={eval_eager:.3e} (max|logit| "
          f"{scale:.3f})")
    check(eval_diff <= TOL_BN_STATS * max(scale, 1.0),
          "eval logits depend on the batch: the running statistics are not used")
    check(eval_eager <= 3 * TOL_BN_STATS * max(scale, 1.0),
          "eval logits differ from the eager copy's")
    del eager, opt_e, loss
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "imgs_per_s": imgs, "peak_gb": peak_gb, "host_ms": host_ms}


def resnet50_f32_momentum(torch, pt, fu, dev):
    """Phase 12b: eager f32 ResNet-50 with Momentum(0.1, 0.9), the fused
    kernel (flag on) against the rule (flag off), in turns. Returns the
    kernel's launches and the timings."""
    import numpy as np
    from paddle_tpu_torch.vision.models import resnet50

    batch, steps = RESNET_F32_BATCH, RESNET_F32_STEPS
    print(f"[12b] ResNet-50 f32 eager, {batch} x 3 x {RESNET_IMAGE}^2, Momentum(0.1, 0.9), "
          f"FLAGS_pallas_fused_update on and off in turns, {steps} steps each; cuDNN "
          f"deterministic, so the flag is the only difference")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pt.seed(SEED)
    models = {True: resnet50(num_classes=1000)}
    models[False] = copy.deepcopy(models[True])
    n_params = len(list(models[True].parameters()))
    opts = {flag: pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=m.parameters()) for flag, m in models.items()}
    crit = pt.nn.CrossEntropyLoss()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((batch, 3, RESNET_IMAGE, RESNET_IMAGE))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 1000, (batch,))).to(dev)
    for kernel in fu.KERNELS.values():
        kernel.launches = 0  # this path's count starts here
    losses = {True: [], False: []}
    ms = {True: {"step": [], "opt": []}, False: {"step": [], "opt": []}}
    launches_on = 0
    try:
        for _ in range(steps):
            for flag in (True, False):
                pt.set_flags({"FLAGS_pallas_fused_update": flag})
                before = fu.KERNELS["momentum"].launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = crit(models[flag](x), y)
                loss.backward()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                opts[flag].step()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                opts[flag].clear_grad()
                ms[flag]["step"].append((t2 - t0) * 1e3)
                ms[flag]["opt"].append((t2 - t1) * 1e3)
                losses[flag].append(loss.item())
                got = fu.KERNELS["momentum"].launches - before
                if flag:
                    launches_on += got
                check(got == (n_params if flag else 0),
                      f"flag {flag}: {got} Momentum launches in a step, expected "
                      f"{n_params if flag else 0}")
    finally:
        pt.set_flags({"FLAGS_pallas_fused_update": False})
        torch.backends.cudnn.deterministic = was
    launches = fu.KERNELS["momentum"].launches  # ... and ends here
    others = sum(k.launches for name, k in fu.KERNELS.items() if name != "momentum")
    same = bitwise_same(torch, models[True], models[False], opts[True], opts[False])
    bn_same = all(torch.equal(a, b) for (_, a), (_, b) in zip(bn_buffers(models[True]),
                                                              bn_buffers(models[False])))
    med = {flag: {k: statistics.median(v) for k, v in d.items()} for flag, d in ms.items()}
    print(f"  {n_params} parameters: {launches_on // steps} Momentum kernel launches per "
          f"flag-on step, {launches} over the path, {others} of other kernels; losses "
          + " ".join(f"{v:.6f}" for v in losses[True])
          + f"; flag on vs off: losses bitwise {losses[True] == losses[False]}, parameters "
          f"and velocities bitwise {same}, BN statistics bitwise {bn_same}")
    print(f"  opt.step(): {med[True]['opt']:.3f} ms with the kernel, {med[False]['opt']:.3f} ms "
          f"with the rule; the step (forward, backward, opt.step()): {med[True]['step']:.3f} "
          f"ms and {med[False]['step']:.3f} ms (host clock, synchronised, medians of {steps})")
    check(launches == n_params * steps and others == 0,
          f"expected {n_params * steps} Momentum launches, got {launches} ({others} other)")
    check(all(math.isfinite(v) for v in losses[True]), "non-finite f32 ResNet-50 loss")
    check(losses[True] == losses[False] and same and bn_same,
          "the fused Momentum kernel and the rule disagree at ResNet-50's width")
    del models, opts, loss
    torch.cuda.empty_cache()
    return {"launches": launches, "opt_ms": med[True]["opt"], "opt_ms_rule": med[False]["opt"],
            "step_ms": med[True]["step"], "step_ms_rule": med[False]["step"]}


def make_encoder(pt, dropout):
    """``TransformerEncoderLayer`` x 12 at BERT-base's widths and a Linear head."""
    cfg = ENCODER

    class Encoder(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            layer = pt.nn.TransformerEncoderLayer(cfg["d_model"], cfg["nhead"],
                                                  cfg["dim_feedforward"], dropout=dropout)
            self.encoder = pt.nn.TransformerEncoder(layer, cfg["layers"])
            self.head = pt.nn.Linear(cfg["d_model"], cfg["classes"])

        def forward(self, x, src_mask=None):
            return self.head(self.encoder(x, src_mask))

    pt.seed(SEED)
    return Encoder()


def encoder_steps(torch, pt, fa, model, x, y, n, want=None):
    """``n`` calls of an O2 AdamW compile_train_step over ``model`` (the first
    WARMUP_STEPS eager, then the capture, then replays); the flash launches
    of each eager or capturing call are held to ``want``. Returns the losses."""
    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                             weight_decay=0.01)
    crit = pt.nn.CrossEntropyLoss()
    step = pt.jit.compile_train_step(
        model, lambda out, lab: crit(out.astype("float32").reshape([-1, ENCODER["classes"]]),
                                     lab.reshape([-1])), opt)
    losses = []
    for i in range(n):
        before = flash_counts(fa)
        losses.append(float(step(x, y)))
        got = {k: v - before[k] for k, v in flash_counts(fa).items()}
        if want is not None and i <= pt.jit.WARMUP_STEPS:
            check(got == want, f"encoder step {i}: flash launches {got}, expected {want}")
    return losses, step


def transformer_encoder(torch, pt, fa, dev):
    """Phase 12c: nn.TransformerEncoder on the flash kernels. Returns the flash
    launches over the path and the step's ms."""
    import numpy as np

    cfg = ENCODER
    b, s = cfg["batch"], cfg["seq"]
    print(f"[12c] nn.TransformerEncoderLayer({cfg['d_model']}, {cfg['nhead']}, "
          f"{cfg['dim_feedforward']}) x {cfg['layers']} + Linear head at {b} x {s}: O2 bf16 "
          f"AdamW through compile_train_step, the f32 forward, a bool mask")
    rng = np.random.default_rng(2)
    x = pt.to_tensor(rng.standard_normal((b, s, cfg["d_model"])).astype(np.float32))
    y = pt.to_tensor(rng.integers(0, cfg["classes"], (b, s)).astype(np.int64))
    n_layers = cfg["layers"]
    want = dict.fromkeys(flash_counts(fa), 0)
    want.update(fwd_sm90=n_layers, dkv_sm90=n_layers, dq_sm90=n_layers)
    reset_flash_counts(fa)  # the encoder path's count starts here
    model = make_encoder(pt, 0.0)
    eager = copy.deepcopy(model)
    model = pt.amp.decorate(model, level="O2", dtype="bfloat16")
    eager = pt.amp.decorate(eager, level="O2", dtype="bfloat16")
    n = pt.jit.WARMUP_STEPS + 1 + RESNET_REPLAYS
    losses, step = encoder_steps(torch, pt, fa, model, x, y, n, want)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    before = flash_counts(fa)
    start.record()
    for _ in range(RESNET_REPLAYS):
        step(x, y)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / RESNET_REPLAYS
    check(flash_counts(fa) == before, "the encoder replays did not run the captured graph")
    opt_e = pt.optimizer.AdamW(learning_rate=1e-4, parameters=eager.parameters(),
                               weight_decay=0.01)
    crit = pt.nn.CrossEntropyLoss()
    eager_losses = []
    for _ in range(n):
        before = flash_counts(fa)
        loss = crit(eager(x).astype("float32").reshape([-1, cfg["classes"]]), y.reshape([-1]))
        loss.backward()
        opt_e.step()
        opt_e.clear_grad()
        eager_losses.append(float(loss))
        got = {k: v - before[k] for k, v in flash_counts(fa).items()}
        check(got == want, f"eager encoder step: flash launches {got}, expected {want}")
    diff = max(abs(a - c) for a, c in zip(losses, eager_losses))
    print(f"  dropout 0: {n} steps, {step_ms:.3f} ms per replay (CUDA events), "
          f"{b * s / step_ms * 1e3:.1f} tokens/s; flash launches per step {want}; eager copy "
          f"vs the compiled step max|d loss|={diff:.3e} (tol {TOL_EAGER_VS_GRAPH:g}); losses "
          + " ".join(f"{v:.4f}" for v in losses))
    check(diff <= TOL_EAGER_VS_GRAPH, "the encoder's eager copy and compiled step disagree")
    del eager, opt_e, step, model
    torch.cuda.empty_cache()

    dropped = pt.amp.decorate(make_encoder(pt, 0.1), level="O2", dtype="bfloat16")
    d_losses, _ = encoder_steps(torch, pt, fa, dropped, x, y, pt.jit.WARMUP_STEPS + 2, want)
    print(f"  dropout 0.1: eager, capture and a replay: losses "
          + " ".join(f"{v:.4f}" for v in d_losses))
    check(all(math.isfinite(v) for v in d_losses), "non-finite encoder loss at dropout 0.1")
    before = flash_counts(fa)
    mask = torch.rand(b, 1, s, s, device=dev) > 0.2
    mask |= torch.eye(s, dtype=torch.bool, device=dev)
    with torch.no_grad():
        masked = dropped(x, pt.to_tensor(mask))
    got = {k: v - before[k] for k, v in flash_counts(fa).items()}
    print(f"  a bool src_mask: flash launches {got} (the dense route), output "
          f"{masked.dtype.name} {masked.shape}")
    check(sum(got.values()) == 0, f"the masked forward launched a flash kernel: {got}")
    check(bool(torch.isfinite(masked._value.float()).all()), "non-finite masked output")
    del dropped, masked

    f32 = make_encoder(pt, 0.1).eval()
    with torch.no_grad():
        before = flash_counts(fa)
        flash = f32(x)._value
        got = {k: v - before[k] for k, v in flash_counts(fa).items()}
        pt.set_flags({"FLAGS_use_flash_attention": False})
        dense = f32(x)._value
        pt.set_flags({"FLAGS_use_flash_attention": True})
    f32_want = dict.fromkeys(got, 0)
    f32_want.update(fwd_tf32x3=n_layers)
    err = (flash - dense).abs().max().item()
    print(f"  f32 eval forward: flash launches {got}; flash vs dense max|d|={err:.3e} "
          f"(max|out| {dense.abs().max().item():.3f}, tol {TOL_ENCODER_FLASH_VS_DENSE:g})")
    check(got == f32_want, f"f32 encoder forward: flash launches {got}, expected {f32_want}")
    check(err <= TOL_ENCODER_FLASH_VS_DENSE, "the f32 encoder's flash and dense routes disagree")
    launches = flash_counts(fa)  # ... and ends here
    del f32, flash, dense
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms}


def graph_ms(torch, fn, reps=10):
    """Device ms of ``fn``'s kernels captured as one CUDA graph (after an eager
    warm-up on a side stream), median of ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps=reps, warmup=2)


def resnet50_trace(torch, step, batch):
    """Phase 12d (in its own process): a replay by kind, and the Momentum
    rule's share: its ops over copies of the parameters and velocities, zero
    gradients, captured as a graph of their own and replayed, as the step's
    graph runs them."""
    from paddle_tpu_torch.optimizer.optimizer import apply_update

    print("[12d] torch.profiler trace of one replayed ResNet-50 O2 step (phase 12a's, in a "
          "process of its own)")
    step_ms = time_ms(lambda: step(*batch), reps=5, warmup=1)
    n_ops, window, busy, wall_ms, by_name = device_trace(torch, lambda: step(*batch))
    print_trace("", n_ops, window, busy, wall_ms, by_name, RESNET_KINDS)
    for kind in ("convolution", "matmul"):  # what the two kinds hold
        names = sorted(((t, n, name) for name, (t, n) in by_name.items()
                        if kind_of(name, RESNET_KINDS) == kind), reverse=True)[:3]
        print(f"  largest {kind} operations: " + "; ".join(
            f"{t / 1e3:.3f} ms x{n} {name[:90]}" for t, n, name in names))
    opt = step.optimizer
    params = [p.detach().clone() for p in step._params]
    states = [{k: v.clone() for k, v in opt._state_of(p).items()} for p in step._params]
    grads = [torch.zeros_like(p) for p in params]
    lr = torch.tensor(0.1, device=params[0].device)
    with torch.no_grad():
        update_ms = graph_ms(torch, lambda: apply_update(opt, params, grads, lr, states))
    print(f"  the Momentum rule alone ({len(params)} bf16 parameters, its ops captured as "
          f"one graph, CUDA events): {update_ms:.3f} ms a replay, {update_ms / step_ms:.1%} "
          f"of the step's {step_ms:.3f} ms")


def gpt_trace_step(torch, pt, dev):
    """Phase 7's step: bench.py main()'s O2 bf16 AdamW 345M at 8 x 1024."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    pt.seed(SEED)
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    model = pt.amp.decorate(GPTForPretraining(cfg, device=dev), level="O2", dtype="bfloat16")
    criterion = GPTPretrainingCriterion(cfg)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                             weight_decay=0.01)
    step = pt.jit.compile_train_step(model, lambda lo, lb: criterion(lo.float(), lb), opt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len + 1), generator=gen, device=dev)
    return step, (ids[:, :-1], ids[:, 1:]), cfg.num_layers


def bert_trace_step(torch, pt, dev):
    """Phase 7d's AdamW step: bench_bert's O2 bf16 BERT-base at 8 x 512."""
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              BertPretrainingCriterion)

    pt.seed(SEED)
    cfg = BertConfig(**BERT_CFG, dropout=0.0, attn_dropout=0.0)
    model = pt.amp.decorate(BertForPretraining(cfg, device=dev), level="O2", dtype="bfloat16")
    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = pt.jit.compile_train_step(model, bert_loss_fn(BertPretrainingCriterion()), opt)
    return step, bert_batch(torch, cfg, BERT_BATCH, dev), cfg.num_layers


def resnet_trace_step(torch, pt, dev):
    """Phase 12a's step: bench_resnet50's O2 bf16 ResNet-50, Momentum."""
    from paddle_tpu_torch.vision.models import resnet50

    pt.seed(SEED)
    model = pt.amp.decorate(resnet50(num_classes=1000), level="O2", dtype="bfloat16")
    opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9, parameters=model.parameters())
    loss_fn = pt.nn.CrossEntropyLoss()
    step = pt.jit.compile_train_step(model, lambda out, y: loss_fn(out.astype("float32"), y),
                                     opt)
    return step, resnet_batch(pt, RESNET_BATCH), None


# The traces (phases 8, 8b and 12d) run in processes of their own: a profiler
# session in a process where earlier sessions recorded tens of thousands of
# operations loses some of its records (a BERT replay traced with 6139-6144
# of its 6159 operations late in this script, one of them a flash launch;
# ResNet-50's with 3736 of 3778), where a fresh process keeps them all.
def ernie_trace_step(torch, pt, dev):
    """Phase 15b's dense step: ``ErnieCtrConfig()`` at batch 32, f32, Adam, on
    one batch of rows pulled from its table."""
    import numpy as np

    from paddle_tpu_torch.examples import ernie_ctr as ec

    cfg = ec.ErnieCtrConfig()
    table, _, step = ec.build(cfg)
    slot_ids, tokens, labels = ec.synthetic_batch(cfg, ERNIE_BATCH, np.random.default_rng(0))
    rows = table.pull(slot_ids.reshape(-1)).reshape(ERNIE_BATCH, cfg.slots, cfg.sparse_dim)
    return step, (pt.to_tensor(rows), pt.to_tensor(tokens), pt.to_tensor(labels)), cfg.layers


TRACE_STEPS = {"gpt": gpt_trace_step, "bert": bert_trace_step, "resnet": resnet_trace_step,
               "ernie": ernie_trace_step}
TRACE_TITLES = {"gpt": "[8] torch.profiler trace of one replayed step (phase 7's, in a "
                       "process of its own)",
                "bert": "[8b] torch.profiler trace of one replayed BERT-base step (phase "
                        "7d's AdamW step, in a process of its own)",
                "ernie": "[15b] torch.profiler trace of one replayed ERNIE CTR dense step "
                         "(config 5, f32, in a process of its own)"}
def slice20_alone(torch) -> int:
    """``python3 chip_smoke.py --phase18``: phase 18 alone, after building the
    libraries its paths launch (the sm90 and tf32x3 flash kernels)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    sources = [fa.TF32_FWD_KERNEL_NAME, fa.TF32_BWD_KERNEL_NAME, fa.SM90_FWD_KERNEL_NAME,
               fa.SM90_DKV_KERNEL_NAME, fa.SM90_DQ_KERNEL_NAME]
    _build.build(sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    out = slice20(torch, pt, fa, torch.device("cuda", 0), card)
    print(json.dumps({"phase18": out}, default=str))
    return 0


TRACE_CHILD_TIMEOUT_S = 300


def trace_child(kind: str) -> int:
    """``chip_smoke.py --trace KIND``: build KIND's step (``TRACE_STEPS``),
    run its eager steps and its capture, then trace a replay (phase 8, 8b or
    12d) with that phase's checks. Returns the exit code."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    step, batch, n_layers = TRACE_STEPS[kind](torch, pt, dev)
    for _ in range(pt.jit.WARMUP_STEPS + 1):  # the eager steps, then the capture
        step(*batch)
    (entry,) = step._captured.values()
    check(entry.graph is not None, f"the {kind} step was not captured")
    if kind == "resnet":
        resnet50_trace(torch, step, batch)
    else:
        profile_replay(torch, step, batch, n_layers, TRACE_TITLES[kind],
                       "tf32x3" if kind == "ernie" else "sm90")
    return 0


def run_trace_child(kind):
    """Run ``trace_child(kind)`` in a process of its own; print its output and
    fail when it does."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace", kind],
                          capture_output=True, text=True, timeout=TRACE_CHILD_TIMEOUT_S)
    print(proc.stdout.rstrip())
    print(f"  (its process: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0:
        print(proc.stderr[-4000:])
    check(proc.returncode == 0, f"the {kind} trace failed")


def nn_and_resnet50(torch, pt, fa, fu, dev):
    """Phase 12: 12a-12d."""
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)  # a context before the memory statistics are reset
    o2 = resnet50_o2(torch, pt, dev)
    f32 = resnet50_f32_momentum(torch, pt, fu, dev)
    enc = transformer_encoder(torch, pt, fa, dev)
    torch.cuda.empty_cache()
    run_trace_child("resnet")
    print(f"  phase 12: {time.perf_counter() - t0:.1f} s")
    return {"o2": o2, "f32": f32, "encoder": enc}


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


# ---------------------------------------------------------------------------
# Phase 13: eager lazy dispatch and whole-step capture (core/lazy.py) on the
# card. 13a: BASELINE.json config 1 as bench.py bench_mnist_eager writes it
# (LeNet, Adam(1e-3), CrossEntropyLoss, 64 x 1 x 28² from default_rng(0),
# the plain eager loop), per-op, lazy (capture off) and captured, with
# FLAGS_pallas_fused_update off (bench's default) and on; 13b: phase 11b's
# Paddle-style 345M f32 step captured whole; 13c: the medium PTB LSTM
# language model of Zaremba, Sutskever and Vinyals (2014), PaddleNLP's
# examples/language_model/rnnlm setting, per-op, lazy and captured.
# ---------------------------------------------------------------------------
LENET_BATCH = 64
LENET_STEPS = 30      # bench_mnist_eager's window: 30 steps
LENET_REPS = 6        # ... median of the best half of 6 windows (BENCH_REPS' eager default)
LENET_BITWISE_STEPS = 5
REGIMES = {"per_op": (False, False), "lazy": (True, False), "captured": (True, True)}
# the medium configuration (Zaremba et al. 2014, section 4; PaddleNLP rnnlm):
# vocab 10000, 650 units in the embedding and both LSTM layers, 35 unrolled
# steps, batch 20, uniform init in +-0.05, SGD at lr 1.0, global-norm clip 5,
# dropout 0.5; random token ids from the seed stand in for PTB
PTB = dict(vocab=10000, hidden=650, layers=2, num_steps=35, batch=20, init=0.05, lr=1.0,
           clip=5.0, dropout=0.5)
PTB_STEPS = 20        # steps per timed window
PTB_BITWISE_STEPS = 3
CAPTURE_345M_STEPS = 3  # captured steps held bitwise, after the warm-up


def set_regime(pt, name):
    lazy_on, capture = REGIMES[name]
    pt.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on, "FLAGS_eager_step_capture": capture})


def median_best_window(fn, steps, reps):
    """bench.py's ``_timed(median_best=True)``: the median of the best half of
    ``reps`` windows of ``steps`` calls, each ended by a host read."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        last = None
        for _ in range(steps):
            last = fn()
        float(last)
        times.append(time.perf_counter() - t0)
    best = sorted(times)[:max(1, reps // 2)]
    return best[len(best) // 2]


def host_breakdown(pt, fn, steps):
    """bench.py's ``_host_breakdown``: per-step host ms from the dispatch
    counters' timers over ``steps`` calls, and the counters themselves."""
    prof = pt.profiler
    prof.reset_dispatch_counters()
    t0 = time.perf_counter()
    last = None
    for _ in range(steps):
        last = fn()
    float(last)
    wall = (time.perf_counter() - t0) * 1e3 / steps
    c = prof.dispatch_counters()
    return {"trace_ms": c["trace_time_ms"] / steps, "compile_ms": c["compile_time_ms"] / steps,
            "replay_ms": c["replay_time_ms"] / steps,
            "async_compile_ms": c["async_compile_ms"] / steps, "wall_ms": wall,
            "segment_graph_replays": c["segment_graph_replays"],
            "capture_fallbacks": c["capture_fallbacks"],
            "fallback_reasons": dict(c["capture_fallback_reasons"])}


def kernel_counts(fa, fu):
    """Every wrapper's launch count: the flash kernels by route, the updates."""
    out = flash_counts(fa)
    out.update(adam=fu.fused_adam.launches, sgd=fu.fused_sgd.launches,
               momentum=fu.fused_momentum.launches)
    return out


def counts_since(fa, fu, before):
    return {k: v - before[k] for k, v in kernel_counts(fa, fu).items() if v != before[k]}


def per_step_programs(c):
    return {k: c[k] for k in ("programs", "op_programs", "segment_programs",
                              "backward_programs", "optimizer_programs", "captured_programs")}


def lenet_trainer(torch, pt, dev):
    import numpy as np

    pt.seed(0)
    model = pt.vision.models.LeNet()
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    loss_fn = pt.nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    x = pt.to_tensor(rng.standard_normal((LENET_BATCH, 1, 28, 28)).astype(np.float32))
    y = pt.to_tensor(rng.integers(0, 10, (LENET_BATCH,)))

    def step():
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, step


def lenet_regimes(torch, pt, fa, fu, dev, fused):
    """13a with ``FLAGS_pallas_fused_update`` at ``fused``: bitwise the three
    regimes over LENET_BITWISE_STEPS steps, then each regime's counts, steps/s
    and host breakdown."""
    from paddle_tpu_torch.core import lazy

    pt.set_flags({"FLAGS_pallas_fused_update": fused})
    runs = {}
    for name in REGIMES:
        set_regime(pt, name)
        lazy.reset_lazy_state()
        model, opt, step = lenet_trainer(torch, pt, dev)
        losses = [float(step()) for _ in range(LENET_BITWISE_STEPS)]
        runs[name] = (model, opt, losses)
    ref_model, ref_opt, ref_losses = runs["per_op"]
    same = {name: losses == ref_losses and bitwise_same(torch, model, ref_model, opt, ref_opt)
            for name, (model, opt, losses) in runs.items() if name != "per_op"}
    print(f"  fused update {'on' if fused else 'off'}: losses over {LENET_BITWISE_STEPS} steps, "
          f"per-op {ref_losses}; bitwise per-op (losses, parameters, moments): {same}")
    check(all(same.values()), "a lazy or captured LeNet step differs from the per-op step")
    out = {}
    for name in REGIMES:
        set_regime(pt, name)
        lazy.reset_lazy_state()
        _, _, step = lenet_trainer(torch, pt, dev)
        float(step())
        float(step())
        before = kernel_counts(fa, fu)
        float(step())  # captured: the build, then the first replay
        built_adam = counts_since(fa, fu, before).get("adam", 0)
        progs = per_step_programs(pt.profiler.measure_programs(step, warmup=1))
        before = kernel_counts(fa, fu)
        sps = LENET_STEPS / median_best_window(step, LENET_STEPS, LENET_REPS)
        timed_adam = counts_since(fa, fu, before).get("adam", 0)
        host = host_breakdown(pt, step, LENET_STEPS)
        out[name] = {"steps_per_s": sps, "programs": progs, "host": host,
                     "adam_in_build": built_adam, "adam_timed": timed_adam}
        print(f"  {name}: mnist_lenet_eager_steps_per_sec {sps:.1f}; programs a step {progs}; "
              f"host ms a step {{trace {host['trace_ms']:.4f}, compile {host['compile_ms']:.4f}, "
              f"replay {host['replay_ms']:.4f}, async {host['async_compile_ms']:.4f}, wall "
              f"{host['wall_ms']:.4f}}}; capture fallbacks in the windows "
              f"{host['capture_fallbacks']} {host['fallback_reasons']}; segment graph replays "
              f"{host['segment_graph_replays']}; Adam launches: "
              f"{built_adam} in the third step (captured: the graph's build), {timed_adam} "
              f"in {LENET_STEPS * LENET_REPS} timed steps")
        check(host["capture_fallbacks"] == 0, f"{name}: capture fell back in a timed window "
                                              f"({lazy.last_capture_error[0]})")
        if name == "lazy":
            check(host["segment_graph_replays"] == LENET_STEPS,
                  f"{host['segment_graph_replays']} of {LENET_STEPS} lazy steps replayed the "
                  f"segment's graphs ({lazy.last_capture_error[0]})")
    want = {"lazy": (3, 1, 1, 1, 0), "captured": (1, 0, 0, 0, 1)}
    for name, (n, seg, bwd, opt_n, cap) in want.items():
        p = out[name]["programs"]
        check((p["programs"], p["segment_programs"], p["backward_programs"],
               p["optimizer_programs"], p["captured_programs"]) == (n, seg, bwd, opt_n, cap),
              f"{name}: {p} programs a step, expected {n} (the last call that could not be "
              f"deferred: {lazy.last_infer_failure[0]})")
    if fused:
        check(out["captured"]["adam_in_build"] == 10 and out["captured"]["adam_timed"] == 0,
              "the captured LeNet step's graph does not hold the 10 fused Adam launches, or "
              "a replay went through the wrapper")
        check(out["lazy"]["adam_timed"] == 10 * LENET_STEPS * LENET_REPS,
              "the lazy LeNet step did not launch 10 fused Adam kernels a step")
    pt.set_flags({"FLAGS_pallas_fused_update": False})
    return out


def capture_345m(torch, pt, fa, fu, dev):
    """13b: phase 11b's Paddle-style 345M f32 step under lazy dispatch with
    capture against the same per-op steps on a twin model: bitwise, the
    launches its graph holds, ms a step in turns."""
    import numpy as np
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    batch = 8
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    print(f"[13b] phase 11b's Paddle-style 345M f32 step captured whole: {batch} x "
          f"{cfg.max_seq_len}, Adam through the fused kernel, lazy dispatch with capture "
          f"against the per-op steps")
    data = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1))
    pt.set_flags({"FLAGS_pallas_fused_update": True})
    models, opts = [], []
    for _ in range(2):
        pt.seed(SEED)
        models.append(GPTForPretraining(cfg))
        opts.append(pt.optimizer.Adam(learning_rate=1e-4, parameters=models[-1].parameters()))
    n_params = len(list(models[0].parameters()))
    crit = GPTPretrainingCriterion(cfg)
    ids = pt.to_tensor(data[:, :-1], dtype="int64")
    labels = pt.to_tensor(data[:, 1:], dtype="int64")

    def stepper(i, regime):
        def step():
            set_regime(pt, regime)
            loss = crit(models[i](ids), labels)
            loss.backward()
            opts[i].step()
            opts[i].clear_grad()
            return loss
        return step

    per_op, captured = stepper(0, "per_op"), stepper(1, "captured")
    lazy.reset_lazy_state()
    warm = pt.get_flags("FLAGS_eager_capture_warmup")["FLAGS_eager_capture_warmup"]
    n = warm + CAPTURE_345M_STEPS
    losses_ref = [float(per_op()) for _ in range(n)]
    pt.profiler.reset_dispatch_counters()
    losses, built = [], None
    for i in range(n):
        before = kernel_counts(fa, fu)
        losses.append(float(captured()))
        if i == warm:  # the build: what the capture launched is what each replay holds
            got = counts_since(fa, fu, before)
            built = {"flash": {k: v for k, v in got.items() if k.endswith("tf32x3") or
                               k.endswith("sm90") or k.endswith("simt")},
                     "adam": got.get("adam", 0)}
    c = pt.profiler.dispatch_counters()
    same = losses == losses_ref and bitwise_same(torch, models[1], models[0], opts[1], opts[0])
    print(f"  losses per-op {losses_ref}; lazy + capture {losses}; bitwise (losses, parameters, "
          f"moments) {same}; counters: {c['capture_builds']} build, {c['capture_replays']} "
          f"replays, fallbacks {dict(c['capture_fallback_reasons'])}; the graph holds "
          f"{built['flash']} flash and {built['adam']} Adam launches")
    want = {"fwd_tf32x3": cfg.num_layers, "dkv_tf32x3": cfg.num_layers,
            "dq_tf32x3": cfg.num_layers}
    check(same, "the captured 345M step differs from the per-op step")
    check(c["capture_replays"] == CAPTURE_345M_STEPS and c["capture_fallbacks"] == 0,
          f"the 345M step did not replay once a step without a fallback (the last capture "
          f"error: {lazy.last_capture_error[0]})")
    check(built["flash"] == want and built["adam"] == n_params,
          f"the captured 345M graph holds {built}, expected {want} and {n_params} Adam")
    before = kernel_counts(fa, fu)
    times = {"per_op": [], "captured": []}
    for kind in ("per_op", "captured", "captured", "per_op") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float((per_op if kind == "per_op" else captured)())
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3)
    timed_launches = counts_since(fa, fu, before)
    c = pt.profiler.dispatch_counters()
    check(c["capture_fallbacks"] == 0, "a timed captured 345M step fell back")
    check(bitwise_same(torch, models[1], models[0], opts[1], opts[0]),
          "the timed steps left the two models apart")
    step_ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"  step (forward, backward, Adam, clear, host read of the loss), host clock, median "
          f"of {len(times['captured'])} in turns: captured {step_ms['captured']:.2f} ms, per-op "
          f"{step_ms['per_op']:.2f} ms ({batch * cfg.max_seq_len / step_ms['captured'] * 1e3:.0f} "
          f"tokens/s captured); peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GB")
    set_regime(pt, "per_op")
    pt.set_flags({"FLAGS_pallas_fused_update": False})
    lazy.reset_lazy_state()
    del models, opts
    torch.cuda.empty_cache()
    return {"built": built, "timed": timed_launches, "step_ms": step_ms, "losses": losses}


def ptb_model(pt, dropout):
    nn = pt.nn

    class LSTMLM(nn.Layer):
        def __init__(self):
            super().__init__()
            V, H, L = PTB["vocab"], PTB["hidden"], PTB["layers"]
            self.embedder = nn.Embedding(V, H)
            self.lstm = nn.LSTM(H, H, num_layers=L, dropout=dropout)
            self.dropout = nn.Dropout(dropout)
            self.fc = nn.Linear(H, V)
            init = nn.initializer.Uniform(-PTB["init"], PTB["init"])
            for p in self.parameters():
                init(p)

        def forward(self, x, h, c):
            y, (h, c) = self.lstm(self.dropout(self.embedder(x)), (h, c))
            return self.fc(self.dropout(y)), h, c

    return LSTMLM()


def ptb_trainer(torch, pt, dropout, seed=SEED):
    import numpy as np

    pt.seed(seed)
    model = ptb_model(pt, dropout)
    opt = pt.optimizer.SGD(learning_rate=PTB["lr"], parameters=model.parameters(),
                           grad_clip=pt.nn.ClipGradByGlobalNorm(PTB["clip"]))
    crit = pt.nn.CrossEntropyLoss()
    rng = np.random.default_rng(seed)
    B, T, V, H, L = PTB["batch"], PTB["num_steps"], PTB["vocab"], PTB["hidden"], PTB["layers"]
    stream = rng.integers(0, V, (8, B, T + 1))  # 8 batches of the token stream, cycled
    batches = [(pt.to_tensor(s[:, :-1]), pt.to_tensor(s[:, 1:])) for s in stream]
    state = {"i": 0, "h": pt.zeros([L, B, H]), "c": pt.zeros([L, B, H])}

    def step():
        x, y = batches[state["i"] % len(batches)]
        state["i"] += 1
        logits, h, c = model(x, state["h"], state["c"])
        loss = crit(logits.reshape([-1, V]), y.reshape([-1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        state["h"], state["c"] = h.detach(), c.detach()  # truncated BPTT, as rnnlm carries it
        return loss

    return model, opt, step, state


def ptb_lstm_lm(torch, pt, fa, fu, dev):
    """13c: the medium PTB LSTM LM, per-op, lazy and captured, fused SGD."""
    from paddle_tpu_torch.core import lazy

    n_tok = PTB["batch"] * PTB["num_steps"]
    print(f"[13c] LSTM language model, PTB medium (Zaremba et al. 2014; PaddleNLP rnnlm): vocab "
          f"{PTB['vocab']}, {PTB['layers']} x {PTB['hidden']} LSTM, {PTB['batch']} x "
          f"{PTB['num_steps']} tokens, SGD({PTB['lr']}) + ClipGradByGlobalNorm({PTB['clip']}), "
          f"FLAGS_pallas_fused_update on, random token ids from the seed")
    pt.set_flags({"FLAGS_pallas_fused_update": True})
    runs = {}
    for name in REGIMES:
        set_regime(pt, name)
        lazy.reset_lazy_state()
        model, opt, step, _ = ptb_trainer(torch, pt, 0.0)
        losses = [float(step()) for _ in range(2 + PTB_BITWISE_STEPS)]
        runs[name] = (model, opt, losses)
    ref = runs["per_op"]
    same = {n: r[2] == ref[2] and bitwise_same(torch, r[0], ref[0], r[1], ref[1])
            for n, r in runs.items() if n != "per_op"}
    n_params = len(list(ref[0].parameters()))
    print(f"  dropout 0: losses per-op {ref[2]}; bitwise per-op (losses, parameters): {same}; "
          f"{n_params} parameters, {sum(p.numel() for p in ref[0].parameters())} values")
    check(all(same.values()), "a lazy or captured LM step differs from the per-op step")
    del runs, ref
    out = {}
    for name in REGIMES:
        set_regime(pt, name)
        lazy.reset_lazy_state()
        _, opt, step, state = ptb_trainer(torch, pt, PTB["dropout"])
        for _ in range(3):  # the first step's carried state is the zeros, not a step's
            float(step())
        before = kernel_counts(fa, fu)
        float(step())  # captured: the build, then the first replay
        built = counts_since(fa, fu, before).get("sgd", 0)
        progs = per_step_programs(pt.profiler.measure_programs(step, warmup=0))
        before = kernel_counts(fa, fu)
        dt = median_best_window(step, PTB_STEPS, 3)
        timed = counts_since(fa, fu, before).get("sgd", 0)
        host = host_breakdown(pt, step, PTB_STEPS)
        out[name] = {"ms": dt * 1e3 / PTB_STEPS, "tokens_per_s": n_tok * PTB_STEPS / dt,
                     "programs": progs, "host": host, "sgd_in_build": built, "sgd_timed": timed}
        print(f"  {name}, dropout {PTB['dropout']}: {dt * 1e3 / PTB_STEPS:.3f} ms a step, "
              f"{n_tok * PTB_STEPS / dt:.0f} tokens/s; programs a step {progs}; host ms a step "
              f"{{trace {host['trace_ms']:.4f}, replay {host['replay_ms']:.4f}, wall "
              f"{host['wall_ms']:.4f}}}; fallbacks {host['capture_fallbacks']}; SGD launches "
              f"{built} in the measured steps, {timed} in {PTB_STEPS * 3} timed steps")
        check(host["capture_fallbacks"] == 0, f"{name}: capture fell back in a timed window "
                                              f"({lazy.last_capture_error[0]})")
        if name == "captured":
            check(progs["programs"] == 1 and progs["captured_programs"] == 1,
                  f"the captured LM step is {progs}")
            check(built == n_params and timed == 0,
                  f"the captured LM graph holds {built} SGD launches, expected {n_params}")
            # new masks each replay: at lr 0, one batch from one carried state
            # twice gives two losses, and the same loss once the generator's
            # state is put back (paddle.set_rng_state)
            opt.set_lr(0.0)
            at = (state["i"], state["h"], state["c"])
            rng = pt.get_rng_state()
            a = float(step())
            state["i"], state["h"], state["c"] = at
            again = float(step())
            state["i"], state["h"], state["c"] = at
            pt.set_rng_state(rng)
            same = float(step())
            print(f"  captured at lr 0, one batch and state three times: {a!r}, {again!r} "
                  f"(new masks), {same!r} (the generator's state put back)")
            check(a != again and a == same, "the captured LM step's dropout masks did not "
                                            "change between replays, or did not follow the "
                                            "generator's state")
        if name == "lazy":
            check(progs["programs"] == 3, f"the lazy LM step is {progs}")
            check(host["segment_graph_replays"] == PTB_STEPS,
                  f"{host['segment_graph_replays']} of {PTB_STEPS} lazy LM steps replayed the "
                  f"segment's graphs ({lazy.last_capture_error[0]})")
    set_regime(pt, "per_op")
    pt.set_flags({"FLAGS_pallas_fused_update": False})
    lazy.reset_lazy_state()
    torch.cuda.empty_cache()
    return out


def eager_dispatch(torch, pt, fa, fu, dev):
    """Phase 13: 13a, 13b, 13c. Returns the launches of each kernel on its
    paths (the wrappers' counts, set to 0 before and read after each)."""
    t0 = time.perf_counter()
    for wrapper in (*(getattr(fa, a) for a in FLASH_WRAPPERS.values()), fu.fused_adam,
                    fu.fused_sgd, fu.fused_momentum):  # phase 13's counts start here
        wrapper.launches = 0
    reset_flash_counts(fa)
    print("[13a] BASELINE.json config 1 (bench_mnist_eager): LeNet, Adam(1e-3), "
          f"{LENET_BATCH} x 1 x 28², per-op, lazy (capture off) and captured; "
          f"{LENET_STEPS}-step windows, median of the best half of {LENET_REPS}")
    torch.backends.cudnn.deterministic = True  # bitwise across regimes needs it
    try:
        lenet = {fused: lenet_regimes(torch, pt, fa, fu, dev, fused) for fused in (False, True)}
        big = capture_345m(torch, pt, fa, fu, dev)
        ptb = ptb_lstm_lm(torch, pt, fa, fu, dev)
    finally:
        torch.backends.cudnn.deterministic = False
        set_regime(pt, "per_op")
    launches = kernel_counts(fa, fu)  # ... and end here
    print(f"  phase 13 in {time.perf_counter() - t0:.1f} s; launches on its paths (a graph's "
          f"counted once, when it was captured) {launches}")
    return {"lenet": lenet, "345m": big, "ptb": ptb, "launches": launches}


def eager_dispatch_alone(torch) -> int:
    """``python3 chip_smoke.py --eager-dispatch``: phase 13 alone, after
    building the libraries its paths launch (the tf32x3 flash kernels and
    the fused updates)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_update as fu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sources = [fa.TF32_FWD_KERNEL_NAME, fa.TF32_BWD_KERNEL_NAME, fu.KERNEL_NAME]
    _build.build(sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    out = eager_dispatch(torch, pt, fa, fu, torch.device("cuda", 0))
    print(json.dumps({k: v for k, v in out.items() if k != "launches"}, default=str))
    return 0


def host_cost_child(root: str) -> int:
    """``chip_smoke.py --host-cost-child ROOT``: the host cost of the per-op
    path of the port checked out at ROOT, on the card: phase 5a's four
    surface ops (``host_cost_per_op``) and 13a's per-op LeNet step in
    bench's metric. Prints one JSON line. Builds nothing: neither path
    launches a kernel of the port."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import paddle_tpu_torch as pt

    dev = torch.device("cuda", 0)
    us = host_cost_per_op(torch, pt, dev)
    _, _, step = lenet_trainer(torch, pt, dev)
    for _ in range(3):
        float(step())
    sps = LENET_STEPS / median_best_window(step, LENET_STEPS, LENET_REPS)
    print(json.dumps({"package": os.path.dirname(pt.__file__), "host_us": us,
                      "lenet_per_op_steps_per_s": sps}))
    return 0


def host_cost_in_turns(parent: str) -> int:
    """``chip_smoke.py --host-cost-vs PARENT``: ``host_cost_child`` on the port
    checked out at PARENT and on this one's, in turns (PARENT, this, this,
    PARENT), each in a fresh process, with the card's name and power limit."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip()
    print(card)
    rows = []
    for label, root in (("parent", parent), ("this", here), ("this", here),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--host-cost-child",
                               root], capture_output=True, text=True, cwd=here)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append((label, got))
        print(f"{label}: per-op LeNet {got['lenet_per_op_steps_per_s']:.1f} steps/s; host us "
              f"per call (surface / bare torch): " + ", ".join(
                  f"{op} {v['surface']:.2f} / {v['torch']:.2f}"
                  for op, v in got["host_us"].items()))
    print(json.dumps({"card": card, "turns": rows}))
    return 0


# ---------------------------------------------------------------------------
# 14. frozen parameters, O1 casts, paddle.linalg and autograd.functional,
# the serve-probe CLI
# ---------------------------------------------------------------------------
FROZEN_BLOCKS = 12     # 14a: the embeddings (and the tied head) and blocks 0-11 frozen
FROZEN_STEPS = 3       # per-op steps, and captured steps after the warm-up, held bitwise
O1_SHAPE = (8192, 1024, 4096)  # 14b: an (m, k) by (k, n) product
TOL_O1_PRODUCT = 3e-2  # bf16 operands and result against the f32 product, of its largest entry
TOL_O1_F32 = 1e-5      # f32 results of bf16 inputs against torch's f32 op on the same values
LINALG_N = 2048        # 14c: one f32 matrix of this size ...
LINALG_BATCH = (256, 64, 64)  # ... and a batch of this shape
LINALG_EIG_N = 1024    # eig and eigvals: the general eigenproblem runs on the host
# 14c: a residual (relative, Frobenius) of a decomposition or solve of a
# well-conditioned f32 matrix (condition numbers below ~10): the rounding of
# sums of up to LINALG_N terms, ~sqrt(n) * eps * cond, with a margin
TOL_LINALG_RESIDUAL = 1e-4
# the card against the port on the CPU for the same inputs: cuSOLVER and
# LAPACK factor in other orders, so their results differ by ~cond * eps
# relative to the largest entry, with a margin
TOL_LINALG_CPU = 1e-3
TOL_HESSIAN_CPU = 1e-4  # 14c: the MLP's Jacobian and Hessian, card against CPU, of the largest
SERVE_PROBE_TIMEOUT_S = 300


def frozen_finetune_345m(torch, pt, fa, fu, dev, unfrozen):
    """14a: phase 13b's Paddle-style 345M f32 step with the embeddings
    (``trainable = False``; the head is tied to them) and blocks
    0..FROZEN_BLOCKS-1 (``stop_gradient = True``) frozen, per-op and
    captured on twin models: frozen parameters bitwise unchanged, the
    trainable ones bitwise equal between the paths, each step launching one
    Adam kernel per trainable parameter, 24 tf32x3 forwards and 12 of each
    backward kernel, the captured step one program. ``unfrozen`` is 13b's
    result (None when phase 13 did not run in this process)."""
    import numpy as np
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    batch = 8
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    print(f"[14a] the half-frozen GPT-2 345M fine-tune: phase 13b's Paddle-style f32 step "
          f"({batch} x {cfg.max_seq_len}, Adam through the fused kernel) with wte and wpe "
          f"frozen (trainable = False; the LM head is tied to wte) and blocks 0-"
          f"{FROZEN_BLOCKS - 1} (stop_gradient = True), per-op and captured on twin models")
    torch.cuda.reset_peak_memory_stats(dev)
    data = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1))
    pt.set_flags({"FLAGS_pallas_fused_update": True})
    models, opts = [], []
    for _ in range(2):
        pt.seed(SEED)
        m = GPTForPretraining(cfg)
        emb = m.gpt.embeddings
        emb.word_embeddings.weight.trainable = False
        emb.position_embeddings.weight.trainable = False
        for block in m.gpt.layers[:FROZEN_BLOCKS]:
            for p in block.parameters():
                p.stop_gradient = True
        models.append(m)
        opts.append(pt.optimizer.Adam(learning_rate=1e-4, parameters=m.parameters()))
    params = list(models[0].parameters())
    trainable = [p for p in params if not p.stop_gradient]
    frozen_before = [[p.detach().clone() for p in m.parameters() if p.stop_gradient]
                     for m in models]
    n_frozen = len(frozen_before[0])
    print(f"  {len(params)} parameters, {len(trainable)} trainable, {n_frozen} frozen")
    check(len(trainable) + n_frozen == len(params) and n_frozen > 0, "the freeze took nothing")
    crit = GPTPretrainingCriterion(cfg)
    ids = pt.to_tensor(data[:, :-1], dtype="int64")
    labels = pt.to_tensor(data[:, 1:], dtype="int64")

    def stepper(i, regime):
        def step():
            set_regime(pt, regime)
            loss = crit(models[i](ids), labels)
            loss.backward()
            opts[i].step()
            opts[i].clear_grad()
            return loss
        return step

    per_op, captured = stepper(0, "per_op"), stepper(1, "captured")
    lazy.reset_lazy_state()
    warm = pt.get_flags("FLAGS_eager_capture_warmup")["FLAGS_eager_capture_warmup"]
    n = warm + FROZEN_STEPS
    want = {"fwd_tf32x3": cfg.num_layers, "dkv_tf32x3": cfg.num_layers - FROZEN_BLOCKS,
            "dq_tf32x3": cfg.num_layers - FROZEN_BLOCKS, "adam": len(trainable)}
    losses_ref, per_step = [], []
    for _ in range(n):
        before = kernel_counts(fa, fu)
        losses_ref.append(float(per_op()))
        per_step.append(counts_since(fa, fu, before))
    pt.profiler.reset_dispatch_counters()
    losses, built = [], None
    for i in range(n):
        before = kernel_counts(fa, fu)
        losses.append(float(captured()))
        if i == warm:  # the build: what the capture launched is what each replay holds
            built = counts_since(fa, fu, before)
    c = pt.profiler.dispatch_counters()
    frozen_ok = all(torch.equal(a, b) for m, olds in zip(models, frozen_before)
                    for a, b in zip([p for p in m.parameters() if p.stop_gradient], olds))
    same = losses == losses_ref and bitwise_same(torch, models[1], models[0], opts[1], opts[0])
    print(f"  losses per-op {losses_ref}; lazy + capture {losses}; frozen parameters bitwise "
          f"unchanged on both paths: {frozen_ok}; bitwise (losses, parameters, moments) {same}; "
          f"counters: {c['capture_builds']} build, {c['capture_replays']} replays, fallbacks "
          f"{dict(c['capture_fallback_reasons'])}")
    print(f"  launches of each per-op step {per_step}; the captured graph holds {built}; "
          f"expected a step {want}")
    check(frozen_ok, "a frozen parameter moved")
    check(same, "the captured half-frozen step differs from the per-op step")
    check(all(s == want for s in per_step), f"per-op half-frozen steps launched {per_step}, "
                                            f"expected {want} each")
    check(built == want, f"the captured half-frozen graph holds {built}, expected {want}")
    check(c["capture_replays"] == FROZEN_STEPS and c["capture_fallbacks"] == 0,
          f"the half-frozen step did not replay once a step without a fallback (the last "
          f"capture error: {lazy.last_capture_error[0]})")
    before = kernel_counts(fa, fu)
    progs = per_step_programs(pt.profiler.measure_programs(captured, warmup=0))
    check(progs["programs"] == 1 and progs["captured_programs"] == 1,
          f"the captured half-frozen step took {progs} programs, expected 1")
    check(counts_since(fa, fu, before) == {}, "a replay launched through a wrapper")
    float(per_op())  # the twin takes the step measure_programs took
    times = {"per_op": [], "captured": []}
    for kind in ("per_op", "captured", "captured", "per_op") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float((per_op if kind == "per_op" else captured)())
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3)
    check(pt.profiler.dispatch_counters()["capture_fallbacks"] == 0,
          "a timed half-frozen captured step fell back")
    check(bitwise_same(torch, models[1], models[0], opts[1], opts[0]),
          "the timed half-frozen steps left the two models apart")
    step_ms = {k: statistics.median(v) for k, v in times.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ref = ("13b unfrozen in this run: captured {captured:.2f} ms, per-op {per_op:.2f} ms"
           .format(**unfrozen["step_ms"]) if unfrozen else "13b not run in this process")
    print(f"  step (forward, backward, Adam, clear, host read of the loss), host clock, median of "
          f"{len(times['captured'])} in turns: captured {step_ms['captured']:.2f} ms, per-op "
          f"{step_ms['per_op']:.2f} ms ({ref}); one program a step {progs['programs']}; peak "
          f"memory {peak:.2f} GB (two models)")
    set_regime(pt, "per_op")
    pt.set_flags({"FLAGS_pallas_fused_update": False})
    lazy.reset_lazy_state()
    del models, opts
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "per_step": want, "built": built, "peak_gb": peak}


def o1_casts_on_card(torch, pt, dev):
    """14b: ``auto_cast(level="O1", dtype="bfloat16")`` on the card: the
    white-listed products of f32 Tensors give bf16 (within TOL_O1_PRODUCT of
    the f32 product), the black-listed ops on bf16 Tensors give f32 (within
    TOL_O1_F32 of torch's op in f32 on the same values); ms of the O1
    product beside the f32 one."""
    m, k, n = O1_SHAPE
    print(f"[14b] AMP O1 bf16 casts of the paddle.* functions on the card: ({m}, {k}) by "
          f"({k}, {n}) products, and the black list on bf16 ({m}, {k})")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    xv = torch.randn(m, k, device=dev, generator=gen)
    wv = torch.randn(k, n, device=dev, generator=gen) / k ** 0.5
    x, w = pt.to_tensor(xv), pt.to_tensor(wv)
    ref = xv @ wv
    bx = x.reshape([8, m // 8, k])
    products = {
        "matmul": lambda: pt.matmul(x, w), "@": lambda: x @ w, "mm": lambda: pt.mm(x, w),
        "bmm": lambda: pt.bmm(bx, w.reshape([1, k, n]).expand([8, k, n])),
        "einsum": lambda: pt.einsum("ij,jk->ik", x, w),
    }
    got = {}
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        for name, fn in products.items():
            out = fn()
            err = float((out._value.float().reshape(m, n) - ref).abs().max() / ref.abs().max())
            got[name] = (str(out.dtype), err)
            check(out.dtype == pt.bfloat16, f"O1 {name} of f32 Tensors gave {out.dtype}")
            check(err <= TOL_O1_PRODUCT, f"O1 {name}: {err:.3e} of the largest entry from the f32 "
                                         f"product, tolerance {TOL_O1_PRODUCT:g}")
        o1_ms = time_ms(lambda: pt.matmul(x, w), reps=10, warmup=2)
    f32_ms = time_ms(lambda: pt.matmul(x, w), reps=10, warmup=2)
    xb = x.astype("bfloat16")
    xf = xb._value.float()
    pos = (xb.abs() + 1.0).astype("bfloat16")
    black = {
        "exp": (lambda: pt.exp(xb), lambda: torch.exp(xf)),
        "log": (lambda: pt.log(pos), lambda: torch.log(pos._value.float())),
        "mean": (lambda: pt.mean(xb, axis=1), lambda: xf.mean(dim=1)),
        "sum": (lambda: pt.sum(xb), lambda: xf.sum()),
        "Tensor.sum": (lambda: xb.sum(axis=0), lambda: xf.sum(dim=0)),
        "pow": (lambda: pt.pow(xb, 2.0), lambda: xf.pow(2.0)),
        "cumsum": (lambda: pt.cumsum(xb, axis=1), lambda: xf.cumsum(dim=1)),
        "square": (lambda: pt.square(xb), lambda: xf.square()),
        "norm": (lambda: pt.norm(xb), lambda: xf.square().sum().sqrt()),
    }
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        for name, (fn, plain) in black.items():
            out, want = fn(), plain()
            err = float((out._value - want).abs().max() / want.abs().max().clamp_min(1e-30))
            got[name] = (str(out.dtype), err)
            check(out.dtype == pt.float32, f"O1 {name} of bf16 Tensors gave {out.dtype}")
            check(err <= TOL_O1_F32, f"O1 {name}: {err:.3e} of the largest entry from torch's "
                                     f"f32 op, tolerance {TOL_O1_F32:g}")
    print("  dtype and error of the largest entry: " + "; ".join(
        f"{k} {d} {e:.2e}" for k, (d, e) in got.items()))
    print(f"  the product: {o1_ms:.3f} ms under O1 (bf16), {f32_ms:.3f} ms in f32 (CUDA events, "
          f"median of 10)")
    return {"o1_ms": o1_ms, "f32_ms": f32_ms, "dtypes": {k: d for k, (d, _) in got.items()}}


def host_syncs(torch, fn):
    """The host synchronisations ``fn`` makes (torch's sync debug mode)."""
    import warnings

    torch.cuda.synchronize()
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    return sorted({str(w.message).splitlines()[0][:80] for w in caught
                   if "synchroniz" in str(w.message).lower()})


def _wide(torch, x):
    """``x`` in float64 (complex128 if complex), detached."""
    return x.detach().to(torch.complex128 if x.is_complex() else torch.float64)


def _rel(torch, a, b):
    """max |a - b| over max |b|, in float64 on a's device."""
    a, b = _wide(torch, a), _wide(torch, b.to(a.device))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _fro_rel(torch, a, b):
    """||a - b|| over ||b|| (Frobenius), in float64."""
    a, b = _wide(torch, a), _wide(torch, b)
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(1e-30))


def _linalg_inputs(torch, dev, n, batch, n_eig):
    """The 14c matrices on ``dev`` from one seed: general ``a`` (G / sqrt(n) +
    2 I: singular values ~1-3), SPD ``s`` (G G^T / n + I), its Cholesky
    factor's right-hand sides, a tall ``tall`` and the batch."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def general(*shape):
        g = torch.randn(*shape, device=dev, generator=gen) / shape[-1] ** 0.5
        return g + 2 * torch.eye(shape[-1], device=dev)

    def spd(*shape):
        g = torch.randn(*shape, device=dev, generator=gen)
        return g @ g.mT / shape[-1] + torch.eye(shape[-1], device=dev)

    return {
        "a": general(n, n), "s": spd(n, n), "b": torch.randn(n, 16, device=dev, generator=gen),
        "tall": torch.randn(n, n // 4, device=dev, generator=gen),
        "y": torch.randn(n, 16, device=dev, generator=gen),
        "ab": general(*batch), "sb": spd(*batch),
        "bb": torch.randn(*batch[:-1], 8, device=dev, generator=gen),
        "e": general(n_eig, n_eig),
    }


def linalg_cases(torch, pt):
    """(name, run(L, t) -> outputs, residual(t, outs) -> relative error (0 or
    1 for a count or a flag), and whether the outputs are held against the
    CPU port as they are: False where signs, orders or pivots are free (Q,
    U, V, eigenvectors, LU factors: a near-tie may pivot otherwise)). ``t``
    maps the input names ``a`` (general), ``s`` (SPD), ``b`` (right-hand
    sides), ``tall``, ``y`` and ``e`` (eig's) to Tensors."""
    eye = lambda x: torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)  # noqa: E731
    v = lambda x: x._value  # noqa: E731
    return [
        ("cholesky", lambda L, t: L.cholesky(t["s"]),
         lambda t, o: _fro_rel(torch, v(o[0]) @ v(o[0]).mT, v(t["s"])), True),
        ("inv", lambda L, t: L.inv(t["a"]),
         lambda t, o: _fro_rel(torch, v(t["a"]) @ v(o[0]), eye(v(t["a"]))), True),
        ("pinv", lambda L, t: L.pinv(t["a"]),
         lambda t, o: _fro_rel(torch, v(t["a"]) @ v(o[0]), eye(v(t["a"]))), True),
        ("det", lambda L, t: L.det(t["a"]),
         lambda t, o: float(not torch.isclose(
             v(o[0]).double(), torch.linalg.slogdet(v(t["a"]).double())[0]
             * torch.linalg.slogdet(v(t["a"]).double())[1].exp(), rtol=1e-3).all()), True),
        ("slogdet", lambda L, t: L.slogdet(t["a"]),
         lambda t, o: _rel(torch, v(o[0])[1], torch.linalg.slogdet(v(t["a"]).double())[1]),
         True),
        ("matrix_rank", lambda L, t: L.matrix_rank(t["a"]),
         lambda t, o: float(int(v(o[0])) != v(t["a"]).shape[-1]), True),
        ("matrix_power", lambda L, t: L.matrix_power(t["a"], 3),
         lambda t, o: _fro_rel(torch, v(o[0]), v(t["a"]) @ v(t["a"]) @ v(t["a"])), True),
        ("solve", lambda L, t: L.solve(t["a"], t["b"]),
         lambda t, o: _fro_rel(torch, v(t["a"]) @ v(o[0]), v(t["b"])), True),
        ("triangular_solve", lambda L, t: L.triangular_solve(L.cholesky(t["s"]), t["b"],
                                                             upper=False),
         lambda t, o: _fro_rel(torch, torch.linalg.cholesky(v(t["s"])) @ v(o[0]), v(t["b"])),
         True),
        ("cholesky_solve", lambda L, t: L.cholesky_solve(t["b"], L.cholesky(t["s"])),
         lambda t, o: _fro_rel(torch, v(t["s"]) @ v(o[0]), v(t["b"])), True),
        ("lstsq", lambda L, t: L.lstsq(t["tall"], t["y"]),
         lambda t, o: _fro_rel(torch, v(t["tall"]).mT @ (v(t["tall"]) @ v(o[0])),
                               v(t["tall"]).mT @ v(t["y"])), True),
        ("lu", lambda L, t: L.lu(t["a"]), None, False),
        ("lu_unpack", lambda L, t: L.lu_unpack(*L.lu(t["a"])),
         lambda t, o: _fro_rel(torch, v(o[0]) @ v(o[1]) @ v(o[2]), v(t["a"])), False),
        ("qr", lambda L, t: L.qr(t["a"]),
         lambda t, o: max(_fro_rel(torch, v(o[0]) @ v(o[1]), v(t["a"])),
                          _fro_rel(torch, v(o[0]).mT @ v(o[0]), eye(v(t["a"])))), False),
        ("svd", lambda L, t: L.svd(t["a"]),
         lambda t, o: _fro_rel(torch, (v(o[0]) * v(o[1])[..., None, :]) @ v(o[2]), v(t["a"])),
         False),
        ("eigh", lambda L, t: L.eigh(t["s"]),
         lambda t, o: _fro_rel(torch, v(t["s"]) @ v(o[1]), v(o[1]) * v(o[0])[..., None, :]),
         False),
        ("eigvalsh", lambda L, t: L.eigvalsh(t["s"]),
         lambda t, o: _rel(torch, v(o[0]), torch.linalg.eigvalsh(v(t["s"]).double())), True),
        ("eig", lambda L, t: L.eig(t["e"]),
         lambda t, o: _fro_rel(torch, v(t["e"]).to(v(o[1]).dtype) @ v(o[1]),
                               v(o[1]) * v(o[0])[..., None, :]), False),
        ("eigvals", lambda L, t: L.eigvals(t["e"]),
         lambda t, o: _rel(torch, v(o[0]).sum(-1), torch.diagonal(v(t["e"]), dim1=-2,
                                                                  dim2=-1).sum(-1)), False),
        ("cond", lambda L, t: L.cond(t["a"]),
         lambda t, o: _rel(torch, v(o[0]), torch.linalg.cond(v(t["a"]).double())), True),
        ("cov", lambda L, t: L.cov(t["a"]),
         lambda t, o: _fro_rel(torch, v(o[0]), torch.cov(v(t["a"]).double())), True),
        ("corrcoef", lambda L, t: L.corrcoef(t["a"]),
         lambda t, o: _fro_rel(torch, v(o[0]), torch.corrcoef(v(t["a"]).double())), True),
        ("histogram", lambda L, t: L.histogram(t["a"], bins=100),
         lambda t, o: abs(float(v(o[0]).sum()) - v(t["a"]).numel()), True),
        ("multi_dot", lambda L, t: L.multi_dot([t["a"], t["s"], t["b"]]),
         lambda t, o: _fro_rel(torch, v(o[0]), v(t["a"]) @ (v(t["s"]) @ v(t["b"]))), True),
        ("matmul", lambda L, t: L.matmul(t["a"], t["s"]), None, True),
        ("mm", lambda L, t: L.mm(t["a"], t["b"]), None, True),
        ("bmm", lambda L, t: L.bmm(t["a"].reshape([-1, *t["a"].shape[-2:]]),
                                   t["b"].reshape([-1, *t["b"].shape[-2:]])), None, True),
        ("mv", lambda L, t: L.mv(t["a"], t["b"][:, 0]), None, True),
        ("dot", lambda L, t: L.dot(t["a"], t["s"]), None, True),
        ("norm", lambda L, t: L.norm(t["a"]), None, True),
        ("dist", lambda L, t: L.dist(t["a"], t["s"]), None, True),
        ("cross", lambda L, t: L.cross(t["a"][:, :3], t["s"][:, :3]), None, True),
        ("t", lambda L, t: L.t(t["a"]), None, True),
        ("trace", lambda L, t: L.trace(t["a"]), None, True),
    ]


def _compare(torch, got, want):
    """The largest relative difference of the floating outputs ``got`` (on
    the card) from ``want`` (on the CPU); integer outputs must be equal."""
    err = 0.0
    for o, w in zip(got, want):
        o, w = o._value, w._value
        if o.is_floating_point() or o.is_complex():
            err = max(err, _rel(torch, o.cpu(), w))
        else:
            check(torch.equal(o.cpu(), w), "integer outputs differ between the card and the CPU")
    return err


def svd_drivers(torch, a):
    """torch's cuSOLVER SVD drivers on ``a``: the residual of U S Vh, the
    orthogonality of U and V, ms (host clock, synchronised, one run)."""
    for driver in (None, "gesvdj", "gesvd", "gesvda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, s, vh = torch.linalg.svd(a, full_matrices=False, driver=driver)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        eye = torch.eye(a.shape[-1], device=a.device)
        print(f"  svd driver {driver}: {ms:.1f} ms; residual "
              f"{_fro_rel(torch, (u * s[..., None, :]) @ vh, a):.2e}, U^T U "
              f"{_fro_rel(torch, u.mT @ u, eye):.2e}, V V^T {_fro_rel(torch, vh @ vh.mT, eye):.2e}")


def linalg_on_card(torch, pt, dev):
    """14c: every ``paddle.linalg`` function on a LINALG_N-square f32 matrix
    (SPD where it needs one; ``eig`` and ``eigvals`` at LINALG_EIG_N) and
    on a LINALG_BATCH batch: residuals within TOL_LINALG_RESIDUAL, the
    batch (and the big matrix where the host's LAPACK takes it in a second
    or two) against the port on the CPU within TOL_LINALG_CPU, ms by CUDA
    events, the host synchronisations each call makes; then the Jacobian and
    Hessian of a 2-layer MLP loss (``paddle.autograd``) against the CPU
    port."""
    n = LINALG_N
    print(f"[14c] paddle.linalg on the card: f32 {n} x {n} (SPD where needed; eig and eigvals "
          f"at {LINALG_EIG_N}) and a {LINALG_BATCH} batch, against residuals and the CPU port")
    t0 = time.perf_counter()
    raw = _linalg_inputs(torch, dev, n, LINALG_BATCH, LINALG_EIG_N)
    big = {k: pt.to_tensor(raw[k]) for k in ("a", "s", "b", "tall", "y", "e")}
    batch = {"a": pt.to_tensor(raw["ab"]), "s": pt.to_tensor(raw["sb"]),
             "b": pt.to_tensor(raw["bb"]), "e": pt.to_tensor(raw["ab"])}
    on_cpu = {name: {k: pt.to_tensor(t._value.cpu(), place="cpu") for k, t in d.items()}
              for name, d in (("big", big), ("batch", batch))}
    svd_drivers(torch, raw["a"])
    cpu_big = {"cholesky", "inv", "slogdet", "matrix_power", "solve", "triangular_solve",
               "cholesky_solve", "multi_dot", "matmul", "mm", "mv", "dot", "norm", "dist",
               "cross", "t", "trace", "histogram", "bmm"}
    big_only = {"lstsq", "cov", "corrcoef", "histogram", "multi_dot", "mv", "cross", "t",
                "trace", "matmul", "mm", "dot", "norm", "dist", "matrix_rank"}
    L = pt.linalg
    rows = {}

    def listed(out):
        return list(out) if isinstance(out, (tuple, list)) else [out]

    for name, run, residual, exact in linalg_cases(torch, pt):
        t1 = time.perf_counter()
        holder = []
        syncs = host_syncs(torch, lambda: holder.append(listed(run(L, big))))
        outs = holder[0]
        first_s = time.perf_counter() - t1
        res = residual(big, outs) if residual else None
        if res is not None:
            check(res <= TOL_LINALG_RESIDUAL, f"linalg {name}: residual {res:.3e} over "
                                              f"{TOL_LINALG_RESIDUAL:g}")
        cpu_err = (_compare(torch, outs, listed(run(L, on_cpu["big"])))
                   if name in cpu_big else None)
        if cpu_err is not None:
            check(cpu_err <= TOL_LINALG_CPU, f"linalg {name}: {cpu_err:.3e} from the CPU port")
        ms = time_ms(lambda: run(L, big), reps=1 if first_s > 0.5 else 3, warmup=0)
        batch_res = batch_err = None
        if name not in big_only:
            got = listed(run(L, batch))
            if residual:
                batch_res = residual(batch, got)
                check(batch_res <= TOL_LINALG_RESIDUAL, f"linalg {name} (batch): residual "
                                                        f"{batch_res:.3e}")
            if exact:
                batch_err = _compare(torch, got, listed(run(L, on_cpu["batch"])))
                check(batch_err <= TOL_LINALG_CPU, f"linalg {name} (batch): {batch_err:.3e} "
                                                   f"from the CPU port")
        rows[name] = {"ms": ms, "residual": res, "cpu": cpu_err, "batch_residual": batch_res,
                      "batch_cpu": batch_err, "syncs": syncs}
        fmt = lambda x: "-" if x is None else f"{x:.2e}"  # noqa: E731
        print(f"  {name}: {ms:.3f} ms; residual {fmt(res)} (batch {fmt(batch_res)}); card "
              f"against the CPU port {fmt(cpu_err)} (batch {fmt(batch_err)}); host "
              f"synchronisations {len(syncs)}{' ' + syncs[0] if syncs else ''}")
    print("  calls that synchronise with the host: "
          + ", ".join(k for k, r in rows.items() if r["syncs"]))
    hess = mlp_hessian_on_card(torch, pt, dev)
    print(f"  phase 14c in {time.perf_counter() - t0:.1f} s")
    return {"rows": rows, "hessian": hess}


def mlp_hessian_on_card(torch, pt, dev):
    """The Jacobian and Hessian of a 2-layer MLP's mean squared error over
    its four weights (``paddle.autograd.jacobian`` / ``hessian``), on the
    card against the CPU port on the same numpy inputs."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    x, y = rng.standard_normal((64, 16)).astype(np.float32), rng.standard_normal((64, 4)).astype(
        np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.5 for s in [(16, 8), (8,), (8, 4), (4,)]]
    out = {}
    for place in ("gpu:0", "cpu"):
        def loss(w1, b1, w2, b2, place=place):
            h = pt.tanh(pt.matmul(pt.to_tensor(x, place=place), w1) + b1)
            return ((pt.matmul(h, w2) + b2 - pt.to_tensor(y, place=place)) ** 2).mean()

        args = [pt.to_tensor(w, place=place) for w in ws]
        t0 = time.perf_counter()
        jac, hes = pt.autograd.jacobian(loss, args), pt.autograd.hessian(loss, args)
        out[place] = (jac.numpy(), hes.numpy(), (time.perf_counter() - t0) * 1e3)
    (jg, hg, ms), (jc, hc, cpu_ms) = out["gpu:0"], out["cpu"]
    jerr = float(np.abs(jg - jc).max() / np.abs(jc).max())
    herr = float(np.abs(hg - hc).max() / np.abs(hc).max())
    print(f"  the MLP loss's Jacobian {jg.shape} and Hessian {hg.shape} on the card: "
          f"{ms:.1f} ms (host clock; {cpu_ms:.1f} on the CPU), against the CPU port "
          f"{jerr:.2e} and {herr:.2e} of the largest entry (tolerance {TOL_HESSIAN_CPU:g})")
    check(jerr <= TOL_HESSIAN_CPU and herr <= TOL_HESSIAN_CPU,
          "the MLP's Jacobian or Hessian on the card differs from the CPU port")
    return {"ms": ms, "jac_err": jerr, "hess_err": herr}


def serve_probe_on_card():
    """14d: ``python -m paddle_tpu_torch.tools.serve_probe`` in a process of
    its own on the card: exit 0 and ``ALL SCENARIOS PASSED``."""
    print("[14d] the serve-probe CLI on the card (python -m paddle_tpu_torch.tools.serve_probe)")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.tools.serve_probe"],
                          cwd=root, capture_output=True, text=True, timeout=SERVE_PROBE_TIMEOUT_S,
                          env=dict(os.environ, PYTHONPATH=root))
    dt = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print("  " + line)
    check(proc.returncode == 0 and "ALL SCENARIOS PASSED" in proc.stdout,
          f"the serve probe exited {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"  exit 0 in {dt:.1f} s")
    return {"s": dt}


def slice16(torch, pt, fa, fu, dev, unfrozen=None):
    """Phase 14: 14a-14d. Returns the launches of each kernel on 14a's path
    (the wrappers' counts, set to 0 before and read after it)."""
    t0 = time.perf_counter()
    for wrapper in (*(getattr(fa, a) for a in FLASH_WRAPPERS.values()), fu.fused_adam,
                    fu.fused_sgd, fu.fused_momentum):  # phase 14's counts start here
        wrapper.launches = 0
    reset_flash_counts(fa)
    frozen = frozen_finetune_345m(torch, pt, fa, fu, dev, unfrozen)
    launches = kernel_counts(fa, fu)  # ... and end here
    o1 = o1_casts_on_card(torch, pt, dev)
    la = linalg_on_card(torch, pt, dev)
    probe = serve_probe_on_card()
    print(f"  phase 14 in {time.perf_counter() - t0:.1f} s; launches on 14a's path (a graph's "
          f"counted once, when it was captured) {launches}")
    return {"frozen": frozen, "o1": o1, "linalg": la, "probe": probe, "launches": launches}


def slice16_alone(torch) -> int:
    """``python3 chip_smoke.py --phase14``: phase 14 alone, after building the
    libraries its paths launch (the tf32x3 flash kernels and the fused
    updates)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_update as fu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sources = [fa.TF32_FWD_KERNEL_NAME, fa.TF32_BWD_KERNEL_NAME, fu.KERNEL_NAME]
    _build.build(sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    torch.zeros(1, device="cuda")  # a context before reset_peak_memory_stats
    out = slice16(torch, pt, fa, fu, torch.device("cuda", 0))
    print(json.dumps({"frozen": out["frozen"], "o1": out["o1"], "launches": out["launches"]},
                     default=str))
    return 0


# Phase 15: the parameter-server tables and BASELINE config 5's ERNIE CTR loop
# (bench.py bench_ernie_ctr through the port's examples/ernie_ctr.py), the PS
# host rows (bench_ps_table, bench_ps_wire), SparseEmbedding on the card, and
# paddle.io's multi-process DataLoader (bench_dataloader).
ERNIE_SHAPE = (32, 128, 8, 32)  # config 5's attention: 32 x 128 tokens, 8 heads of 32 (hidden 256)
ERNIE_BATCH = 32    # bench_ernie_ctr's bsz ...
ERNIE_STEPS = 8     # ... and its steps per timed window
ERNIE_WINDOWS = 3   # bench's _best_window: the best of BENCH_REPS (3) windows
ERNIE_LOSS_STEPS = 10  # tests/test_ernie_ctr.py:17-27: 10 sync steps on one fixed batch ...
ERNIE_LOSS_RATIO = 0.9  # ... bring the loss under 0.9 of its first value
ERNIE_SSD_STEPS, ERNIE_SSD_RAM = 6, 64  # tests/test_ernie_ctr.py's SSD-overflow table
PS_ITERS, PS_KEYS, PS_DIM = 10, 65536, 64  # bench_ps_table / bench_ps_wire
PS_WINDOWS = 3
# SparseEmbedding's rows pushed from the card against the CPU port's: the
# same f32 arithmetic but for the head's matmul, whose summation order may
# differ between cuBLAS and the CPU's BLAS (~1e-8 on rows of ~0.05)
TOL_PS_ROWS = 1e-6
EMB_STEPS = 4
LOADER_N, LOADER_BATCH, LOADER_WORKERS = 1024, 64, 4  # bench_dataloader


def host_cpu() -> str:
    """The host's CPU (the host rows measure it): /proc/cpuinfo's model name
    with its vendor, family and model numbers (a virtualised kernel may
    report the name as "unknown"), else the machine's architecture."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "vendor_id", "cpu family", "model") and key not in fields:
                    fields[key] = value.strip()
    except OSError:
        pass
    if not fields:
        import platform

        return platform.machine() or "unknown"
    return (f"{fields.get('model name', 'unknown')} ({fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model {fields.get('model', '?')})")


def start_ps_build():
    """Build the three PS libraries (g++, csrc/*.cc of distributed/ps) in
    threads, beside the nvcc builds. Returns a function that waits for them
    and raises if one failed."""
    import threading

    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.ps import service

    errors, t0 = [], time.perf_counter()

    def one(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — raised again by wait()
            errors.append(e)

    threads = [threading.Thread(target=one, args=(fn,))
               for fn in (ps._load_lib, service._load_server_lib, service._load_client_lib)]
    for t in threads:
        t.start()

    def wait():
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        print(f"  the PS libraries (ps_table, ps_server, ps_client) built by g++ in "
              f"{time.perf_counter() - t0:.1f} s, beside the nvcc builds")

    return wait


def ernie_kernels(torch, fa, gen, dev):
    """15a: the tf32x3 kernels at config 5's shape (head dim 32), f32,
    non-causal: against their plain versions, a second launch bitwise equal,
    timed beside SDPA f32 and the 3xTF32 bound. Returns {kernel: numbers}."""
    print(f"[15a] the tf32x3 flash kernels at config 5's shape {ERNIE_SHAPE}, f32, non-causal "
          f"(launch_fwd<32> and the backward's head-dim-32 instantiation)")
    return flash_kernels_at(
        torch, fa, gen, dev, ERNIE_SHAPE, False,
        lambda dtype: qkv_on_card(ERNIE_SHAPE, dtype, "separate", gen, dev), "config 5's",
        routes=((torch.float32, "tf32x3"),))["float32"]


class CountingTable:
    """A table that counts the pushes that reached it (the communicator
    thread's included) and forwards everything to ``table``."""

    def __init__(self, table):
        self.table = table
        self.pushes = 0

    def pull(self, keys, create=True):
        return self.table.pull(keys, create)

    def push(self, keys, grads):
        self.table.push(keys, grads)
        self.pushes += 1

    def __len__(self):
        return len(self.table)


class CountingStep:
    """A compiled step that records the flash launches made through the
    wrappers during each call."""

    def __init__(self, step, fa):
        self.step, self.fa, self.calls = step, fa, []

    def __call__(self, *batch):
        before = flash_counts(self.fa)
        out = self.step(*batch)
        self.calls.append({k: v - before[k] for k, v in flash_counts(self.fa).items()})
        return out


def ernie_sync_breakdown(torch, pt, table, step, cfg, batches):
    """Median ms of each part of a sync step over ``batches``: the pull, the
    upload of rows, tokens and labels (synchronized), the step (CUDA events
    and the host clock: a replay, with its input copies and output clones),
    the row gradients' read-back and the push."""
    parts = {k: [] for k in ("pull", "upload", "step_device", "step_host", "readback", "push")}
    for slot_ids, tokens, labels in batches:
        flat = slot_ids.reshape(-1)
        t0 = time.perf_counter()
        rows = table.pull(flat).reshape(slot_ids.shape[0], cfg.slots, cfg.sparse_dim)
        t1 = time.perf_counter()
        ins = (pt.to_tensor(rows), pt.to_tensor(tokens), pt.to_tensor(labels))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, (row_grads,) = step(*ins)
        end.record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        grads = row_grads.numpy().reshape(-1, cfg.sparse_dim)
        t4 = time.perf_counter()
        table.push(flat, grads)
        t5 = time.perf_counter()
        for key, ms in (("pull", t1 - t0), ("upload", t2 - t1), ("step_host", t3 - t2),
                        ("readback", t4 - t3), ("push", t5 - t4)):
            parts[key].append(ms * 1e3)
        parts["step_device"].append(start.elapsed_time(end))
        check(math.isfinite(float(loss)), "non-finite ERNIE CTR loss")
    return {k: statistics.median(v) for k, v in parts.items()}


def ernie_ctr_loop(torch, pt, fa, dev):
    """15b: bench_ernie_ctr as bench.py writes it, on the port. Returns its
    numbers and the flash launches of its path."""
    import tempfile

    import numpy as np

    from paddle_tpu_torch.core import cuda_graphs
    from paddle_tpu_torch.examples import ernie_ctr as ec

    cfg = ec.ErnieCtrConfig()
    check((ERNIE_BATCH, cfg.seq_len, cfg.heads, cfg.hidden // cfg.heads) == ERNIE_SHAPE,
          "ErnieCtrConfig's defaults are not config 5's shape")
    print(f"[15b] bench_ernie_ctr: ErnieCtrConfig() (hidden {cfg.hidden}, {cfg.layers} layers, "
          f"{cfg.heads} heads, seq {cfg.seq_len}, {cfg.slots} slots of dim {cfg.sparse_dim}), "
          f"batch {ERNIE_BATCH}, f32, Adam 1e-3 dense, MemorySparseTable AdaGrad 0.05 x 16 "
          f"shards; one sync train_step, then train_pipelined over {ERNIE_STEPS} batches, best "
          f"of {ERNIE_WINDOWS} windows")
    captures = [0]
    real_capture = cuda_graphs.Graph.capture

    def counting_capture(self, *args, **kwargs):
        captures[0] += 1
        return real_capture(self, *args, **kwargs)

    cuda_graphs.Graph.capture = counting_capture
    try:
        reset_flash_counts(fa)  # the ERNIE path's count starts here
        table, model, step = ec.build(cfg)
        counted, cstep = CountingTable(table), CountingStep(step, fa)
        rng = np.random.default_rng(0)
        batches = [ec.synthetic_batch(cfg, ERNIE_BATCH, rng) for _ in range(ERNIE_STEPS)]
        ec.train_step(counted, cstep, cfg, *batches[0])  # bench's warm step
        windows, losses = [], None
        for _ in range(ERNIE_WINDOWS):
            pushes = counted.pushes
            t0 = time.perf_counter()
            losses = ec.train_pipelined(counted, cstep, cfg, batches)
            windows.append(time.perf_counter() - t0)
            check(counted.pushes - pushes == ERNIE_STEPS, f"{counted.pushes - pushes} pushes "
                  f"landed in a window of {ERNIE_STEPS} steps after flush()")
        launches = flash_counts(fa)  # ... and ends here (the sync loops below replay)
        n = cfg.layers
        warm = pt.jit.WARMUP_STEPS
        want_call = dict.fromkeys(launches, 0)
        want_call.update(fwd_tf32x3=n, dkv_tf32x3=n, dq_tf32x3=n)
        none = dict.fromkeys(launches, 0)
        for i, got in enumerate(cstep.calls):
            check(got == (want_call if i <= warm else none),
                  f"ERNIE step {i}: flash launches through the wrappers {got}")
        check(captures[0] == 1 and len(step._captured) == 1
              and next(iter(step._captured.values())).graph is not None,
              f"{captures[0]} captures of the ERNIE step; want 1, then replays")
        distinct = len(np.unique(np.concatenate([b[0].reshape(-1) for b in batches])))
        check(len(table) == distinct, f"len(table) {len(table)}, distinct slot ids {distinct}")
        check(all(math.isfinite(v) for v in losses), "non-finite pipelined losses")
        best = min(windows)
        tokens = ERNIE_BATCH * cfg.seq_len * ERNIE_STEPS
        pipelined_tps = tokens / best
        # in turns: the sync loop, the pipelined loop again, and the pipelined
        # loop with a 0.1 ms switch interval of the interpreter lock (its
        # threads hand the lock back and forth with the main thread's step)
        turns = {"sync": [], "pipelined": [], "pipelined_switch_0.1ms": []}
        interval = sys.getswitchinterval()
        for _ in range(ERNIE_WINDOWS):
            for key, windows_of in turns.items():
                t0 = time.perf_counter()
                if key == "sync":
                    for b in batches:
                        ec.train_step(counted, cstep, cfg, *b)
                else:
                    sys.setswitchinterval(1e-4 if key == "pipelined_switch_0.1ms" else interval)
                    try:
                        ec.train_pipelined(counted, cstep, cfg, batches)
                    finally:
                        sys.setswitchinterval(interval)
                windows_of.append(time.perf_counter() - t0)
        sync_windows = turns["sync"]
        sync_tps = tokens / min(sync_windows)
        split = ernie_sync_breakdown(torch, pt, table, step, cfg, batches)
        check(captures[0] == 1, f"the ERNIE step was captured again: {captures[0]} captures")
        bench_captures = captures[0]
        replay_launches = {k: v - launches[k] for k, v in flash_counts(fa).items()}
        check(sum(replay_launches.values()) == 0,
              f"the sync replays launched through a wrapper: {replay_launches}")
        print(f"  calls of the step: {len(cstep.calls)} ({warm} eager, 1 capture, the rest "
              f"replays); flash launches through the wrappers per call {want_call} for the eager "
              f"and capturing calls, none on a replay; captures {captures[0]}; len(table) "
              f"{len(table)} = the {distinct} distinct slot ids; {ERNIE_STEPS} pushes landed per "
              f"window")
        print(f"  ernie_ctr_sparse_ps_tokens_per_sec_per_chip {pipelined_tps:.1f} (pipelined, "
              f"windows " + ", ".join(f"{w * 1e3:.2f}" for w in windows) + " ms); the sync "
              f"loop {sync_tps:.1f} tokens/s (windows "
              + ", ".join(f"{w * 1e3:.2f}" for w in sync_windows) + " ms); pipelined / sync "
              f"{pipelined_tps / sync_tps:.2f}x")
        print("  in turns, windows of 8 steps, ms: " + "; ".join(
            f"{k} " + ", ".join(f"{w * 1e3:.2f}" for w in v) for k, v in turns.items()))
        print("  a sync step, median ms: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + " (step_device: CUDA events around the replay, its input copies and output "
                "clones; step_host: the host clock around it, synchronized)")
        print(f"  pipelined losses " + " ".join(f"{v:.4f}" for v in losses))
        del table, model, step, counted, cstep

        # the compiled step's row gradients against eager autograd's
        table, model, step = ec.build(cfg)
        eager = copy.deepcopy(model)
        opt_e = pt.optimizer.Adam(learning_rate=1e-3, parameters=eager.parameters())
        bce = pt.nn.BCEWithLogitsLoss()
        errs = []
        for i in range(warm + 1 + 3):
            slot_ids, tokens, labels = batches[i % len(batches)]
            flat = slot_ids.reshape(-1)
            rows = table.pull(flat).reshape(ERNIE_BATCH, cfg.slots, cfg.sparse_dim)
            tok, lab = pt.to_tensor(tokens), pt.to_tensor(labels)
            loss, (g,) = step(pt.to_tensor(rows), tok, lab)
            x = pt.to_tensor(rows, stop_gradient=False)
            ref = bce(eager(x, tok), lab)
            ref.backward()
            opt_e.step()
            opt_e.clear_grad()
            gv, xv = g._value, x.grad._value
            if i > warm:  # the replays after the capture
                errs.append(((gv - xv).abs().max().item(), xv.abs().max().item(),
                             abs(float(loss) - float(ref))))
            table.push(flat, g.numpy().reshape(-1, cfg.sparse_dim))
        print("  row gradients, replays against eager autograd: "
              + "; ".join(f"max|d grad|={e:.3e} (largest {s:.3e}), |d loss|={d:.3e}"
                          for e, s, d in errs))
        check(all(e <= TOL_INPUT_GRAD * s and d <= 1e-5 for e, s, d in errs),
              "the ERNIE step's row gradients disagree with eager autograd's")
        del table, model, step, eager, opt_e

        # the loss falls on one fixed batch
        table, model, step = ec.build(cfg)
        fixed = ec.synthetic_batch(cfg, ERNIE_BATCH, np.random.default_rng(0))
        fixed_losses = [ec.train_step(table, step, cfg, *fixed) for _ in range(ERNIE_LOSS_STEPS)]
        print(f"  {ERNIE_LOSS_STEPS} sync steps on one batch: losses "
              + " ".join(f"{v:.4f}" for v in fixed_losses))
        check(fixed_losses[-1] < ERNIE_LOSS_RATIO * fixed_losses[0],
              "the ERNIE CTR loss did not fall on a fixed batch")
        del table, model, step

        # the SSD-overflow table
        with tempfile.TemporaryDirectory() as tmp:
            table, model, step = ec.build(cfg, ssd_path=os.path.join(tmp, "slots.bin"),
                                          ram_budget=ERNIE_SSD_RAM)
            rng = np.random.default_rng(0)
            for _ in range(ERNIE_SSD_STEPS):
                ec.train_step(table, step, cfg, *ec.synthetic_batch(cfg, ERNIE_BATCH, rng))
            print(f"  SSD overflow (ram_budget={ERNIE_SSD_RAM}): {ERNIE_SSD_STEPS} steps, "
                  f"ram_size {table.ram_size()}, disk_size {table.disk_size()}, len {len(table)}")
            check(table.disk_size() > 0 and table.ram_size() <= 2 * ERNIE_SSD_RAM,
                  "the SSD-overflow table did not spill")
            del table, model, step
    finally:
        cuda_graphs.Graph.capture = real_capture
    torch.cuda.empty_cache()
    return {"tokens_per_s": pipelined_tps, "sync_tokens_per_s": sync_tps,
            "windows_ms": [w * 1e3 for w in windows],
            "sync_windows_ms": [w * 1e3 for w in sync_windows], "split_ms": split,
            "turns_ms": {k: [w * 1e3 for w in v] for k, v in turns.items()},
            "launches": launches, "captures": bench_captures}


def best_window(fn, reps):
    """The least host-clock seconds of ``reps`` runs of ``fn``."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def sparse_embedding_loop(pt, device, lazy):
    """EMB_STEPS eager steps of a SparseEmbedding (AdaGrad, padding_idx 0)
    and a Linear head (SGD) on ``device``, lazy dispatch on or off. Returns
    the table's rows, the losses and the pulled blocks' devices."""
    import numpy as np

    from paddle_tpu_torch.distributed.ps import MemorySparseTable, SparseEmbedding

    previous = pt.get_device()
    pt.set_device(device)
    pt.set_flags({"FLAGS_eager_lazy_dispatch": lazy})
    try:
        table = MemorySparseTable(16, shard_num=4, optimizer="adagrad", learning_rate=0.05,
                                  init_range=0.05, seed=3)
        emb = SparseEmbedding([1000, 16], table=table, padding_idx=0)
        head = pt.nn.Linear(16, 1)
        rng = np.random.default_rng(5)
        head.weight.set_value(rng.standard_normal((16, 1)).astype(np.float32))
        head.bias.set_value(np.zeros(1, np.float32))
        opt = pt.optimizer.SGD(learning_rate=0.1, parameters=head.parameters())
        losses, devices = [], set()
        for _ in range(EMB_STEPS):
            ids = pt.to_tensor(rng.integers(0, 50, (8, 4)))
            y = pt.to_tensor(rng.integers(0, 2, 8).astype(np.float32))
            rows = emb(ids)
            devices.add(rows._value.device.type)
            loss = pt.nn.functional.binary_cross_entropy_with_logits(
                head(rows.mean(axis=1)).squeeze(-1), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return table.pull(np.arange(50), create=False), losses, devices
    finally:
        pt.set_flags({"FLAGS_eager_lazy_dispatch": False})
        pt.set_device(previous)


def ps_host_rows(torch, pt):
    """15c: bench_ps_table and bench_ps_wire as bench.py writes them, and
    SparseEmbedding in an eager card loop. Returns the rows."""
    import numpy as np

    from paddle_tpu_torch.distributed.ps import (
        DistributedSparseTable, MemorySparseTable, PsClient, PsServer,
    )

    print(f"[15c] the PS host rows on {host_cpu()} ({os.cpu_count()} CPUs): {PS_KEYS} keys x "
          f"dim {PS_DIM}, {PS_ITERS} pull + push per window, best of {PS_WINDOWS}")
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 10_000_000, PS_KEYS)
    grads = rng.standard_normal((PS_KEYS, PS_DIM)).astype(np.float32)

    def window(t):
        for _ in range(PS_ITERS):
            t.pull(keys)
            t.push(keys, grads)

    local = MemorySparseTable(PS_DIM, shard_num=32, init_range=0.01)
    local.pull(keys)  # warm (creates entries)
    table_rate = PS_KEYS * PS_ITERS * 2 / best_window(lambda: window(local), PS_WINDOWS) / 1e6
    del local
    s0 = PsServer(port=0, server_id=0, n_servers=2, n_trainers=1)
    s1 = PsServer(port=0, server_id=1, n_servers=2, n_trainers=1)
    client = PsClient([f"127.0.0.1:{s0.port}", f"127.0.0.1:{s1.port}"], trainer_id=0)
    try:
        wire = DistributedSparseTable(client, 1, emb_dim=PS_DIM, shard_num=32, init_range=0.01)
        fresh = MemorySparseTable(PS_DIM, shard_num=32, init_range=0.01)
        same = bool(np.array_equal(wire.pull(keys), fresh.pull(keys)))  # also the warm pull
        del fresh
        check(same, "the wire pull does not return the local table's rows of the same seed")
        wire_rate = PS_KEYS * PS_ITERS * 2 / best_window(lambda: window(wire), PS_WINDOWS) / 1e6
    finally:
        client.stop_servers()
    print(f"  ps_sparse_pull_push_m_lookups_per_sec {table_rate:.2f}; "
          f"ps_wire_pull_push_m_lookups_per_sec {wire_rate:.2f} (2 local servers over framed "
          f"TCP); the wire pull equals a local table's rows of the same seed: {same}")
    card_rows, card_losses, devices = sparse_embedding_loop(pt, "gpu:0", False)
    cpu_rows, cpu_losses, _ = sparse_embedding_loop(pt, "cpu", False)
    lazy_rows, lazy_losses, lazy_devices = sparse_embedding_loop(pt, "gpu:0", True)
    err_cpu = float(np.abs(card_rows - cpu_rows).max())
    err_lazy = float(np.abs(card_rows - lazy_rows).max())
    print(f"  SparseEmbedding, {EMB_STEPS} eager steps: pulled blocks on {sorted(devices)}; "
          f"pushed rows on the card against the CPU port max|d|={err_cpu:.3e}, lazy dispatch "
          f"against per-op max|d|={err_lazy:.3e} (tol {TOL_PS_ROWS:g}); losses card "
          + " ".join(f"{v:.6f}" for v in card_losses) + ", CPU "
          + " ".join(f"{v:.6f}" for v in cpu_losses))
    check(devices == {"cuda"} and lazy_devices == {"cuda"},
          "SparseEmbedding's pulled block is not on the card")
    check(err_cpu <= TOL_PS_ROWS and err_lazy <= TOL_PS_ROWS,
          "SparseEmbedding's pushed rows on the card disagree")
    check(max(abs(a - b) for a, b in zip(card_losses, lazy_losses)) <= TOL_PS_ROWS,
          "SparseEmbedding's lazy losses differ from the per-op ones")
    return {"table_m_lookups_per_s": table_rate, "wire_m_lookups_per_s": wire_rate,
            "emb_err_cpu": err_cpu, "emb_err_lazy": err_lazy, "cpu": host_cpu()}


def dataloader_rows(torch, pt, dev):
    """15d: bench_dataloader as written, the same loader giving card Tensors
    against the single-process loader, and a worker's exception."""
    import numpy as np

    from paddle_tpu_torch.io import DataLoader, Dataset

    class SynthImages(Dataset):  # bench.py bench_dataloader's dataset
        def __len__(self):
            return LOADER_N

        def __getitem__(self, i):
            base = np.empty((240, 240, 3), np.uint8)
            base[...] = (i * 37) % 251
            base[::7, :, 0] ^= np.uint8(i % 17)
            off = i % 16
            img = base[off:off + 224, off:off + 224]
            return np.ascontiguousarray(img), np.int64(i % 1000)

    class Broken(Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise ValueError("sample 5 is broken")
            return np.zeros(3, np.float32)

    print(f"[15d] bench_dataloader: {LOADER_N} synthetic 224^2 uint8 images, batch "
          f"{LOADER_BATCH}, {LOADER_WORKERS} forked workers, on {host_cpu()}, after CUDA is up")
    check(torch.cuda.is_initialized(), "CUDA is not initialised before the forked loader")
    loader = DataLoader(SynthImages(), batch_size=LOADER_BATCH, num_workers=LOADER_WORKERS,
                        return_numpy=True)
    it = iter(loader)
    next(it)  # pool warm-up
    t0 = time.perf_counter()
    cnt = 0
    for xb, yb in it:
        cnt += int(xb.shape[0])
    rate = cnt / (time.perf_counter() - t0)
    multi = list(DataLoader(SynthImages(), batch_size=LOADER_BATCH, num_workers=LOADER_WORKERS))
    single = list(DataLoader(SynthImages(), batch_size=LOADER_BATCH))
    check(len(multi) == len(single) == LOADER_N // LOADER_BATCH, "loader batch counts")
    on_card = all(x._value.device.type == "cuda" and y._value.device.type == "cuda"
                  for x, y in multi)
    equal = all(torch.equal(a._value, b._value) for m, s in zip(multi, single)
                for a, b in zip(m, s))
    try:
        list(DataLoader(Broken(), batch_size=2, num_workers=2))
        message = ""
    except RuntimeError as e:
        message = str(e)
    relayed = "Traceback" in message and "sample 5 is broken" in message
    print(f"  dataloader_mp_imgs_per_sec {rate:.1f}; {LOADER_WORKERS}-worker Tensors on the card "
          f"{on_card}, equal to the single-process loader's {equal}; a worker's exception "
          f"reached the parent with its traceback {relayed}")
    check(on_card and equal, "the multi-process loader's card batches differ")
    check(relayed, f"the worker's exception did not reach the parent: {message[:500]}")
    del multi, single
    torch.cuda.empty_cache()
    return {"imgs_per_s": rate}


def slice17(torch, pt, fa, dev, ps_built):
    """Phase 15: 15a-15d. Returns their numbers."""
    t0 = time.perf_counter()
    ps_built()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kernels = ernie_kernels(torch, fa, gen, dev)
    loop = ernie_ctr_loop(torch, pt, fa, dev)
    run_trace_child("ernie")
    host = ps_host_rows(torch, pt)
    loader = dataloader_rows(torch, pt, dev)
    print(f"  phase 15 in {time.perf_counter() - t0:.1f} s; flash launches on 15b's path "
          f"{loop['launches']}")
    return {"kernels": kernels, "loop": loop, "host": host, "loader": loader}


def slice17_alone(torch) -> int:
    """``python3 chip_smoke.py --phase15``: phase 15 alone, after building the
    libraries its paths launch (the tf32x3 flash kernels, the PS libraries)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ps_built = start_ps_build()
    sources = [fa.TF32_FWD_KERNEL_NAME, fa.TF32_BWD_KERNEL_NAME]
    _build.build(sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    out = slice17(torch, pt, fa, torch.device("cuda", 0), ps_built)
    print(json.dumps({"loop": {k: v for k, v in out["loop"].items()},
                      "host": out["host"], "loader": out["loader"]}, default=str))
    return 0


# ---------------------------------------------------------------------------
# Phase 16: the profiler and the ops plane (profiler/{__init__,metrics,
# statistic,attribution,sentinel,diag}.py, analysis/, tools/obs_probe.py),
# driven by the 345M training and serving paths
# ---------------------------------------------------------------------------
# the telemetry variant's rows against float64 sums: f32 partial sums per
# thread and block and one sum over the blocks, ~1e-6 relative at 51M
# elements; 1e-5 is the CPU tests' tolerance against the JAX package's sums
TOL_TELEMETRY = 1e-5
# per element, the telemetry sums' extra operations (three squares, three
# adds, one subtraction), beside UPDATE_FLOPS
TELEMETRY_FLOPS = 7
# the captured 345M step's recorded matmul FLOPs against the analytic count
TOL_MATMUL_FLOPS = 0.02
# the planner's peak estimate against the step's measured peak
MEMORY_RATIO = (0.5, 2.0)
# 16d: the sentinel's settings and the slowed decode ticks
SENTINEL_16D = {"FLAGS_sentinel_pct": 30.0, "FLAGS_sentinel_warmup_steps": 10,
                "FLAGS_sentinel_sustain_steps": 3}
SLOW_TICKS = (24, 32)  # [first, last) engine ticks whose decode step sleeps
SLOW_REQUESTS, SLOW_PROMPT, SLOW_NEW = 4, 32, 96
# 16d's rounds of plain, scraped, scraped, plain serves: one serve's decode
# steps shift together by up to ~0.2 ms from serve to serve, so the gap's
# median needs a dozen pairs to sit well inside FAST_PATH_STEP_MS
SCRAPE_ROUNDS = 6
PROBE_TIMEOUT_S = 600


def telemetry_update_kernels(torch, pt, fu, gen, dev):
    """16a: the three telemetry variants against the kernels (bitwise),
    their rows against float64 sums and against themselves (a second
    launch), timed at the embedding's size; then Momentum and SGD with
    FLAGS_telemetry through 2-layer GPT-2 345M-width f32 steps, the path
    that launches their variants."""
    print("[16a] the fused updates' telemetry variants: updates bitwise the kernels', "
          f"rows within {TOL_TELEMETRY:g} of float64 sums, repeats bitwise")
    lr = torch.full((), 3e-4, device=dev)
    gates = {"off": None, "clear": torch.tensor(False, device=dev),
             "set": torch.tensor(True, device=dev)}
    blocks = fu.telemetry_blocks(dev)
    cases = [("sgd", None), ("momentum", False), ("momentum", True), ("adam", None)]

    def launch(kind, nesterov, bufs, wd, bad, tele):
        p, g, m, v = bufs
        if kind == "sgd":
            fu.fused_sgd(p, g, lr, wd=wd, bad=bad, tele=tele)
            return (p,)
        if kind == "momentum":
            fu.fused_momentum(p, g, m, lr, mu=0.9, nesterov=nesterov, wd=wd, bad=bad,
                              tele=tele)
            return p, m
        fu.fused_adam(p, g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, wd=wd, bad=bad, tele=tele)
        return p, m, v

    worst = 0.0
    checked = 0
    for n in UPDATE_SIZES:
        bufs = [torch.randn(n, generator=gen, device=dev) for _ in range(3)]
        bufs.append(torch.rand(n, generator=gen, device=dev))
        p64, g64 = bufs[0].double(), bufs[1].double()
        for kind, nesterov in cases:
            for wd in (0.0, 0.01):
                for gate, bad in gates.items():
                    t1 = torch.zeros((blocks, 3), device=dev)
                    t2 = torch.zeros((blocks, 3), device=dev)
                    got = launch(kind, nesterov, [b.clone() for b in bufs], wd, bad, t1)
                    again = launch(kind, nesterov, [b.clone() for b in bufs], wd, bad, t2)
                    want = launch(kind, nesterov, [b.clone() for b in bufs], wd, bad, None)
                    rows, rows2 = t1.sum(0), t2.sum(0)
                    ref = torch.stack([(g64 * g64).sum(), (p64 * p64).sum(),
                                       ((got[0].double() - p64) ** 2).sum()])
                    rel = ((rows.double() - ref).abs() / ref.abs().clamp_min(1e-300)).max().item()
                    worst = max(worst, rel)
                    ok = (all(torch.equal(a, b) for a, b in zip(got, want))
                          and all(torch.equal(a, b) for a, b in zip(again, want))
                          and torch.equal(rows, rows2) and rel <= TOL_TELEMETRY)
                    if gate == "set":
                        ok = ok and rows[2].item() == 0.0 and torch.equal(got[0], bufs[0])
                    check(ok, f"telemetry {kind} nesterov={nesterov} n={n} wd={wd} gate={gate}: "
                              f"update or rows off (rows {rows.tolist()}, float64 "
                              f"{ref.tolist()}, rel {rel:.2e})")
                    checked += 1
        del bufs, p64, g64
    print(f"  {checked} cases over sizes {UPDATE_SIZES}, {blocks} blocks of partial sums: "
          f"updates bitwise the kernels', rows repeat bitwise, worst relative error of a row "
          f"{worst:.2e}")

    n = EMBED_NUMEL
    p, g, m = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    v = torch.rand(n, generator=gen, device=dev)
    bad = gates["clear"]
    tele = torch.zeros((blocks, 3), device=dev)
    step = torch.ones((), device=dev)

    def variant(kind):
        def run():
            tele.zero_()
            launch(kind, True, (p, g, m, v), 0.01, bad, tele)
            return tele.sum(0)
        return run

    def plain(kind):
        def run():
            old = p.clone()
            if kind == "sgd":
                new = (fu.sgd_plain(p, g, lr, wd=0.01, bad=bad),)
            elif kind == "momentum":
                new = fu.momentum_plain(p, g, m, lr, mu=0.9, nesterov=True, wd=0.01, bad=bad)
            else:
                new = fu.adam_plain(p, g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.01,
                                    bad=bad)
            return fu.telemetry_plain(g, old, new[0])
        return run

    library = {
        "adam": lambda: torch._fused_adam_(
            [p], [g], [m], [v], [], [step], lr=3e-4, beta1=0.9, beta2=0.999,
            weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
        "momentum": lambda: torch._fused_sgd_(
            [p], [g], [m], weight_decay=0.01, momentum=0.9, lr=3e-4, dampening=0.0,
            nesterov=True, maximize=False, is_first_step=False),
        "sgd": lambda: torch._fused_sgd_(
            [p], [g], [], weight_decay=0.01, momentum=0.0, lr=3e-4, dampening=0.0,
            nesterov=False, maximize=False, is_first_step=False),
    }
    out = {}
    for kind in ("adam", "momentum", "sgd"):
        ms = time_ms(variant(kind))
        kernel_ms = time_ms(lambda: launch(kind, True, (p, g, m, v), 0.01, bad, None))
        plain_ms = time_ms(plain(kind), reps=10)
        library_ms = time_ms(library[kind])
        t_bytes = ((UPDATE_BYTES[kind] * n + 5 + blocks * 3 * 4) / PEAK_BYTES_PER_S * 1e3)
        t_ops = (UPDATE_FLOPS[kind] + TELEMETRY_FLOPS) * n / PEAK_FLOPS["float32"] * 1e3
        bound_ms, bound_by = max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")
        out[kind] = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0,
                         rows_rel_err=worst)
        print(f"  {kind} n={n}: telemetry variant {ms:.4f} ms, the kernel {kernel_ms:.4f} ms "
              f"({ms / kernel_ms:.3f}x), plain version with its rows {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); variant "
              f"at {bound_ms / ms:.1%} of bound")
    del p, g, m, v

    # Momentum and SGD steps with telemetry: the path of their variants
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    cfg = dataclasses.replace(gpt2_345m(dropout=0.0, attn_dropout=0.0), num_layers=2)
    ids = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len + 1), generator=gen, device=dev)
    x, y = ids[:, :-1], ids[:, 1:]
    pt.set_flags({"FLAGS_pallas_fused_update": True, "FLAGS_telemetry": True})
    try:
        for kind, make in (("momentum", lambda ps: pt.optimizer.Momentum(
                learning_rate=1e-3, momentum=0.9, use_nesterov=True, parameters=ps)),
                           ("sgd", lambda ps: pt.optimizer.SGD(learning_rate=1e-3,
                                                               parameters=ps))):
            pt.seed(SEED)
            model = GPTForPretraining(cfg, device=dev)
            opt = make(model.parameters())
            crit = GPTPretrainingCriterion(cfg)
            pt.profiler.attribution.reset()
            fu.KERNELS[kind].telemetry_launches = 0  # this path's count starts here
            for _ in range(2):
                loss = crit(model(x), y)
                loss.backward()
                opt.step()
                opt.clear_grad()
            launches = fu.KERNELS[kind].telemetry_launches  # ... and ends here
            st = pt.profiler.attribution.telemetry_state()
            n_params = len(list(model.parameters()))
            print(f"  {kind} at 2 layers, 8 x 1024, f32: {launches} telemetry-variant launches "
                  f"over 2 steps, {st['steps']} telemetry records of {len(st['groups'])} groups")
            check(launches == 2 * n_params and st["steps"] == 2,
                  f"{kind}: {launches} variant launches and {st['steps']} records, expected "
                  f"{2 * n_params} and 2")
            out[kind]["launches"] = launches
            del model, opt
    finally:
        pt.set_flags({"FLAGS_pallas_fused_update": False, "FLAGS_telemetry": False})
        pt.profiler.attribution.reset()
    torch.cuda.empty_cache()
    return out


class _Worker:
    """One thread that runs every call given to it: a model's steps keep
    their own lazy-dispatch state (it is per thread) while two models step
    in turns."""

    def __init__(self):
        import concurrent.futures

        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def __call__(self, fn, *args):
        return self.pool.submit(fn, *args).result()

    def close(self):
        self.pool.shutdown()


def gpt_matmul_flops(cfg, tokens):
    """The 345M step's matrix-product FLOPs: per layer the qkv, output and
    two MLP projections (24 T H^2), the tied head (2 T H V), forward; the
    backward twice that (the input's and the weight's gradients)."""
    h = cfg.hidden_size
    forward = cfg.num_layers * 24 * tokens * h * h + 2 * tokens * h * cfg.vocab_size
    return 3 * forward


def telemetry_345m(torch, pt, fa, fu, dev):
    """16b: phase 13b's Paddle-style 345M f32 step under lazy dispatch with
    capture, twin models from one seed, FLAGS_telemetry on for one: bitwise,
    one program a step, the graph's launches, the telemetry against float64,
    step ms in turns, the captured program's static profile and the
    planner's peak against the measured one."""
    import numpy as np
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m
    from paddle_tpu_torch.profiler import attribution

    batch = 8
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    tokens = batch * cfg.max_seq_len
    print(f"[16b] the 345M f32 step captured whole ({batch} x {cfg.max_seq_len}, Adam through "
          f"the fused kernel), FLAGS_telemetry on against off, twin models in turns")
    data = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1))
    pt.set_flags({"FLAGS_pallas_fused_update": True})
    lazy.reset_lazy_state()
    attribution.reset()
    pt.profiler.reset_dispatch_counters()
    models, opts, workers = [], [], [_Worker(), _Worker()]
    for _ in range(2):
        pt.seed(SEED)
        models.append(GPTForPretraining(cfg))
        opts.append(pt.optimizer.Adam(learning_rate=1e-4, parameters=models[-1].parameters()))
    n_params = len(list(models[0].parameters()))
    crit = GPTPretrainingCriterion(cfg)
    ids = pt.to_tensor(data[:, :-1], dtype="int64")
    labels = pt.to_tensor(data[:, 1:], dtype="int64")

    def stepper(i):
        def step(clear=True):
            set_regime(pt, "captured")
            pt.set_flags({"FLAGS_telemetry": i == 1})
            loss = crit(models[i](ids), labels)
            loss.backward()
            opts[i].step()
            if clear:
                opts[i].clear_grad()
            return float(loss)
        return step

    off, on = stepper(0), stepper(1)
    warm = pt.get_flags("FLAGS_eager_capture_warmup")["FLAGS_eager_capture_warmup"]
    losses = {"off": [], "on": []}
    built = None
    peaks = {}
    fu.fused_adam.telemetry_launches = 0  # this path's count starts here
    for i in range(warm + CAPTURE_345M_STEPS):
        last = i == warm + CAPTURE_345M_STEPS - 1
        for name, w, step in (("off", 0, off), ("on", 1, on)):
            if last and name == "on":  # the parameters before the last step
                before_params = [p.detach().clone() for p in models[1].parameters()]
            before = kernel_counts(fa, fu)
            tele0 = fu.fused_adam.telemetry_launches
            progs0 = pt.profiler.dispatch_counters()["programs"]
            if i == warm:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
            losses[name].append(workers[w](step, not last))
            if i == warm:  # the capture: what it launched is what each replay holds
                torch.cuda.synchronize()
                peaks[name] = torch.cuda.max_memory_allocated(dev)
                if name == "on":
                    got = counts_since(fa, fu, before)
                    built = {"flash": {k: v for k, v in got.items() if k.endswith(
                        ("tf32x3", "sm90", "simt"))}, "adam": got.get("adam", 0),
                        "adam_telemetry": fu.fused_adam.telemetry_launches - tele0}
            if i > warm:
                check(pt.profiler.dispatch_counters()["programs"] - progs0 == 1,
                      f"a captured step ({name}) ran more than one program")
    launches = fu.fused_adam.telemetry_launches  # ... and ends here
    c = pt.profiler.dispatch_counters()
    same = losses["on"] == losses["off"] and bitwise_same(torch, models[1], models[0], opts[1],
                                                          opts[0])
    print(f"  losses off {losses['off']}; on {losses['on']}; bitwise (losses, parameters, "
          f"moments) {same}; {c['capture_builds']} builds, {c['capture_replays']} replays, "
          f"fallbacks {dict(c['capture_fallback_reasons'])}; the telemetry graph holds "
          f"{built['flash']} flash and {built['adam_telemetry']} telemetry-variant Adam launches")
    check(same, "telemetry on changed the captured 345M step")
    check(c["capture_replays"] == 2 * CAPTURE_345M_STEPS and c["capture_fallbacks"] == 0,
          f"the 345M steps did not replay once a step without a fallback "
          f"({lazy.last_capture_error[0]})")
    want = {"fwd_tf32x3": cfg.num_layers, "dkv_tf32x3": cfg.num_layers,
            "dq_tf32x3": cfg.num_layers}
    check(built["flash"] == want and built["adam"] == n_params == built["adam_telemetry"],
          f"the telemetry graph holds {built}, expected {want} and {n_params} Adam launches, "
          f"every one the telemetry variant")

    # the telemetry of the last step against float64 on the card
    attribution.flush_telemetry()
    st = attribution.telemetry_state()
    names = attribution.group_names(list(models[1].parameters()))
    worst = 0.0
    for name, p, old in zip(names, models[1].parameters(), before_params):
        g2 = float((p.grad.double() ** 2).sum())
        p2 = float((old.double() ** 2).sum())
        d2 = float(((p.detach().double() - old.double()) ** 2).sum())
        ref = {"grad_norm": math.sqrt(g2), "param_norm": math.sqrt(p2),
               "update_ratio": math.sqrt(d2) / math.sqrt(p2) if p2 > 0 else 0.0}
        got = st["groups"][name]
        for k, r in ref.items():
            worst = max(worst, abs(got[k] - r) / max(abs(r), 1e-30))
    steps = pt.profiler.dispatch_counters()["telemetry_steps"]
    print(f"  telemetry: {st['steps']} steps recorded ({steps} counted), {len(st['groups'])} "
          f"groups; per-group grad norm, param norm and update ratio of the last step against "
          f"float64 on the card: worst relative difference {worst:.2e}")
    check(steps == warm + CAPTURE_345M_STEPS, f"telemetry_steps {steps}, expected "
                                               f"{warm + CAPTURE_345M_STEPS}")
    check(worst <= TOL_TELEMETRY, f"the telemetry is {worst:.2e} off float64")
    del before_params
    for o in opts:
        o.clear_grad()

    # step ms in turns, telemetry on and off
    times = {"off": [], "on": []}
    for name in ("off", "on", "on", "off") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        workers[0 if name == "off" else 1](off if name == "off" else on)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    step_ms = {k: statistics.median(v) for k, v in times.items()}
    check(bitwise_same(torch, models[1], models[0], opts[1], opts[0]),
          "the timed steps left the twin models apart")
    record_ms = attribution.measure_record_cost_ms(names, n=50)
    print(f"  step (host clock, synchronised, median of {len(times['on'])} in turns): "
          f"telemetry on {step_ms['on']:.2f} ms, off {step_ms['off']:.2f} ms "
          f"({(step_ms['on'] / step_ms['off'] - 1) * 100:+.2f}%); the host record of "
          f"{len(names)} groups {record_ms:.3f} ms a step, {record_ms / step_ms['on'] * 100:.3f}% "
          f"of the step (budget 1%)")
    check(record_ms / step_ms["on"] < 0.01, "the telemetry record costs over 1% of the step")

    # the telemetry graph's static profile
    program = workers[1](lazy.captured_step_ir)
    key = workers[1](lambda: lazy._tls.last_captured().akey)
    row = attribution.program_costs(top_k=3)[key]
    mm = analysis.matmul_flops(program)
    want_mm = gpt_matmul_flops(cfg, tokens)
    flash = {op.name for op in program.ops if op.kernel and op.name.startswith("flash")}
    flash_flops = sum(op.flops for op in program.ops if op.name.startswith("flash"))
    print(f"  static profile of {key}: {row['eqns']} ops recorded in {program.record_ms:.0f} ms "
          f"(the capture's own run), flops_est {row['flops_est']:.4e}, "
          f"bytes_est {row['bytes_est']:.4e}, top ops {row['top_ops']}; matmul FLOPs {mm:.4e} "
          f"against the analytic {want_mm:.4e} ({mm / want_mm - 1:+.3%}); flash kernels "
          f"{sorted(flash)} {flash_flops:.4e} FLOPs; est_peak_hbm_mb {row['est_peak_hbm_mb']}")
    check(row["top_ops"][0]["op"] in ("mm", "addmm", "bmm"),
          f"the captured step's top op is {row['top_ops'][0]}, not a matmul")
    check(abs(mm / want_mm - 1) <= TOL_MATMUL_FLOPS,
          f"matmul FLOPs {mm} vs the analytic {want_mm}")
    check(flash == {"flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"}
          and flash_flops > 0, f"the flash kernels are not counted: {flash}")

    # the planner's peak against the measured ones
    m = workers[1](lambda: pt.profiler.measure_programs(on, warmup=0))
    mem = m["_memory"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    workers[1](on)
    torch.cuda.synchronize()
    replay_peak = torch.cuda.max_memory_allocated(dev)
    est = mem["estimated_captured_peak_bytes"]
    ratio = est / peaks["on"]
    print(f"  memory: the planner's estimate of the captured step {est / 2**30:.2f} GiB "
          f"(boundary {mem['estimated_captured_boundary_bytes'] / 2**30:.2f} GiB, in-place "
          f"credit {mem['estimated_donation_credit_bytes'] / 2**30:.2f} GiB); measured "
          f"max_memory_allocated over the capture (the run that allocates the step's buffers; "
          f"both twins resident) {peaks['on'] / 2**30:.2f} GiB, ratio {ratio:.3f}; over one "
          f"replay {replay_peak / 2**30:.2f} GiB (a replay allocates nothing: its buffers are "
          f"the graph's pool), ratio {est / replay_peak:.3f}; the telemetry capture's peak "
          f"above the telemetry-off capture's {(peaks['on'] - peaks['off']) / 2**20:+.1f} MiB")
    check(MEMORY_RATIO[0] <= ratio <= MEMORY_RATIO[1],
          f"the planner's peak {est} is {ratio:.3f}x the measured {peaks['on']}")
    for w in workers:
        w(lazy.reset_lazy_state)
        w.close()
    set_regime(pt, "per_op")
    pt.set_flags({"FLAGS_pallas_fused_update": False, "FLAGS_telemetry": False})
    del models, opts
    attribution.reset()
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "launches_adam_telemetry": launches, "record_ms": record_ms,
            "matmul_flops": mm, "analytic_matmul_flops": want_mm, "memory_ratio": ratio}


def profiler_child() -> int:
    """``chip_smoke.py --profile16``, 16c in a process of its own: phase 7's
    O2 bf16 AdamW bench step (``compile_train_step``, one graph a step) with
    FLAGS_telemetry on against off (bitwise over 3 replays, the rule path's
    extra peak memory), the replay with a closed Profiler against none in
    turns and RecordEvent's cost, then a Profiler session (CPU and GPU
    targets, closed 1, ready 1, record 2) with RecordEvent spans around the
    data and the step, exported and read back."""
    import glob
    import tempfile

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    batch = 8
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    print(f"[16c] the Profiler over phase 7's step (GPT-2 345M, {batch} x {cfg.max_seq_len}, "
          f"AMP O2 bf16, AdamW, one CUDA graph a step), FLAGS_telemetry on")
    criterion = GPTPretrainingCriterion(cfg)

    def loss_fn(logits, labels):
        return criterion(logits.float(), labels)

    steps, models = {}, {}
    for name in ("off", "on"):
        pt.seed(SEED)
        model = pt.amp.decorate(GPTForPretraining(cfg, device=dev), level="O2",
                                dtype="bfloat16")
        opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                                 weight_decay=0.01)
        models[name] = (model, opt)
        steps[name] = pt.jit.compile_train_step(model, loss_fn, opt)
    ids = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1), generator=gen,
                        device=dev)
    x, y = ids[:, :-1], ids[:, 1:]

    def run(name):
        pt.set_flags({"FLAGS_telemetry": name == "on"})
        return steps[name](x, y)

    losses = {"off": [], "on": []}
    peaks = {}
    for i in range(pt.jit.WARMUP_STEPS + 1 + 3):  # eager steps, the capture, 3 replays
        for name in ("off", "on"):
            if i == pt.jit.WARMUP_STEPS:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            losses[name].append(float(run(name)))
            if i == pt.jit.WARMUP_STEPS:
                torch.cuda.synchronize()
                peaks[name] = torch.cuda.max_memory_allocated(dev) - base
    same = losses["on"] == losses["off"] and all(
        torch.equal(a, b) for a, b in zip(models["on"][0].parameters(),
                                          models["off"][0].parameters()))
    profiler.attribution.flush_telemetry()
    tele = profiler.attribution.telemetry_state()
    print(f"  losses off {losses['off']}; on {losses['on']}; bitwise (losses, parameters) "
          f"{same}; {tele['steps']} telemetry records of {len(tele['groups'])} groups; the "
          f"capture's peak above what was allocated: telemetry on "
          f"{peaks['on'] / 2**20:.1f} MiB, off {peaks['off'] / 2**20:.1f} MiB, the rule path's "
          f"copies {(peaks['on'] - peaks['off']) / 2**20:+.1f} MiB")
    check(same, "telemetry on changed the O2 bench step")
    check(tele["steps"] == len(losses["on"]), "a telemetry record is missing")

    # the replay with a closed profiler against none, in turns; RecordEvent
    closed = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU,
                                        profiler.ProfilerTarget.GPU],
                               scheduler=lambda step: profiler.ProfilerState.CLOSED)
    closed.start()
    times = {"none": [], "closed": [], "telemetry_off": []}
    for kind in ("none", "closed", "telemetry_off", "telemetry_off", "closed", "none") * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run("off" if kind == "telemetry_off" else "on")
        if kind == "closed":
            closed.step()
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3)
    closed.stop()
    replay_ms = {k: statistics.median(v) for k, v in times.items()}
    names = profiler.attribution.group_names(list(models["on"][0].parameters()))
    record_ms = profiler.attribution.measure_record_cost_ms(names, n=50)
    tele_pct = record_ms / replay_ms["none"] * 100
    n_spans = 20000
    t0 = time.perf_counter()
    for _ in range(n_spans):
        with profiler.RecordEvent("span"):
            pass
    span_us = (time.perf_counter() - t0) / n_spans * 1e6
    profiler._host_events.clear()  # the session's export holds its own spans only
    print(f"  replay with telemetry on (host clock, synchronised, median of "
          f"{len(times['none'])} in turns): a closed Profiler {replay_ms['closed']:.3f} ms, none "
          f"{replay_ms['none']:.3f} ms; telemetry off {replay_ms['telemetry_off']:.3f} ms; "
          f"RecordEvent {span_us:.3f} us a span outside a session; the telemetry's host record "
          f"of {len(names)} groups {record_ms:.3f} ms a step, {tele_pct:.3f}% of the step "
          f"(budget 1%)")
    check(tele_pct < 1.0, f"the telemetry record costs {tele_pct:.3f}% of the O2 step")

    # the session
    out_dir = tempfile.mkdtemp(prefix="profile16_")
    os.environ["PADDLE_PROFILER_DIR"] = os.path.join(out_dir, "device")
    sess = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
                             scheduler=profiler.make_scheduler(closed=1, ready=1, record=2,
                                                               repeat=1),
                             on_trace_ready=profiler.export_chrome_tracing(out_dir))
    t0 = time.perf_counter()
    sess.start()
    for _ in range(5):
        with profiler.RecordEvent("data"):
            xb, yb = x.clone(), y.clone()
        with profiler.RecordEvent("step"):
            run("on")
        torch.cuda.synchronize()
        sess.step()
    sess.stop()
    session_s = time.perf_counter() - t0
    (path,) = glob.glob(os.path.join(out_dir, "*.paddle_trace.json"))
    doc = profiler.load_profiler_result(path)
    evs = doc["traceEvents"]
    spans = [e for e in evs if e.get("cat") == "host" and e["name"] in ("data", "step")]
    flight = [e for e in evs if e.get("cat") == "flight"]
    lanes = sorted({e["name"] for e in evs if e.get("ph") == "C"})
    device_path = os.path.join(doc["metadata"]["device_trace_dir"], "device.pt.trace.json")
    with open(device_path) as f:
        device = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in device if e.get("cat") == "kernel"]

    def n_of(tag):
        return sum(tag in k for k in kernels)

    got = {k: n_of(k) for k in ("fwd_sm90_kernel", "dkv_sm90_kernel", "dq_sm90_kernel",
                                "fwd_tf32_kernel", "dkv_tf32_kernel", "dq_tf32_kernel",
                                "fwd_kernel<", "dkv_kernel<", "dq_kernel<")}
    print(f"  session of 5 steps in {session_s:.1f} s; the export {path} ("
          f"{os.path.getsize(path) / 2**20:.1f} MiB): {len(spans)} RecordEvent spans, "
          f"{len(flight)} flight events, counter lanes {lanes}; the device trace "
          f"({os.path.getsize(device_path) / 2**20:.1f} MiB) holds {len(kernels)} kernels, "
          f"flash by name {got}")
    # the window closes at the 4th step(): its export holds 4 steps' spans
    check(len(spans) == 8, f"the export holds {len(spans)} RecordEvent spans, expected 8")
    check(flight, "the export lacks the flight recorder's events")
    check(any(l.startswith("program_ms:captured:") for l in lanes),
          f"no counter lane for the captured step's key: {lanes}")
    want = cfg.num_layers * 2
    check(all(got[k] == want for k in ("fwd_sm90_kernel", "dkv_sm90_kernel", "dq_sm90_kernel"))
          and not any(got[k] for k in got if "sm90" not in k),
          f"the device trace holds {got}, expected {want} of each sm90 kernel and none else")
    table = sess.summary()
    check("step" in table and "data" in table, "summary() lacks the spans")
    print(json.dumps({"profile16": {"replay_ms": replay_ms, "span_us": span_us,
                                    "step_ms": replay_ms["none"], "telemetry_pct": tele_pct,
                                    "extra_peak_mib": (peaks["on"] - peaks["off"]) / 2**20,
                                    "flash_in_trace": got}}))
    return 0


def run_profiler_child():
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile16"],
                          capture_output=True, text=True, timeout=TRACE_CHILD_TIMEOUT_S)
    print(proc.stdout.rstrip())
    print(f"  (its process: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0:
        print(proc.stderr[-4000:])
    check(proc.returncode == 0, "16c failed")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"profile16"')][-1]
    return json.loads(line)["profile16"]


def _http(addr, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{addr}{path}", timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


SCRAPE_PATHS = ("/metrics", "/healthz", "/readyz", "/statusz", "/flight?last=16",
                "/programz?static=0")


def scrape_child(addr) -> int:
    """``python3 chip_smoke.py --scrape-child ADDR``: a scraper of the
    diagnostics server driven over its standard input, one byte a command.
    ``g`` starts a window of scrapes of its endpoints at ~10 Hz; ``s`` ends
    it, and the child prints one JSON line: every (path, status) the window
    got, its unanswered scrapes and every scrape's ms by path. It exits when
    its standard input closes."""
    import select
    import urllib.request  # noqa: F401 — imported before the first window

    print("ready", flush=True)
    while os.read(0, 1) == b"g":
        got, errors, ms = [], [], {}
        i = 0
        while True:
            path = SCRAPE_PATHS[i % len(SCRAPE_PATHS)]
            t0 = time.perf_counter()
            try:
                code, body = _http(addr, path)
                ms.setdefault(path, []).append((time.perf_counter() - t0) * 1e3)
                got.append((path, code if code == 200
                            else (code, body[:200].decode(errors="replace"))))
            except Exception as e:  # noqa: BLE001 — counted as an unanswered scrape
                errors.append(f"{path}: {e!r}")
            i += 1
            if select.select([0], [], [], 0.1)[0]:
                break
        print(json.dumps({"got": got, "errors": errors, "ms": ms}), flush=True)
        if os.read(0, 1) != b"s":
            break
    return 0


class _Scraper:
    """A scraper of the diagnostics server in a process of its own, as a
    metrics collector is: its HTTP client takes no share of the served
    process's interpreter lock, and the process starts once, before the
    first window. ``with scraper as w:`` scrapes for the block's length; ``w``
    then holds every (path, status) it got, the unanswered scrapes and every
    scrape's ms by path."""

    def __init__(self, addr):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--scrape-child", addr],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.window = None
        check(self.proc.stdout.readline().strip() == "ready", "the scraper process did not start")

    def _send(self, cmd):
        self.proc.stdin.write(cmd)
        self.proc.stdin.flush()

    def __enter__(self):
        self.window = types.SimpleNamespace(got=[], errors=[], ms={})
        self._send("g")
        return self.window

    def __exit__(self, *exc):
        self._send("s")
        line = self.proc.stdout.readline()
        if not line:
            self.window.errors = [f"the scraper process exited {self.proc.poll()}"]
            return
        doc = json.loads(line)
        self.window.got = [tuple(g) for g in doc["got"]]
        self.window.errors, self.window.ms = doc["errors"], doc["ms"]

    def close(self):
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


class _GcPauses:
    """Records the length of every garbage collection from now until
    ``close()``, in ms."""

    def __init__(self):
        self.ms, self._t0 = [], None
        gc.callbacks.append(self._note)

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms.append((time.perf_counter() - self._t0) * 1e3)

    def close(self):
        if self._note in gc.callbacks:
            gc.callbacks.remove(self._note)


def serving_ops_plane(torch, pt, card):
    """16d: phase 5b's engine on bench_serving's mix with the diagnostics
    server and the sentinel on: every scrape answers during a serve, the
    tokens equal the clean serve's, the decode step's device ms with and
    without scraping in turns; then a slowed decode trips the sentinel
    once, /healthz degrades, a postmortem names the key, recovery greens
    it."""
    import tempfile

    import numpy as np

    from paddle_tpu_torch import profiler, serving
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt2_345m
    from paddle_tpu_torch.profiler import diag, sentinel

    print(f"[16d] serving.Engine (GPT-2 345M f32, max_seq_len 2048) under the ops plane: "
          f"FLAGS_diag_port=0, the sentinel at {SENTINEL_16D}; {card}")
    pt.seed(0)
    cfg = gpt2_345m(max_seq_len=2048, dropout=0.0, attn_dropout=0.0)
    model = GPTForPretraining(cfg, device="gpu:0").eval()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, SERVE_PROMPT_LENS[i % len(SERVE_PROMPT_LENS)])
               for i in range(SERVE_REQUESTS)]
    eng = serving.Engine(model, serving.ServingConfig(block_size=16, prompt_buckets=[32, 64, 128],
                                                      num_blocks=256))
    pt.set_flags({"FLAGS_diag_port": 0})
    addr = diag.start()
    # every route's server-side ms, and every collection's, until the end
    route, server_ms = diag._route, {}

    def timed_route(path, qs):
        t0 = time.perf_counter()
        try:
            return route(path, qs)
        finally:
            server_ms.setdefault(path, []).append((time.perf_counter() - t0) * 1e3)

    diag._route = timed_route
    pauses = _GcPauses()
    scraper = None
    try:
        # the clean serve builds the engine's programs, scraped from its
        # start: the first scrape that overlaps a serve in a process costs
        # that serve ~100 ms of host time once (the line below prints it), a
        # warm-up cost, kept out of the timed serves as the captures are
        scraper = _Scraper(addr)
        t_serve = time.perf_counter()
        with scraper as warm:
            clean = [r.tokens for r in eng.serve(prompts, max_new_tokens=SERVE_NEW_TOKENS)]
        warm_ms = (time.perf_counter() - t_serve) * 1e3
        # then collect what the builds and the earlier phases left, and
        # freeze the survivors out of the collector's reach, as a server does
        # after its warm-up captures: a collection of this process's heap
        # inside a timed serve is a host pause of hundreds of ms (the line
        # below prints what the collection here took), and a pause in the
        # middle of a serve's admissions delays every request behind it,
        # which the serve_queue_wait key rightly reads as a sustained rise
        t_gc = time.perf_counter()
        heap = len(gc.get_objects())
        gc.collect()
        gc.freeze()
        gc_ms = (time.perf_counter() - t_gc) * 1e3
        n_warm_gc = len(pauses.ms)
        pmdir = tempfile.mkdtemp(prefix="pm16d_")
        # over the mix the sentinel's baselines freeze after a whole serve's
        # worth of observations: a serve's queue waits rise request by
        # request and its ticks alternate prefill and decode, so a baseline
        # frozen mid-serve reads the serve's own shape as drift
        pt.set_flags(dict(SENTINEL_16D, FLAGS_sentinel_warmup_steps=SERVE_REQUESTS,
                          FLAGS_postmortem_dir=pmdir))
        sentinel.reset()
        qw_key = f"serve_queue_wait[{eng._uid}]"
        threads = sorted(t.name for t in threading.enumerate())
        for path in server_ms:
            server_ms[path] = []
        decode_ms = {"plain": [], "scraped": []}
        # each serve's decode device ms median per decode program (batch,
        # blocks): a median over all of a serve's steps mixes its programs,
        # and moves by the spread between them when the mix or a few steps
        # do
        by_program = {"plain": [], "scraped": []}
        scrapes, errors, scrape_ms, serves = [], [], {}, []
        prof0 = profiler.dispatch_counters()
        sites0 = dict(prof0["perf_regression_sites"])
        for kind in ("plain", "scraped", "scraped", "plain") * SCRAPE_ROUNDS:
            eng.reset_stats()
            with scraper if kind == "scraped" else contextlib.nullcontext() as s:
                t_serve = time.perf_counter()
                resps = eng.serve(prompts, max_new_tokens=SERVE_NEW_TOKENS)
                wall_ms = (time.perf_counter() - t_serve) * 1e3
            if kind == "scraped":
                scrapes += s.got
                errors += s.errors
                for path, ms in s.ms.items():
                    scrape_ms.setdefault(path, []).extend(ms)
            check([r.tokens for r in resps] == clean,
                  f"the tokens of a {kind} serve differ from the clean serve's")
            steps = eng.step_timings()
            decode_ms[kind].append(statistics.median(
                t.device_ms for t in steps if t.kind == "decode"))
            per = {}
            for t in steps:
                if t.kind == "decode":
                    per.setdefault((t.batch, t.blocks), []).append(t.device_ms)
            by_program[kind].append({k: statistics.median(v) for k, v in per.items()})
            waits = [w for _, w in list(eng._admission._recent_waits)[-SERVE_REQUESTS:]]
            st = sentinel.state()["keys"].get(qw_key, {})
            serves.append(f"{kind[0]} {wall_ms:.1f}/"
                          f"{sum(t.feed_ms + t.launch_ms + t.wait_ms for t in steps):.1f}/"
                          f"{max(waits):.1f}/{st.get('ema_ms')}/{st.get('trips')}")
        pauses.close()
        # the gap: the median, over the rounds' (plain, scraped) pairs and
        # the decode programs both serves of a pair ran, of the difference
        # of that program's medians
        gaps = [sc[k] - pl[k] for pl, sc in zip(by_program["plain"], by_program["scraped"])
                for k in sorted(pl.keys() & sc.keys())]
        gap = statistics.median(gaps)
        serve_gap = statistics.median(
            b - a for a, b in zip(decode_ms["plain"], decode_ms["scraped"]))
        programs = sorted({k for per in by_program["plain"] + by_program["scraped"] for k in per})
        bad = [(p, c) for p, c in scrapes if c != 200]
        loop_trips = {k: v - sites0.get(k, 0)
                      for k, v in profiler.dispatch_counters()["perf_regression_sites"].items()
                      if v != sites0.get(k, 0)}
        qw = sentinel.state()["keys"].get(qw_key, {})
        loop_gc = pauses.ms[n_warm_gc:]

        def by_path(ms):
            return "; ".join(f"{p} {statistics.median(v):.2f} {max(v):.2f}"
                             for p, v in sorted(ms.items()) if v)

        print(f"  the clean serve, scraped from its start: {warm_ms:.1f} ms, scrape ms by path "
              f"(median, max) {by_path(warm.ms)}")
        print(f"  before the timed serves: {heap} objects collected and frozen in {gc_ms:.1f} ms; "
              f"during them {len(loop_gc)} collections, the longest "
              f"{max(loop_gc, default=0.0):.3f} ms; sentinel trips {loop_trips or 'none'}, "
              f"the queue-wait key's baseline {qw.get('baseline_ms')} ms, ema {qw.get('ema_ms')} "
              f"ms; threads {threads}")
        print("  serves (plain or scraped: wall ms / its steps' host ms / the last admission's "
              "wait ms / the queue-wait key's ema after it / its trips): " + "; ".join(serves))
        print(f"  scrape ms by path (median, max): at the scraper {by_path(scrape_ms)}; in the "
              f"server {by_path(server_ms)}")
        code, body = _http(addr, "/metrics")
        parsed = profiler.metrics.parse_prometheus_text(body.decode())
        cost_keys = [k for k in parsed if k.startswith("paddle_program_cost_measured_ms{")
                     and "serve:decode" in k]
        print(f"  {len(scrapes)} scrapes over {sum(p == '/metrics' for p, _ in scrapes)} "
              f"/metrics, {len(errors)} unanswered, non-200 {bad[:4]}; /metrics parses, "
              f"{len(parsed)} samples, {len(cost_keys)} serve:decode program-cost series; decode "
              f"device ms medians of each serve's steps plain {decode_ms['plain']}, scraped "
              f"{decode_ms['scraped']}, their median gap {serve_gap:+.4f} ms; decode programs "
              f"(batch, blocks) {programs}, gaps by pair and program "
              f"{[round(g, 4) for g in gaps]}, the median gap {gap:+.4f} ms (bound "
              f"{FAST_PATH_STEP_MS} ms); tokens equal the clean serve's")
        check(not errors and not bad and scrapes, f"scrapes failed: {errors[:2]} {bad[:4]}")
        check(code == 200 and cost_keys, "/metrics lacks the serve:decode program costs")
        check(abs(gap) <= FAST_PATH_STEP_MS, f"scraping moved the decode step by {gap:.4f} ms")

        # the slowed decode: the same bucket tick after tick, its programs
        # captured by a first serve (a capture inside the warm-up would
        # inflate the baseline) with the sentinel off (the captures hold the
        # queue, which the queue-wait key would page), then fresh baselines
        slow = rng.integers(1, cfg.vocab_size, (SLOW_REQUESTS, SLOW_PROMPT))
        pt.set_flags({"FLAGS_sentinel_pct": 0.0})
        eng.serve(list(slow), max_new_tokens=SLOW_NEW)
        sentinel.reset()
        pt.set_flags(SENTINEL_16D)
        eng.reset_stats()
        prof0 = profiler.dispatch_counters()
        sites0 = dict(prof0["perf_regression_sites"])
        trips0 = prof0["perf_regressions"]
        for p in slow:
            eng.submit(p, max_new_tokens=SLOW_NEW)
        real = eng._run_tiered
        tick = [0]
        sleep_s = [0.0]

        def slowed(key, fn, args):
            # between the step's two CUDA events: a host sleep, and a sleep
            # kernel of the same length on the stream (CUDA may hold the
            # start event's submission until the replay's, so a host gap
            # alone need not show in the events)
            if key[0] == "decode" and SLOW_TICKS[0] <= tick[0] < SLOW_TICKS[1]:
                time.sleep(sleep_s[0])
                torch.cuda._sleep(int(sleep_s[0] * 1e3 * QUEUE_SLEEP_CYCLES / 50))
            return real(key, fn, args)

        eng._run_tiered = slowed
        health = []
        try:
            while eng.pending:
                if tick[0] == SLOW_TICKS[0]:
                    base = [t.device_ms for t in eng.step_timings() if t.kind == "decode"]
                    sleep_s[0] = 2 * statistics.median(base[-8:]) / 1e3
                eng.step()
                tick[0] += 1
                if tick[0] in (SLOW_TICKS[1] - 1, SLOW_TICKS[1] + 30):
                    code, body = _http(addr, "/healthz")
                    health.append((tick[0], code, json.loads(body)))
        finally:
            eng._run_tiered = real
        c = profiler.dispatch_counters()
        sites = {k: v - sites0.get(k, 0) for k, v in c["perf_regression_sites"].items()
                 if v != sites0.get(k, 0)}
        keys = sentinel.state()["keys"]
        slow_ms = [round(t.device_ms, 3) for t in eng.step_timings() if t.kind == "decode"]
        print(f"  decode device ms by decode step around the slowdown: "
              f"{slow_ms[SLOW_TICKS[0] - 4:SLOW_TICKS[1] + 4]}; sentinel keys "
              + "; ".join(f"{k} seen {v['seen']} baseline {v['baseline_ms']} ema {v['ema_ms']} "
                          f"trips {v['trips']} suppressed {v['suppressed']} "
                          f"({v['last_suppressed']})" for k, v in keys.items()))
        decode_sites = [k for k in sites if k.startswith(f"serve_decode[{eng._uid}:")]
        (_, code_slow, doc_slow), (_, code_after, doc_after) = health
        pms = sorted(f for f in os.listdir(pmdir) if f.startswith("postmortem_perf_regression"))
        named = []
        for f in pms:
            with open(os.path.join(pmdir, f)) as fh:
                named += [t["key"] for t in json.load(fh)["attribution"]["programs"]["tripped"]]
        print(f"  slowed decode ticks {SLOW_TICKS} by {sleep_s[0] * 1e3:.2f} ms each (host and "
              f"stream): trips by "
              f"key {sites} ({c['perf_regressions'] - trips0} in all); /healthz at the last slow "
              f"tick {code_slow} {doc_slow['status']} {doc_slow['reasons']}, 30 ticks later "
              f"{code_after} {doc_after['status']}; {len(pms)} perf_regression postmortems "
              f"naming {named}")
        check(len(decode_sites) == 1 and sites[decode_sites[0]] == 1,
              f"the slowed decode key tripped {sites}, expected one serve_decode trip")
        check(code_slow == 503 and doc_slow["status"] == "degraded"
              and doc_slow["reasons"] == ["perf_regression"],
              f"/healthz during the slowdown: {code_slow} {doc_slow}")
        check(decode_sites[0] in named, "no postmortem's attribution names the slowed key")
        check(code_after == 200 and not sentinel.tripped(),
              f"/healthz after the slowdown: {code_after} {doc_after}")
    finally:
        if scraper is not None:
            scraper.close()
        pauses.close()
        gc.unfreeze()
        diag._route = route
        diag.stop()
        pt.set_flags({"FLAGS_sentinel_pct": 0.0, "FLAGS_sentinel_warmup_steps": 10,
                      "FLAGS_diag_port": -1, "FLAGS_postmortem_dir": ""})
        sentinel.reset()
        eng.close()
    del model
    torch.cuda.empty_cache()
    return {"decode_gap_ms": gap, "serve_decode_gap_ms": serve_gap, "scrapes": len(scrapes),
            "gc_pauses": len(loop_gc),
            "gc_longest_ms": max(loop_gc, default=0.0)}


def obs_probe_on_card(gate_step_ms):
    """16e: ``python -m paddle_tpu_torch.tools.obs_probe --batch 64`` in a
    process of its own, the overhead figures gated against ``gate_step_ms``
    (16c's O2 step) with the LeNet percentages beside them."""
    print(f"[16e] obs_probe on the card, LeNet batch 64 (BASELINE.json config 1), overheads "
          f"gated against the 345M O2 step ({gate_step_ms:.2f} ms)")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.tools.obs_probe", "--batch",
                           "64", "--gate-step-ms", f"{gate_step_ms:.4f}"], cwd=root,
                          capture_output=True, text=True, timeout=PROBE_TIMEOUT_S,
                          env=dict(os.environ, PYTHONPATH=root))
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    for r in rows:
        print("  " + json.dumps(r))
    print(f"  exit {proc.returncode} in {time.perf_counter() - t0:.1f} s: "
          f"{proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ''}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:])
    check(proc.returncode == 0 and "ALL SCENARIOS PASSED" in proc.stdout, "obs_probe failed")
    by = {r["scenario"]: r for r in rows}
    out = {"trace": (by["trace-overhead"]["overhead_pct"], by["trace-overhead"]["lenet_overhead_pct"],
                     by["trace-overhead"]["step_ms"]),
           "scrape": (by["diag-server"]["scrape_overhead_pct"],
                      by["diag-server"]["lenet_scrape_overhead_pct"],
                      by["diag-server"]["ab_step_ms_plain"]),
           "telemetry": (by["triage"]["telemetry_overhead_pct"],
                         by["triage"]["lenet_telemetry_overhead_pct"], by["triage"]["step_ms"])}
    print("  overheads, % of the 345M O2 step (gated, 1%) and of the LeNet step: "
          + "; ".join(f"{k} {g:.4f}% / {l:.4f}% (LeNet step {s:.3f} ms)"
                      for k, (g, l, s) in out.items()))
    return out


def slice18(torch, pt, fa, fu, dev, card):
    """Phase 16: 16a-16e. Returns their numbers."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kernels = telemetry_update_kernels(torch, pt, fu, gen, dev)
    f32 = telemetry_345m(torch, pt, fa, fu, dev)
    serving = serving_ops_plane(torch, pt, card)
    o2 = run_profiler_child()
    probe = obs_probe_on_card(o2["step_ms"])
    print(f"  phase 16 in {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "f32": f32, "o2": o2, "serving": serving, "probe": probe}


def slice18_alone(torch) -> int:
    """``python3 chip_smoke.py --phase16``: phase 16 alone, after building the
    libraries its paths launch (the tf32x3 and sm90 flash kernels, the fused
    updates)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_update as fu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    sources = [fa.TF32_FWD_KERNEL_NAME, fa.TF32_BWD_KERNEL_NAME, fa.SM90_FWD_KERNEL_NAME,
               fa.SM90_DKV_KERNEL_NAME, fa.SM90_DQ_KERNEL_NAME, fu.KERNEL_NAME]
    _build.build(sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    out = slice18(torch, pt, fa, fu, torch.device("cuda", 0), card)
    print(json.dumps({"phase16": out}, default=str))
    return 0


# Phase 17: static analysis and the memory plan, at GPT-2 345M's width.
# 17b's budget sits halfway between the planner's peak of the unplanned O2
# step and of the use_recompute step (the uniform per-block plan)
PLAN_STEPS = 3  # steps held bitwise, planned against unplanned (2 eager, 1 captured)
PLAN_TIMED = 3  # rounds of replays timed in turns
OFFLOAD_STEPS = 3  # steps held bitwise, offload on against off, per regime
# 17c: the share of the parked bytes the card must hold less at a step's
# peak. The moments come back (per-op) or are staged (captured) only for the
# update, into memory the forward's activations freed; the rest is left to
# the allocator's rounding. Staging beside the activations would save ~0.
OFFLOAD_KEPT = 0.75
# 17d: the budget of the planner-sized pool, and the ratio its overhead
# estimate must keep to the measured non-pool memory of a serve (the bound
# phase 16b holds the liveness planner to)
POOL_BUDGET_MB = 2048.0
POOL_RATIO = (0.5, 2.0)


def lint_and_certificates(torch, pt, fa, fu, dev):
    """17a: every pass over GPT-2 345M and ResNet-50 with no error; phase
    13b's Paddle-style 345M f32 step captured whole under
    FLAGS_check_programs=2 and certified against a recorded 3-program step,
    its graph's launches; an injected divergence; each serve program's rungs
    certified once."""
    import numpy as np
    from paddle_tpu_torch import analysis, serving
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    print("[17a] lint, and the equivalence certificates on the card")
    t0 = time.perf_counter()
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    pt.seed(SEED)
    gpt = GPTForPretraining(cfg, device=dev)
    lint = {}
    for name, model, specs in (
            ("gpt2_345m", gpt, [((2, cfg.max_seq_len), "int64")]),
            ("resnet50", pt.vision.models.resnet50().to(dev), [((2, 3, 224, 224), "float32")])):
        t1 = time.perf_counter()
        diags = analysis.check(model, specs)
        errors = [d for d in diags if d.severity >= analysis.Severity.ERROR]
        kinds = {}
        for d in diags:
            kinds[f"{d.pass_name}:{d.severity}"] = kinds.get(f"{d.pass_name}:{d.severity}", 0) + 1
        lint[name] = kinds
        print(f"  analysis.check({name}) over {len(analysis.pass_names())} passes in "
              f"{time.perf_counter() - t1:.2f} s: {kinds or 'clean'}")
        for d in errors:
            print(f"    {d}")
        check(not errors, f"the lint of {name} has error diagnostics")
        del model
    del gpt
    torch.cuda.empty_cache()

    # the captured Paddle-style step, certified before its first replay
    batch = 8
    data = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1))
    pt.set_flags({"FLAGS_pallas_fused_update": True, "FLAGS_check_programs": 2})
    pt.seed(SEED)
    model = GPTForPretraining(cfg)
    opt = pt.optimizer.Adam(learning_rate=1e-4, parameters=model.parameters())
    n_params = len(list(model.parameters()))
    crit = GPTPretrainingCriterion(cfg)
    ids = pt.to_tensor(data[:, :-1], dtype="int64")
    labels = pt.to_tensor(data[:, 1:], dtype="int64")
    lazy.reset_lazy_state()
    set_regime(pt, "captured")
    pt.profiler.reset_dispatch_counters()
    warm = pt.get_flags("FLAGS_eager_capture_warmup")["FLAGS_eager_capture_warmup"]
    built = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the donation gate's info findings, every replay
        for i in range(warm + 2):
            before = kernel_counts(fa, fu)
            t1 = time.perf_counter()
            loss = crit(model(ids), labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            float(loss)
            if i == warm:
                got = counts_since(fa, fu, before)
                built = {k: v for k, v in got.items() if v}
                build_s = time.perf_counter() - t1
    c = pt.profiler.dispatch_counters()
    cert = lazy.captured_step_certificate()
    print(f"  the 345M f32 step under FLAGS_check_programs=2: build (recording, capture, "
          f"proof) {build_s:.2f} s; {c['capture_equivalence_checks']} check, "
          f"{c['capture_equivalence_certified']} certified, {c['capture_replays']} replays; "
          f"{cert.summary() if cert else None}; the graph holds {built}")
    want = {"fwd_tf32x3": cfg.num_layers, "dkv_tf32x3": cfg.num_layers,
            "dq_tf32x3": cfg.num_layers, "adam": n_params}
    check(cert is not None and cert.equivalent and c["capture_equivalence_checks"] == 1,
          f"the captured 345M step was not certified once (the last capture error: "
          f"{lazy.last_capture_error[0]})")
    check(built == want, f"the certified graph holds {built}, expected {want}")
    check(c["capture_fallbacks"] == 0, "the certified step fell back")
    lazy.reset_lazy_state()
    del model, opt, loss
    torch.cuda.empty_cache()

    # an injected divergence: the reference recording altered, the capture
    # falls back (counted) and the step raises with the first divergence
    pt.seed(SEED)
    net = pt.nn.Sequential(pt.nn.Linear(1024, 1024), pt.nn.ReLU(), pt.nn.Linear(1024, 16))
    nopt = pt.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters())
    x = pt.to_tensor(np.random.default_rng(0).standard_normal((64, 1024)).astype(np.float32))
    y = pt.to_tensor(np.random.default_rng(1).integers(0, 16, (64,)))
    orig = lazy._build_captured_step

    def sabotaged(rec, opt_, live=()):
        entry = orig(rec, opt_, live)
        prog, labels_, outs = lazy._tls.reference_done
        bad = copy.copy(prog)
        bad.ops = list(prog.ops)
        for k, op in enumerate(bad.ops):
            pos = list(op.pos)
            hit = [i for i, a in enumerate(pos) if isinstance(a, float) and math.isfinite(a)
                   and a not in (0.0, 1.0)]
            if hit:
                pos[hit[0]] *= 2.0
                op = copy.copy(op)
                op.args = (tuple(pos), op.args[1])
                bad.ops[k] = op
                break
        entry.reference = (bad, labels_, outs)
        return entry

    lazy.reset_lazy_state()
    pt.profiler.reset_dispatch_counters()
    lazy._build_captured_step = sabotaged
    raised = None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for _ in range(warm + 2):
                loss = pt.nn.CrossEntropyLoss()(net(x), y)
                loss.backward()
                nopt.step()
                nopt.clear_grad()
    except analysis.ProgramVerificationError as e:
        raised = e
    finally:
        lazy._build_captured_step = orig
    c = pt.profiler.dispatch_counters()
    diag = raised.diagnostics[0] if raised is not None and raised.diagnostics else None
    print(f"  an injected divergence: fallbacks {dict(c['capture_fallback_reasons'])}, "
          f"divergences {c['capture_equivalence_divergences']}; {diag}")
    check(raised is not None and diag is not None and diag.pass_name == "equivalence",
          "the injected divergence did not raise with its diagnostic")
    check(dict(c["capture_fallback_reasons"]).get("verification_failed") == 1,
          "the injected divergence was not one counted fallback")
    lazy.reset_lazy_state()
    set_regime(pt, "per_op")

    # each serve program's rungs certified exactly once
    pt.seed(0)
    from paddle_tpu_torch.models.gpt import GPTConfig

    small = GPTForPretraining(GPTConfig(hidden_size=1024, num_layers=2, num_heads=16,
                                        max_seq_len=2048, dropout=0.0, attn_dropout=0.0),
                              device="gpu:0").eval()
    eng = serving.Engine(small, serving.ServingConfig(block_size=16, prompt_buckets=[32, 64, 128],
                                                      num_blocks=256))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 50304, SERVE_PROMPT_LENS[i % len(SERVE_PROMPT_LENS)])
               for i in range(SERVE_REQUESTS)]
    pt.profiler.reset_dispatch_counters()
    out = eng.serve(prompts, max_new_tokens=8)
    first = pt.profiler.dispatch_counters()
    eng.serve(prompts, max_new_tokens=8)
    again = pt.profiler.dispatch_counters()
    print(f"  serving (2 layers at the 345M width): {first['serve_capture_builds']} programs "
          f"built, {first['serve_equivalence_checks']} rung certificates "
          f"({first['serve_equivalence_certified']} certified); a second serve: "
          f"{again['serve_equivalence_checks'] - first['serve_equivalence_checks']} more checks, "
          f"{again['serve_capture_replays']} replays")
    check(all(r.status == "ok" for r in out), "a certified serve failed")
    check(first["serve_equivalence_checks"] == first["serve_equivalence_certified"]
          == first["serve_capture_builds"] > 0
          and again["serve_equivalence_checks"] == first["serve_equivalence_checks"],
          "the serve programs' rungs were not certified exactly once each")
    eng.close()
    pt.set_flags({"FLAGS_check_programs": 0, "FLAGS_pallas_fused_update": False})
    del small, eng
    torch.cuda.empty_cache()
    print(f"  17a in {time.perf_counter() - t0:.1f} s")
    return {"lint": lint, "certificate": cert.to_dict(), "built": built}


def remat_plan_345m(torch, pt, fa, dev):
    """17b: bench.py main()'s step (345M, 8 x 1024, O2 bf16, AdamW, dropout 0,
    compile_train_step): the plan at a budget between the unplanned and the
    uniform peaks, bitwise the unplanned step, its launches, the three steps'
    peaks and replay times."""
    from paddle_tpu_torch.analysis import plan as plan_mod
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m

    print("[17b] the remat plan of the 345M O2 step (8 x 1024, AdamW, compile_train_step)")
    t0 = time.perf_counter()
    batch = 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    failures = pt.profiler.dispatch_counters()["memory_plan_failures"]

    def build(recompute=False, memory_plan=None):
        pt.seed(SEED)
        cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0, use_recompute=recompute)
        model = pt.amp.decorate(GPTForPretraining(cfg, device=dev), level="O2",
                                dtype="bfloat16")
        crit = GPTPretrainingCriterion(cfg)
        opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                                 weight_decay=0.01)
        step = pt.jit.compile_train_step(model, lambda lo, la: crit(lo.float(), la), opt,
                                         memory_plan=memory_plan)
        return model, step

    cfg = gpt2_345m()
    ids = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1), generator=gen,
                        device=dev)
    x, y = ids[:, :-1], ids[:, 1:]

    def run(step, n):
        """``n`` steps; the launches of each, and the peak of the capture above
        what was allocated before it (the step's own transient memory: the
        parameters and states of every model alive are below it)."""
        losses, launches, peak = [], [], None
        for i in range(n):
            before = flash_counts(fa)
            if i == pt.jit.WARMUP_STEPS:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
            losses.append(float(step(x, y)))
            if i == pt.jit.WARMUP_STEPS:
                peak = torch.cuda.max_memory_allocated(dev) - held
            launches.append({k: v - before[k] for k, v in flash_counts(fa).items()
                             if v != before[k]})
        return losses, launches, peak

    models = {}
    m0, s0 = build()
    l0, k0, peak0 = run(s0, PLAN_STEPS)
    models["unplanned"] = (m0, s0)
    mu, su = build(recompute=True)
    _lu, ku, peak_u = run(su, PLAN_STEPS)
    models["uniform"] = (mu, su)
    plan_peak0, plan_peak_u = s0.memory_plan().peak_bytes, su.memory_plan().peak_bytes
    budget_mb = (plan_peak0 + plan_peak_u) / 2 / 2**20
    t1 = time.perf_counter()
    plan = s0.plan_remat(budget_mb=budget_mb)
    plan_s = time.perf_counter() - t1
    print(plan.summary())
    print(f"  planner peaks: unplanned {plan_peak0 / 2**30:.3f} GB, uniform recompute "
          f"{plan_peak_u / 2**30:.3f} GB, budget {budget_mb / 1024:.3f} GB; planned in "
          f"{plan_s:.2f} s over {plan.evals} estimates (none ran)")
    m1, s1 = build(memory_plan=plan)
    l1, k1, peak1 = run(s1, PLAN_STEPS)
    models["planned"] = (m1, s1)
    bitwise = l1 == l0 and all(torch.equal(a, b) for a, b in zip(m0.parameters(),
                                                                  m1.parameters()))
    remat_attn = sum(1 for _s, _e, p, _o in plan.remat_units if ".layers." in p)
    want = {"fwd_sm90": cfg.num_layers + remat_attn, "dkv_sm90": cfg.num_layers,
            "dq_sm90": cfg.num_layers}
    uniform_flops = sum(op.flops for op in su._last.ir.ops) if su._last.ir else 0
    print(f"  losses unplanned {l0}, planned {l1}: bitwise (losses and parameters) {bitwise}")
    print(f"  flash launches a step, planned: {k1}; unplanned {k0[-1]}; uniform {ku[-1]}; "
          f"expected planned {want} ({remat_attn} decoder layers recomputed)")
    print(f"  recompute FLOPs: planned {plan.recompute_flops:.4g} "
          f"({plan.recompute_pct:.1f}% of one forward), uniform {plan.full_remat_flops:.4g} "
          f"over the forward ({uniform_flops:.4g} recorded in its step)")
    recorded1 = s1.memory_plan().peak_bytes
    inputs = s0.memory_plan().input_bytes  # parameters, states, the batch
    transient = {"unplanned": plan.peak_before_bytes - inputs,
                 "planned": plan.peak_after_bytes - inputs, "uniform": plan_peak_u - inputs}
    print(f"  peaks: the planner's unplanned {plan.peak_before_bytes / 2**30:.3f} GB -> planned "
          f"{plan.peak_after_bytes / 2**30:.3f} GB (the planned step's own recording "
          f"{recorded1 / 2**30:.3f} GB), uniform {plan_peak_u / 2**30:.3f} GB, of which the "
          f"program's inputs {inputs / 2**30:.3f} GB; above them, the planner's unplanned / "
          f"planned / uniform " + " / ".join(f"{transient[k] / 2**30:.3f}" for k in
                                             ("unplanned", "planned", "uniform"))
          + f" GB against the measured {peak0 / 2**30:.3f} / {peak1 / 2**30:.3f} / "
          f"{peak_u / 2**30:.3f} GB (max_memory_allocated over each capture above what was "
          f"allocated before it: a replay's would miss the activations, which live in the "
          f"graph's pool)")
    budget_bytes = budget_mb * 2**20
    measured = {"unplanned": peak0, "planned": peak1, "uniform": peak_u}
    print(f"  measured over the planner's, above the inputs: " + ", ".join(
        f"{k} {measured[k] / transient[k]:.3f}x" for k in ("unplanned", "planned", "uniform"))
          + f"; the planned step measured with the inputs {(peak1 + inputs) / 2**30:.3f} GB "
          f"against its budget {budget_bytes / 2**30:.3f} GB")
    check(plan.has_cuts and plan.feasible, "the 345M plan is not feasible")
    check(peak1 + inputs <= budget_bytes,
          f"the planned step measured {(peak1 + inputs) / 2**30:.3f} GB with its inputs, over "
          f"its budget {budget_bytes / 2**30:.3f} GB")
    check(plan.recompute_flops < plan.full_remat_flops, "the plan recomputes as much as uniform")
    check(bitwise, "the planned step is not bitwise the unplanned step")
    check(all(k == want for k in k1), f"planned flash launches {k1}, expected {want} each step")
    failures = pt.profiler.dispatch_counters()["memory_plan_failures"] - failures
    check(failures == 0, f"{failures} memory plan failures")
    times = {k: [] for k in models}
    for _ in range(PLAN_TIMED):
        for name in ("unplanned", "planned", "uniform"):
            step = models[name][1]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            step(x, y)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"  ms per replay (CUDA events, median of {PLAN_TIMED} in turns): unplanned "
          f"{ms['unplanned']:.3f}, planned {ms['planned']:.3f}, uniform {ms['uniform']:.3f}")
    del models, m0, m1, mu, s0, s1, su
    torch.cuda.empty_cache()
    print(f"  17b in {time.perf_counter() - t0:.1f} s")
    return {"plan": plan.to_dict(), "launches": k1[-1], "want": want, "ms": ms,
            "peaks_gb": {"unplanned": peak0 / 2**30, "planned": peak1 / 2**30,
                         "uniform": peak_u / 2**30},
            "planner_transient_gb": {k: v / 2**30 for k, v in transient.items()},
            "planner_gb": {"before": plan.peak_before_bytes / 2**30,
                           "after": plan.peak_after_bytes / 2**30,
                           "uniform": plan_peak_u / 2**30}}


def offload_345m(torch, pt, fa, fu, dev):
    """17c: phase 13b's f32 Adam step on the fused kernel, eager (per-op) and
    captured, with offload.enable against without on twin models in turns:
    bitwise, the parked bytes, the blocked and step ms, the capture's
    data_ptr() gates."""
    import numpy as np
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion, gpt2_345m
    from paddle_tpu_torch.optimizer import offload

    print("[17c] host offload of the Adam moments, phase 13b's 345M f32 step, 8 x 1024")
    t0 = time.perf_counter()
    batch = 8
    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    data = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1))
    pt.set_flags({"FLAGS_pallas_fused_update": True})
    models, opts, workers = [], [], [_Worker(), _Worker()]
    for i in range(2):
        pt.seed(SEED)
        models.append(GPTForPretraining(cfg))
        opts.append(pt.optimizer.Adam(learning_rate=1e-4, parameters=models[-1].parameters()))
    sched = offload.enable(opts[1], overhead_pct=1e9)  # every moment stays parked here
    crit = GPTPretrainingCriterion(cfg)
    ids = pt.to_tensor(data[:, :-1], dtype="int64")
    labels = pt.to_tensor(data[:, 1:], dtype="int64")

    def step(i, regime):
        """One step: its loss, host ms, and the peak it allocated above what
        was allocated before it (a replay's misses its graph's pool)."""
        set_regime(pt, regime)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t1 = time.perf_counter()
        loss = crit(models[i](ids), labels)
        loss.backward()
        opts[i].step()
        opts[i].clear_grad()
        out = float(loss)
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t1) * 1e3,
                torch.cuda.max_memory_allocated(dev) - before)

    def moments(i):
        return [t for p in models[i].parameters() for t in (opts[i]._accumulators.get(id(p))
                                                            or {}).values() if t.dim() >= 1]

    res = {}
    for regime in ("per_op", "captured"):
        lazy.reset_lazy_state()
        n = OFFLOAD_STEPS + (pt.get_flags("FLAGS_eager_capture_warmup")[
            "FLAGS_eager_capture_warmup"] + 1 if regime == "captured" else 0)
        rows = {0: [], 1: []}
        ptrs = []
        for k in range(n):
            for i in (0, 1):
                rows[i].append(workers[i](step, i, regime))
                if regime == "captured" and i == 1:
                    ptrs.append(tuple(p.data_ptr() for p in models[1].parameters()))
        same = [a[0] for a in rows[0]] == [b[0] for b in rows[1]]
        parked, state = sched.parked_bytes(), sched.snapshot()
        # what each twin keeps on the card beyond its parameters, at its
        # step's peak: per-op, its moments between steps (the twin without
        # offload: every one) and the step's transient peak; captured, the
        # moments and its graph's pool, which holds every transient buffer
        # (the staged moments among them) between replays
        if regime == "per_op":
            extra = [max(r[2] for r in rows[i][-OFFLOAD_STEPS:]) for i in (0, 1)]
            how = "the step's max_memory_allocated above what was allocated before it"
        else:
            extra = [workers[i](lambda: lazy.captured_step_handle().pool_bytes())
                     for i in (0, 1)]
            how = "the graph pool's reserved segments"
        saved = parked - (extra[1] - extra[0])
        res[regime] = {"bitwise_losses": same, "step_ms_off": statistics.median(
            r[1] for r in rows[0][-OFFLOAD_STEPS:]), "step_ms_on": statistics.median(
            r[1] for r in rows[1][-OFFLOAD_STEPS:]), "parked_gb": parked / 2**30,
            "transient_gb_off": extra[0] / 2**30, "transient_gb_on": extra[1] / 2**30,
            "saved_gb": saved / 2**30, "state": state}
        print(f"  {regime}: losses bitwise {same}; step ms (host clock, median of the last "
              f"{OFFLOAD_STEPS}) without {res[regime]['step_ms_off']:.2f}, with "
              f"{res[regime]['step_ms_on']:.2f}; {parked / 2**30:.3f} GB parked; transient "
              f"({how}) without {extra[0] / 2**30:.3f} GB, with {extra[1] / 2**30:.3f} GB: the "
              f"card holds {saved / 2**30:.3f} GB less at the step's peak "
              f"({saved / max(parked, 1):.3f} of the parked); offload.state() {state}")
        check(same, f"offload changed the {regime} losses")
        check(parked > 0 and saved >= OFFLOAD_KEPT * parked,
              f"offload saved {saved} bytes at the {regime} step's peak, under "
              f"{OFFLOAD_KEPT:g} of the parked {parked}")
        if regime == "captured":
            c = pt.profiler.dispatch_counters()
            check(c["capture_replays"] >= 2 and len(set(ptrs[-OFFLOAD_STEPS:])) == 1,
                  "the offloaded capture moved a parameter or did not replay")
        sched.sync()
    sched.sync()
    same = bitwise_same(torch, models[0], models[1], opts[0], opts[1])
    print(f"  parameters and moments bitwise after both regimes: {same}; blocked ms "
          f"{sched.blocked_ema_ms:.3f} (the prefetch copies, measured by CUDA events), "
          f"step period {sched.step_ema_ms:.2f} ms")
    check(same, "offload left the twin models apart")
    offload.disable(opts[1])
    for w in workers:
        w.close()
    set_regime(pt, "per_op")
    pt.set_flags({"FLAGS_pallas_fused_update": False})
    lazy.reset_lazy_state()
    del models, opts
    torch.cuda.empty_cache()
    print(f"  17c in {time.perf_counter() - t0:.1f} s")
    return res


def budgeted_pool_345m(torch, pt, card):
    """17d: the engine's pool sized by the memory planner from
    FLAGS_memory_budget_mb: its overhead against the measured non-pool
    memory of a serve, bench_serving's mix, requests waiting for blocks,
    and the "no room" error."""
    import numpy as np
    from paddle_tpu_torch import profiler, serving
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt2_345m

    print(f"[17d] a planner-sized KV pool: serving.Engine(num_blocks=0), "
          f"FLAGS_memory_budget_mb={POOL_BUDGET_MB:g}; {card}")
    t0 = time.perf_counter()
    pt.seed(0)
    cfg = gpt2_345m(max_seq_len=2048, dropout=0.0, attn_dropout=0.0)
    model = GPTForPretraining(cfg, device="gpu:0").eval()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    pt.set_flags({"FLAGS_memory_budget_mb": POOL_BUDGET_MB})
    try:
        eng = serving.Engine(model, serving.ServingConfig(block_size=16,
                                                          prompt_buckets=[32, 64, 128],
                                                          num_blocks=0))
        plan = eng._pool_plan
        pool_bytes = plan.pool_bytes(eng._pool.num_blocks)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, SERVE_PROMPT_LENS[i % len(SERVE_PROMPT_LENS)])
                   for i in range(SERVE_REQUESTS)]
        profiler.reset_dispatch_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the weights, the pool, what else lives
        out = eng.serve(prompts, max_new_tokens=SERVE_NEW_TOKENS)
        torch.cuda.synchronize()
        # the serve's peak above what was held before it, plus the weights it
        # reads: what the planner's overhead stands for
        measured = torch.cuda.max_memory_allocated() - held + weights
        c = profiler.dispatch_counters()
        ratio = plan.overhead_bytes / measured
        # the weights are most of both, so the planner is held on the rest
        # too: the decode program's activations, gathered block views and
        # outputs, run at the geometry it planned (the largest batch at the
        # longest context, on a minimal pool) after one run that sets up
        # its streams, against its estimate
        args, _pool, _block = eng._plan_inputs(**eng._plan_args)
        eng._decode_fn(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        eng._decode_fn(*args)
        torch.cuda.synchronize()
        decode_act = torch.cuda.max_memory_allocated() - before
        feeds = sum(t.numel() * t.element_size() for t in args[2:])
        planner_act = plan.overhead_bytes - weights - feeds
        act_ratio = planner_act / max(decode_act, 1)
        del args
        print(f"  pool {eng._pool.num_blocks} blocks x {plan.block_bytes / 2**20:.3f} MB = "
              f"{pool_bytes / 2**30:.3f} GB of a {POOL_BUDGET_MB / 1024:.3f} GB budget; the "
              f"planner's overhead {plan.overhead_bytes / 2**30:.3f} GB (the decode program "
              f"recorded on a minimal pool, peak {plan.trace_peak_bytes / 2**30:.3f} GB) against "
              f"the measured non-pool memory of the serve {measured / 2**30:.3f} GB (its "
              f"max_memory_allocated above what was held before it, plus the weights "
              f"{weights / 2**30:.3f} GB): {ratio:.3f}x; less its inputs, the planner's "
              f"{planner_act / 2**20:.2f} MB against the decode program's "
              f"{decode_act / 2**20:.2f} MB run at the planned geometry "
              f"(max_memory_allocated above what was allocated before it): {act_ratio:.3f}x")
        check(POOL_RATIO[0] <= ratio <= POOL_RATIO[1],
              f"the pool planner's overhead is {ratio:.3f}x the measured one")
        check(POOL_RATIO[0] <= act_ratio <= POOL_RATIO[1],
              f"the pool planner's activations are {act_ratio:.3f}x the decode program's")
        check(all(r.status == "ok" for r in out) and c["serve_block_leaks"] == 0,
              "the budgeted serve failed or leaked blocks")
        # a pool smaller than the mix needs at once: requests wait for blocks
        need = max(eng._buckets.ctx_blocks(len(p), SERVE_NEW_TOKENS) for p in prompts)
        small_budget = (plan.overhead_bytes + 3 * need * plan.block_bytes) / 2**20
        pt.set_flags({"FLAGS_memory_budget_mb": small_budget})
        small = serving.Engine(model, serving.ServingConfig(block_size=16,
                                                            prompt_buckets=[32, 64, 128],
                                                            num_blocks=0))
        profiler.reset_dispatch_counters()
        out2 = small.serve(prompts, max_new_tokens=SERVE_NEW_TOKENS)
        c2 = profiler.dispatch_counters()
        peak_used = small._pool._peak_used
        print(f"  a {small._pool.num_blocks}-block pool ({small_budget:.1f} MB budget, ~3 of the "
              f"mix's largest contexts): all {len(out2)} requests answered "
              f"({sum(r.status == 'ok' for r in out2)} ok), peak {peak_used} blocks in use, "
              f"{c2['serve_block_leaks']} leaked")
        check(all(r.status == "ok" for r in out2) and c2["serve_block_leaks"] == 0,
              "the small budgeted pool failed a request or leaked")
        check(peak_used <= small._pool.num_blocks < sum(
            eng._buckets.ctx_blocks(len(p), SERVE_NEW_TOKENS) for p in prompts),
              "the small pool held the whole mix at once: nothing waited")
        small.close()
        pt.set_flags({"FLAGS_memory_budget_mb": plan.overhead_bytes / 2**20 / 2})
        try:
            serving.Engine(model, serving.ServingConfig(block_size=16,
                                                        prompt_buckets=[32, 64, 128],
                                                        num_blocks=0))
            refused = None
        except ValueError as e:
            refused = str(e)
        print(f"  a budget of half the overhead: {refused}")
        check(refused is not None and "no room" in refused, "a budget below the overhead "
              "built an engine")
        eng.close()
    finally:
        pt.set_flags({"FLAGS_memory_budget_mb": 0.0})
    del eng
    torch.cuda.empty_cache()
    detected = default_engine_on_card(torch, pt, model, prompts)
    del model
    torch.cuda.empty_cache()
    print(f"  17d in {time.perf_counter() - t0:.1f} s")
    return {"blocks": int(plan.num_blocks), "overhead_gb": plan.overhead_bytes / 2**30,
            "measured_gb": measured / 2**30, "ratio": ratio, "planner_act_mb": planner_act / 2**20,
            "decode_act_mb": decode_act / 2**20, "activation_ratio": act_ratio,
            "detected": detected}


def default_engine_on_card(torch, pt, model, prompts):
    """17d: a default engine (no num_blocks, no budget): the planner sizes
    its pool from the card's free memory less the headroom; it serves the
    mix, and the process then allocates half the headroom besides."""
    from paddle_tpu_torch import profiler, serving
    from paddle_tpu_torch.analysis import memory as mem

    total = torch.cuda.get_device_properties(0).total_memory
    free0 = torch.cuda.mem_get_info()[0]
    eng = serving.Engine(model, serving.ServingConfig(block_size=16,
                                                      prompt_buckets=[32, 64, 128]))
    plan = eng._pool_plan
    profiler.reset_dispatch_counters()
    out = eng.serve(prompts, max_new_tokens=SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    c = profiler.dispatch_counters()
    free1 = torch.cuda.mem_get_info()[0]
    extra_bytes = int(mem.DETECTED_HEADROOM * total / 2)
    extra = torch.ones(extra_bytes, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    got = int(extra[0]) == 1 and int(extra[-1]) == 1
    print(f"  a default engine (no num_blocks, no budget): {eng._pool.num_blocks} blocks = "
          f"{plan.pool_bytes(eng._pool.num_blocks) / 2**30:.3f} GB from the detected budget "
          f"{plan.budget_bytes / 2**30:.3f} GB (free {free0 / 2**30:.3f} GB of "
          f"{total / 2**30:.3f} before it, headroom {mem.DETECTED_HEADROOM:g} of the card); "
          f"the mix {sum(r.status == 'ok' for r in out)}/{len(out)} ok, "
          f"{c['serve_block_leaks']} leaked; free after the serve {free1 / 2**30:.3f} GB, then "
          f"{extra_bytes / 2**30:.3f} GB allocated besides: {got}")
    check(eng._pool.num_blocks > 256 and plan.budget_bytes is not None,
          "the default engine's pool was not sized from the card")
    check(all(r.status == "ok" for r in out) and c["serve_block_leaks"] == 0,
          "the default engine failed a request or leaked")
    check(got, "the process could not allocate half the headroom beside the default engine")
    del extra
    eng.close()
    del eng
    return {"blocks": int(plan.num_blocks), "budget_gb": plan.budget_bytes / 2**30,
            "free_before_gb": free0 / 2**30, "free_after_serve_gb": free1 / 2**30,
            "extra_gb": extra_bytes / 2**30}


def analysis_tools_on_card():
    """17e: graph_lint on a port builder file and mem_probe, each in a
    process of its own, on the card."""
    print("[17e] python -m paddle_tpu_torch.tools.graph_lint and .mem_probe on the card")
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name, cmd in (
            ("graph_lint", [sys.executable, "-m", "paddle_tpu_torch.tools.graph_lint",
                            "paddle_tpu_torch/examples/lint_models.py", "--memory-budget-mb",
                            "64", "--plan"]),
            ("mem_probe", [sys.executable, "-m", "paddle_tpu_torch.tools.mem_probe",
                           "--steps", "4"])):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
        out[name] = time.perf_counter() - t0
        tail = proc.stdout.strip().splitlines()[-6:]
        print(f"  {name}: exit {proc.returncode} in {out[name]:.1f} s; " + " | ".join(tail))
        if proc.returncode:
            print(proc.stderr[-2000:])
        check(proc.returncode == 0, f"{name} exited {proc.returncode} on the card")
    return out


def slice19(torch, pt, fa, fu, dev, card):
    """Phase 17: 17a-17e. Returns their numbers."""
    t0 = time.perf_counter()
    lint = lint_and_certificates(torch, pt, fa, fu, dev)
    remat = remat_plan_345m(torch, pt, fa, dev)
    offl = offload_345m(torch, pt, fa, fu, dev)
    pool = budgeted_pool_345m(torch, pt, card)
    tools = analysis_tools_on_card()
    print(f"  phase 17 in {time.perf_counter() - t0:.1f} s")
    return {"lint": lint, "remat": remat, "offload": offl, "pool": pool, "tools": tools}


def slice19_alone(torch) -> int:
    """``python3 chip_smoke.py --phase17``: phase 17 alone, after building the
    libraries its paths launch (the tf32x3 and sm90 flash kernels, the fused
    updates)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_update as fu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    sources = [fa.TF32_FWD_KERNEL_NAME, fa.TF32_BWD_KERNEL_NAME, fa.SM90_FWD_KERNEL_NAME,
               fa.SM90_DKV_KERNEL_NAME, fa.SM90_DQ_KERNEL_NAME, fu.KERNEL_NAME]
    _build.build(sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    out = slice19(torch, pt, fa, fu, torch.device("cuda", 0), card)
    print(json.dumps({"phase17": out}, default=str))
    return 0



# ---------------------------------------------------------------------------
# Phase 18: multi-GPU, part one. The ranks are processes of their own,
# started by the port's launcher on the one card; each imports torch and the
# port alone and prints one "PHASE18 {json}" line that the parent reads from
# its log. One card: NCCL runs at world size 1, and ranks that share the card
# run over gloo, which stages the card's tensors through the host. No number
# of these phases is a scaling figure.
# ---------------------------------------------------------------------------
P18_RANKS = 8                # 18b-18c: ranks sharing the card over gloo
P18_DEGREES = {"dp": 2, "mp": 2, "sharding": 2}
P18_ZERO3 = {"mp": 2, "sharding": 4}
P18_STEPS = 3                # steps held against the single card
# 18b: steps at hidden and attention dropout 0.1, replicated parameters held
# bitwise; the attention's masks drawn from the RNG tracker's mp stream
P18_DROPOUT_STEPS = 1
P18_DROPOUT = 0.1
# a rank's attention in 18b and 18c: 8 x 1024 split over dp x sharding (4),
# 16 heads over mp (2)
P18_SHAPE = (2, 1024, 8, 64)
P18_F32_LAYERS = 4           # 18c: the f32 parity's depth, at full width
P18_MOMENTS = ("moment1", "moment2")  # 18c: AdamW's state, held shard by shard
P18_COLL_RANKS = 4           # 18a: the ranks of the gloo collectives
P18_COLL_MB = 64             # 18a: each timed collective's input per rank
P18_COLL_REPS = 3
P18_LR = 1e-4                # bench.py main()'s AdamW
P18_CHILD_TIMEOUT_S = 900
# 18b: phase 7's O2 tolerance (tests/test_torch_train.py's O2 step against the
# JAX one): bf16 products in another split order over mp and the ranks' sums
TOL_P18_BF16 = 3e-2
# 18c: the JAX package's sharded-against-single tolerance
# (tests/test_distributed.py:147-149)
TOL_P18_F32 = dict(rtol=1e-4, atol=1e-5)
# 18a: gloo sums each collective's inputs in its own order against numpy's
TOL_P18_COLL = 1e-5


def p18_launch(torch, directory, kind, devices, env=None):
    """Run ``chip_smoke.py --phase18-child KIND DIR`` under the port's launcher
    on ``devices``; the ranks' results (each rank's last PHASE18 line), in
    rank order. Fails with the logs' tails when the launcher does."""
    root = os.path.dirname(os.path.abspath(__file__))
    log_dir = os.path.join(directory, f"logs_{kind}")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--devices", devices,
           "--log_dir", log_dir, os.path.abspath(__file__), "--phase18-child", kind, directory]
    full_env = dict(os.environ, **(env or {}), P18_LAUNCHED_AT=repr(time.time()))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=full_env, capture_output=True, text=True,
                          timeout=P18_CHILD_TIMEOUT_S)
    n = len(devices.split(","))
    logs = []
    for r in range(n):
        path = os.path.join(log_dir, f"workerlog.{r}")
        logs.append(open(path).read() if os.path.exists(path) else "")
    print(f"  ({kind}: {n} rank(s) through the launcher, exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0:
        print(proc.stdout[-2000:] + proc.stderr[-2000:])
        for r, log in enumerate(logs):
            print(f"  --- workerlog.{r} (tail) ---\n{log[-3000:]}")
    check(proc.returncode == 0, f"the phase 18 {kind} ranks failed")
    out = []
    for r, log in enumerate(logs):
        lines = [line for line in log.splitlines() if line.startswith("PHASE18 ")]
        check(bool(lines), f"rank {r} of {kind} printed no result")
        out.append(json.loads(lines[-1][len("PHASE18 "):]))
    return out


def p18_gpt_cfg(layers=None):
    from paddle_tpu_torch.models.gpt import gpt2_345m

    cfg = gpt2_345m(dropout=0.0, attn_dropout=0.0)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def p18_reference_f32(torch, pt, dev, directory, ids):
    """18c's single-card reference: the f32 GPT at full width and
    ``P18_F32_LAYERS`` layers from SEED, ``P18_STEPS`` eager steps of
    ``compile_train_step`` (its warm-up made that long: the rule's update,
    as the sharded step's). Saves the final parameters and Adam moments;
    returns the losses."""
    import numpy as np

    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion

    cfg = p18_gpt_cfg(P18_F32_LAYERS)
    pt.seed(SEED)
    model = GPTForPretraining(cfg, device=dev)
    crit = GPTPretrainingCriterion(cfg)
    opt = pt.optimizer.AdamW(learning_rate=P18_LR, parameters=model.parameters(),
                             weight_decay=0.01)
    warmup, pt.jit.WARMUP_STEPS = pt.jit.WARMUP_STEPS, P18_STEPS
    try:
        step = pt.jit.compile_train_step(model, lambda lo, la: crit(lo, la), opt)
        x = torch.as_tensor(ids[:, :-1], device=dev)
        y = torch.as_tensor(ids[:, 1:], device=dev)
        losses = [float(step(x, y)) for _ in range(P18_STEPS)]
    finally:
        pt.jit.WARMUP_STEPS = warmup
    np.savez(os.path.join(directory, "ref_f32.npz"),
             **{k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})
    np.savez(os.path.join(directory, "ref_f32_moments.npz"),
             **{f"{n}:{key}": v.detach().cpu().numpy()
                for n, p in model.named_parameters()
                for key, v in opt._accumulators[id(p)].items() if key in P18_MOMENTS})
    del model, opt, step
    torch.cuda.empty_cache()
    return losses


def p18_reference_o2(torch, pt, dev, ids):
    """18b's single-card losses where phase 7 did not run: bench.py main()'s
    O2 step through ``compile_train_step`` from SEED (phase 7's)."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion

    cfg = p18_gpt_cfg()
    pt.seed(SEED)
    model = pt.amp.decorate(GPTForPretraining(cfg, device=dev), level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion(cfg)
    opt = pt.optimizer.AdamW(learning_rate=P18_LR, parameters=model.parameters(),
                             weight_decay=0.01)
    step = pt.jit.compile_train_step(model, lambda lo, la: crit(lo.float(), la), opt)
    x = torch.as_tensor(ids[:, :-1], device=dev)
    y = torch.as_tensor(ids[:, 1:], device=dev)
    losses = [float(step(x, y)) for _ in range(P18_STEPS)]
    del model, opt, step
    torch.cuda.empty_cache()
    return losses


def slice20(torch, pt, fa, dev, card, phase7=None):
    """Phase 18 (18a-18d). ``phase7``: phase 7's first losses and batch, the
    18b reference. Returns the ranks' flash launches and the numbers."""
    import shutil
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    print(f"[18] multi-GPU, part one, on one card ({card}): ranks as processes of their own "
          f"through paddle_tpu_torch.distributed.launch; NCCL at world size 1, ranks sharing "
          f"the card over gloo (host-staged): no figure of this phase is a scaling figure")
    print(f"[18] the flash kernels at a rank's shape {P18_SHAPE}, causal, on fused-qkv views")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kernels = flash_kernels_at(
        torch, fa, gen, dev, P18_SHAPE, True,
        lambda dtype: qkv_on_card(P18_SHAPE, dtype, "fused", gen, dev), "phase 18's")
    print(f"  {time.perf_counter() - t0:.1f} s in")
    directory = tempfile.mkdtemp(prefix="phase18_")
    try:
        if phase7 is not None:
            ids, ref_o2 = phase7["ids"], phase7["first_losses"][:P18_STEPS]
            print(f"  18b's reference: phase 7's first {P18_STEPS} losses on its batch")
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            cfg = p18_gpt_cfg()
            ids = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len + 1), generator=gen,
                                device=dev).cpu().numpy()
            ref_o2 = p18_reference_o2(torch, pt, dev, ids)
            print(f"  18b's reference: bench.py main()'s O2 step on one card, {ref_o2}")
        np.save(os.path.join(directory, "ids.npy"), ids)
        t1 = time.perf_counter()
        ref_f32 = p18_reference_f32(torch, pt, dev, directory, ids)
        print(f"  18c's reference: the f32 {P18_F32_LAYERS}-layer step on one card, losses "
              + " ".join(f"{v:.6f}" for v in ref_f32) + f" ({time.perf_counter() - t1:.1f} s)")
        with open(os.path.join(directory, "plan.json"), "w") as f:
            json.dump({"ref_o2": ref_o2, "ref_f32": ref_f32}, f)
        # NCCL on a shared card: the launcher refuses before any rank starts
        # (its own entry point, called here: a process of its own would only
        # add the port's import)
        from paddle_tpu_torch.distributed.launch import launch

        t1, saved = time.perf_counter(), os.environ.get("PADDLE_DISTRI_BACKEND")
        os.environ["PADDLE_DISTRI_BACKEND"] = "nccl"
        try:
            launch(["--devices", "0,0", "--log_dir", os.path.join(directory, "logs_refused"),
                    os.path.abspath(__file__), "--phase18-child", "world1", directory])
            said = None
        except SystemExit as e:
            said = str(e)
        finally:
            if saved is None:
                del os.environ["PADDLE_DISTRI_BACKEND"]
            else:
                os.environ["PADDLE_DISTRI_BACKEND"] = saved
        print(f"  NCCL with --devices 0,0: {said} ({time.perf_counter() - t1:.2f} s)")
        check(said is not None and "Duplicate GPU" in said,
              "the launcher did not refuse NCCL on a shared card")
        (w1,) = p18_launch(torch, directory, "world1", "0")
        ranks = p18_launch(torch, directory, "ranks", ",".join(["0"] * P18_RANKS),
                           {"PADDLE_DISTRI_BACKEND": "gloo"})
        out = p18_report(w1, ranks, ref_o2, ref_f32)
        out["kernels"] = kernels
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    print(f"  phase 18 in {time.perf_counter() - t0:.1f} s")
    return out


def p18_report(w1, ranks, ref_o2, ref_f32):
    """Print and gate what the ranks reported; the flash launches summed."""
    # 18a
    c1 = w1["collectives"]
    print(f"[18a] world 1 under NCCL ({w1['backend']}), every collective on card tensors, "
          f"max |got - want|: " + ", ".join(f"{k} {v:.1e}" for k, v in c1.items()))
    check(all(v == 0.0 for v in c1.values()), "a world-1 NCCL collective changed its input")
    coll = [r["a"] for r in ranks if r["a"] is not None]
    check(len(coll) == P18_COLL_RANKS, "the gloo collectives ran on the wrong ranks")
    errs = {k: max(c["errors"][k] for c in coll) for k in coll[0]["errors"]}
    print(f"[18a] {P18_COLL_RANKS} ranks on one H100 over gloo, card tensors, each collective "
          f"against numpy, max |got - want|: " + ", ".join(f"{k} {v:.1e}" for k, v in
                                                          errs.items()))
    check(all(v <= TOL_P18_COLL for v in errs.values()),
          f"a gloo collective disagrees with numpy: {errs}")
    print(f"  gloo's own collectives on card tensors (torch {coll[0]['torch']}): "
          + ", ".join(f"{k}: {v}" for k, v in coll[0]["native"].items()))
    ms = {k: max(c["ms"][k] for c in coll) for k in coll[0]["ms"]}
    print(f"  {P18_COLL_MB} MB per rank, {P18_COLL_RANKS} ranks on one H100 over gloo, "
          f"host-staged, ms (median of {P18_COLL_REPS}, the slowest rank): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    # 18b
    b = [r["b"] for r in ranks]
    print(f"[18b] GPT-2 345M as dp2 x mp2 x sharding2 (ZeRO-2), O2 bf16, AdamW, global batch "
          f"8 x 1024, {P18_RANKS} ranks on one H100 over gloo (not a scaling figure)")
    worst = max(abs(a - w) for r in b for a, w in zip(r["losses"], ref_o2))
    print("  losses (rank 0): " + " ".join(f"{v:.4f}" for v in b[0]["losses"])
          + "; the single card's: " + " ".join(f"{v:.4f}" for v in ref_o2)
          + f"; max |d| over the ranks {worst:.3e} (tol {TOL_P18_BF16:g})")
    check(all(r["losses"] == b[0]["losses"] for r in b), "the ranks' losses differ")
    check(worst <= TOL_P18_BF16, "the hybrid step's losses stray from the single card's")
    layers = p18_gpt_cfg().num_layers
    for r, rb in enumerate(b):
        for i, per in enumerate(rb["launches_per_step"]):
            # attention dropout takes the dense attention, as in the JAX package
            want = ({"fwd_sm90": layers, "dkv_sm90": layers, "dq_sm90": layers}
                    if i < P18_STEPS else {})
            got = {k: v for k, v in per.items() if v}
            check(got == want, f"rank {r} step {i}: flash launches {got}, expected {want}")
        check(rb["shapes"] == [list(P18_SHAPE)],
              f"rank {r}: flash launches at {rb['shapes']}, expected {P18_SHAPE}")
    print(f"  every rank: {layers} sm90 forward, {layers} dK/dV and {layers} dQ launches a "
          f"step, at {P18_SHAPE} bf16 causal, steps 0-{P18_STEPS - 1}; none in the "
          f"{P18_DROPOUT_STEPS} at attention dropout {P18_DROPOUT} (the flash route takes no "
          f"dropout: the dense attention runs there, as in the JAX package)")
    masks = [rb["attn_masks"] for rb in b]
    check(all(m["draws"] == layers * P18_DROPOUT_STEPS for m in masks),
          f"attention dropout draws per rank {[m['draws'] for m in masks]}, expected "
          f"{layers * P18_DROPOUT_STEPS}")
    by_mp = {}
    for rb, m in zip(b, masks):
        by_mp.setdefault(rb["mp_rank"], set()).add(m["first"])
    print(f"  attention dropout: {layers * P18_DROPOUT_STEPS} draws a rank; the first layer's "
          f"dropped positions by mp rank: "
          + ", ".join(f"mp {k}: {sorted(v)}" for k, v in sorted(by_mp.items())))
    check(all(len(v) == 1 for v in by_mp.values()) and len(by_mp) == P18_DEGREES["mp"]
          and len(set().union(*by_mp.values())) == P18_DEGREES["mp"],
          "the attention's masks are not one stream per mp rank (the RNG tracker's "
          "model_parallel_rng): equal within an mp rank, different across them")
    step_ms = [statistics.median(r["step_ms"][1:]) for r in b]
    coll_ms = [statistics.median(r["coll_ms"][1:]) for r in b]
    for r, rb in enumerate(b):
        print(f"  rank {r}: step {step_ms[r]:.1f} ms (median of steps 1-{len(rb['step_ms']) - 1}; "
              f"step 0 {rb['step_ms'][0]:.1f}), collectives {coll_ms[r]:.1f} ms, compute "
              f"{step_ms[r] - coll_ms[r]:.1f} ms; peak memory {rb['peak_gb']:.2f} GB; moments "
              f"held {rb['moment_share']:.3f} of the parameters' elements")
    tokens = 8 * 1024 / (max(step_ms) / 1e3)
    print(f"  the {P18_RANKS} ranks: {tokens:.0f} tokens/s (8 ranks on one H100 over gloo, not "
          f"a scaling figure); peak memory summed {sum(r['peak_gb'] for r in b):.2f} GB")
    check(all(abs(r["moment_share"] - 0.5) < 0.01 for r in b),
          "a rank does not hold half of its moments")
    for i in range(P18_STEPS + P18_DROPOUT_STEPS):
        for name, layout in b[0]["layout"].items():
            mp_dim = layout[0]
            groups = {}
            for r, rb in enumerate(b):
                key = rb["mp_rank"] if mp_dim is not None else 0
                groups.setdefault(key, set()).add(rb["hashes"][i][name])
            check(all(len(v) == 1 for v in groups.values()),
                  f"step {i}: {name} differs across the ranks that replicate it")
    print(f"  every replicated parameter bitwise equal across its group after each of the "
          f"{P18_STEPS} steps and the {P18_DROPOUT_STEPS} at hidden and attention dropout "
          f"{P18_DROPOUT}")
    # 18c
    for j, c in enumerate(ranks[0]["c"]):
        print(f"[18c] f32, full width, {P18_F32_LAYERS} layers, {c['label']}: losses "
              + " ".join(f"{v:.6f}" for v in c["losses"]) + "; the single card's "
              + " ".join(f"{v:.6f}" for v in ref_f32)
              + f"; worst parameter excess over rtol {TOL_P18_F32['rtol']:g} atol "
              f"{TOL_P18_F32['atol']:g}: {c['worst'][0]} {c['worst'][1]:.3e}; flash launches a "
              f"step {c['launches_per_step']}")
        check(all(math.isclose(a, w, rel_tol=TOL_P18_F32["rtol"], abs_tol=TOL_P18_F32["atol"])
                  for a, w in zip(c["losses"], ref_f32)),
              f"18c {c['label']}: losses stray from the single card's")
        check(c["worst"][1] <= 0.0, f"18c {c['label']}: {c['worst'][0]} strays")
        cm = [r["c"][j]["moments"] for r in ranks]
        worst_m = max((m["worst"] for m in cm), key=lambda w: w[1])
        rel_m = max(m["rel"] for m in cm)
        print(f"  AdamW moments, each rank's shards against the single card's cut alike "
              f"({cm[0]['counted']} a rank): worst excess {worst_m[0]} {worst_m[1]:.3e}; "
              f"largest |got - want| / |want| (2-norm) {rel_m:.3e} (tol {TOL_P18_F32['rtol']:g})")
        check(worst_m[1] <= 0.0 and rel_m <= TOL_P18_F32["rtol"],
              f"18c {c['label']}: the moment shards stray from the single card's")
        want = {f"{k}_tf32x3": P18_F32_LAYERS for k in ("fwd", "dkv", "dq")}
        check(c["launches_per_step"] == want,
              f"18c {c['label']}: flash launches a step {c['launches_per_step']}, expected {want}")
        if "rest_share" in c:
            print(f"  ZeRO-3 at rest: each rank holds {c['rest_share']:.4f} of each cut "
                  f"parameter's global elements ({c['cut']} parameters cut)")
            check(c["rest_ok"], "a ZeRO-3 parameter at rest is not 1/4 of its global size "
                                "on its mp shard")
    # 18d
    d = w1["fleet1"]
    print(f"[18d] world 1 under NCCL through fleet (all degrees 1), bench.py main()'s O2 step: "
          f"losses " + " ".join(f"{v:.6f}" for v in d["losses"]) + f"; the eager "
          f"compile_train_step copy's " + " ".join(f"{v:.6f}" for v in d["copy_losses"])
          + f"; bitwise: losses {d['losses'] == d['copy_losses']}, parameters "
          f"{d['params_equal']}{'' if d['params_equal'] else ' (first differing: ' + str(d['first_diff']) + ')'}; "
          f"step {d['step_ms']:.1f} ms (fleet) against {d['copy_ms']:.1f} ms (copy), host clock")
    check(d["losses"] == d["copy_losses"] and d["params_equal"],
          "the world-1 fleet step is not bitwise the eager compile_train_step copy")
    launches = {"fwd_sm90": 0, "dkv_sm90": 0, "dq_sm90": 0, "fwd_tf32x3": 0, "dkv_tf32x3": 0,
                "dq_tf32x3": 0}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for k, v in w1["launches"].items():
        launches[k] = launches.get(k, 0) + v
    print(f"  flash launches over phase 18's paths (all ranks): {launches}")
    print(f"  seconds in the ranks (the slowest rank; start is the launcher's and the "
          f"interpreter's, set-up the port's import and the rendezvous): world 1 "
          + ", ".join(f"{k} {v:.1f}" for k, v in w1["laps"].items()) + f"; the "
          f"{P18_RANKS} ranks "
          + ", ".join(f"{k} {max(r['laps'][k] for r in ranks):.1f}" for k in ranks[0]["laps"]))
    return {"launches": launches, "step_ms": max(step_ms), "tokens_per_s": tokens,
            "coll_ms": ms, "peak_gb": [r["peak_gb"] for r in b]}


# -- the ranks ----------------------------------------------------------------
def p18_child(kind, directory) -> int:
    """``chip_smoke.py --phase18-child KIND DIR``: one rank of phase 18."""
    launched = float(os.environ.get("P18_LAUNCHED_AT", time.time()))
    laps, t0 = {"start": time.time() - launched}, time.perf_counter()

    def lap(name):
        nonlocal t0
        laps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(directory, "plan.json")) as f:
        plan = json.load(f)
    pt.distributed.init_parallel_env()
    dev = torch.device("cuda", torch.cuda.current_device())
    import numpy as np

    ids = np.load(os.path.join(directory, "ids.npy"))
    lap("set-up")
    if kind == "world1":
        out = {"backend": pt.distributed.get_group().backend,
               "collectives": p18_world1_collectives(torch, pt, dev)}
        lap("18a")
        reset_flash_counts(fa)
        out["fleet1"] = p18_fleet_world1(torch, pt, fa, dev, ids)
        lap("18d")
        out["launches"] = {k: v for k, v in flash_counts(fa).items() if v}
    else:
        reset_flash_counts(fa)
        out = {"a": p18_gloo_collectives(torch, pt, dev)}
        lap("18a")
        out["b"] = p18_hybrid_345m(torch, pt, fa, dev, ids)
        lap("18b")
        out["c"] = []
        for degrees, stage in ((P18_DEGREES, 2), (P18_ZERO3, 3)):
            out["c"].append(p18_f32_parity(torch, pt, fa, dev, ids, directory, plan, degrees,
                                           stage))
            lap(f"18c ZeRO-{stage}")
        out["launches"] = {k: v for k, v in flash_counts(fa).items() if v}
    laps["to its result"] = time.time() - launched
    out["laps"] = laps
    print("PHASE18 " + json.dumps(out), flush=True)
    # no rank leaves while another still talks to it
    pt.distributed.barrier()
    pt.distributed.destroy_process_group()
    return 0


def p18_world1_collectives(torch, pt, dev):
    """Every collective of the world-1 NCCL group on card tensors; the
    largest change each made to what world 1 gives (0 for all)."""
    from paddle_tpu_torch.distributed import collective as C

    x = torch.arange(24, dtype=torch.float32, device=dev).reshape(4, 6) / 7.0
    out = {}

    def diff(a, b):
        return float((a - b).abs().max())

    for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX), ("min", C.ReduceOp.MIN),
                     ("prod", C.ReduceOp.PROD), ("avg", C.ReduceOp.AVG)):
        t = x.clone()
        C.all_reduce(t, op)
        out[f"all_reduce_{name}"] = diff(t, x)
    got = []
    C.all_gather(got, x)
    out["all_gather"] = diff(torch.stack(got), x[None])
    t = x.clone()
    C.broadcast(t, src=0)
    out["broadcast"] = diff(t, x)
    t = x.clone()
    C.reduce(t, dst=0)
    out["reduce"] = diff(t, x)
    t = torch.empty_like(x)
    C.scatter(t, [x], src=0)
    out["scatter"] = diff(t, x)
    t = torch.empty_like(x)
    C.reduce_scatter(t, x)
    out["reduce_scatter"] = diff(t, x)
    out["alltoall"] = diff(torch.stack(C.alltoall([x])), x[None])
    out["alltoall_single"] = diff(C.alltoall_single(x), x)
    out["shift_wrap"] = diff(C.shift(x, 1, wrap=True), x)
    out["ppermute"] = diff(C.ppermute(x, [(0, 0)]), x)
    C.barrier()
    C.wait(x)
    obj = C.all_gather_object([], {"rank": 0})
    out["all_gather_object"] = 0.0 if obj == [{"rank": 0}] else 1.0
    return out


def p18_fleet_world1(torch, pt, fa, dev, ids):
    """18d: bench.py main()'s O2 step through fleet at world 1 against an
    eager ``compile_train_step`` copy (its warm-up made ``P18_STEPS`` long)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion

    strategy = fleet.DistributedStrategy()
    strategy.amp = True
    strategy.amp_configs = {"use_pure_bf16": True}
    fleet.init(is_collective=True, strategy=strategy)
    cfg = p18_gpt_cfg()
    pt.seed(SEED)
    model = GPTForPretraining(cfg, device=dev)
    twin = copy.deepcopy(model)
    model = fleet.distributed_model(pt.amp.decorate(model, level="O2", dtype="bfloat16"))
    twin = pt.amp.decorate(twin, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion(cfg)

    def loss_fn(logits, labels):
        return crit(logits.float(), labels)

    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=P18_LR, parameters=model.parameters(), weight_decay=0.01))
    step = fleet.distributed_train_step(model, loss_fn, opt)
    opt_t = pt.optimizer.AdamW(learning_rate=P18_LR, parameters=twin.parameters(),
                               weight_decay=0.01)
    x = torch.as_tensor(ids[:, :-1], device=dev)
    y = torch.as_tensor(ids[:, 1:], device=dev)

    def run(fn):
        losses, times = [], []
        for _ in range(P18_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(fn(x, y)))
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, statistics.median(times[1:])

    losses, step_ms = run(step)
    warmup, pt.jit.WARMUP_STEPS = pt.jit.WARMUP_STEPS, P18_STEPS
    try:
        copy_losses, copy_ms = run(pt.jit.compile_train_step(twin, loss_fn, opt_t))
    finally:
        pt.jit.WARMUP_STEPS = warmup
    first = next((n for (n, a), (_, b) in zip(model.named_parameters(),
                                              twin.named_parameters())
                  if not torch.equal(a, b)), None)
    return {"losses": losses, "copy_losses": copy_losses, "params_equal": first is None,
            "first_diff": first, "step_ms": step_ms, "copy_ms": copy_ms}


def p18_gloo_collectives(torch, pt, dev):
    """18a: ranks 0-3 of the world over gloo, card tensors: each collective
    against numpy, gloo's own support of the card's tensors, and each
    collective's ms at ``P18_COLL_MB`` per rank. None on the other ranks."""
    import numpy as np
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import collective as C

    group = C.new_group(list(range(P18_COLL_RANKS)), backend="gloo")
    rank, n = pt.distributed.get_rank(), P18_COLL_RANKS
    if rank >= n:
        C.barrier()
        return None
    shape = (8, 6)

    def inp(r):
        return np.random.default_rng(SEED + r).standard_normal(shape).astype(np.float32)

    xs = [inp(r) for r in range(n)]
    x = torch.as_tensor(xs[rank], device=dev)
    errs = {}

    def err(name, got, want):
        got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        errs[name] = float(np.max(np.abs(got - np.asarray(want))))

    for name, op, ref in (("sum", C.ReduceOp.SUM, np.sum), ("max", C.ReduceOp.MAX, np.max),
                          ("avg", C.ReduceOp.AVG, np.mean)):
        t = x.clone()
        C.all_reduce(t, op, group)
        err(f"all_reduce_{name}", t, ref(np.stack(xs), axis=0))
    got = []
    C.all_gather(got, x, group)
    err("all_gather", torch.stack(got), np.stack(xs))
    t = x.clone()
    C.broadcast(t, src=n - 1, group=group)
    err("broadcast", t, xs[-1])
    t = x.clone()
    C.reduce(t, dst=0, group=group)
    err("reduce", t, np.sum(xs, axis=0) if rank == 0 else xs[rank])
    parts = [torch.as_tensor(inp(100 + i), device=dev) for i in range(n)]
    t = torch.empty_like(x)
    C.scatter(t, parts, src=0, group=group)
    err("scatter", t, inp(100 + rank))
    t = torch.empty((shape[0] // n,) + shape[1:], device=dev)
    C.reduce_scatter(t, x, group=group)
    err("reduce_scatter", t, np.split(np.sum(xs, axis=0), n)[rank])
    outs = C.alltoall(list(x.chunk(n)), group=group)
    err("alltoall", torch.stack(outs), np.stack([np.split(xs[i], n)[rank] for i in range(n)]))
    err("alltoall_single", C.alltoall_single(x, group=group),
        np.concatenate([np.split(xs[i], n)[rank] for i in range(n)]))
    err("shift", C.shift(x, 1, group=group), xs[rank - 1] if rank else np.zeros(shape))
    t = x.clone()
    if rank == 0:
        C.send(t, dst=n - 1, group=group)
    elif rank == n - 1:
        C.recv(t, src=0, group=group)
    err("send_recv", t, xs[0] if rank == n - 1 else xs[rank])
    # gloo's own collectives on card tensors (a probe: the port hands these to
    # gloo as they are, and stages only scatter and the point-to-point sends
    # through the host itself)
    native = {}
    big = torch.ones(n * 4, device=dev)
    for name, fn in (
            ("all_gather", lambda: dist.all_gather([torch.empty(4, device=dev)
                                                    for _ in range(n)], big[:4], group=group.pg)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(n * 4, device=dev), big[:4], group=group.pg)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(4, device=dev), big, group=group.pg)),
            ("all_to_all_single", lambda: dist.all_to_all_single(
                torch.empty(n * 4, device=dev), big, group=group.pg)),
            ("all_to_all", lambda: dist.all_to_all(
                [torch.empty(4, device=dev) for _ in range(n)], list(big.chunk(n)),
                group=group.pg))):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fn()
            torch.cuda.synchronize()
            native[name] = "takes them"
        except Exception as e:  # the probe's answer, printed
            native[name] = f"refuses ({type(e).__name__}: {str(e).splitlines()[0][:80]})"
    # each collective's time at P18_COLL_MB per rank
    elems = P18_COLL_MB * 2 ** 20 // 4
    big = torch.randn(elems, device=dev)
    ops = {
        "all_reduce": lambda: C.all_reduce(big.clone(), group=group),
        "all_gather": lambda: C.all_gather([], big, group=group),
        "reduce_scatter": lambda: C.reduce_scatter(torch.empty(elems // n, device=dev), big,
                                                   group=group),
        "broadcast": lambda: C.broadcast(big, src=0, group=group),
        "alltoall_single": lambda: C.alltoall_single(big, group=group),
    }
    ms = {}
    for name, fn in ops.items():
        times = []
        for _ in range(P18_COLL_REPS + 1):
            C.barrier(group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(times[1:])
    del big
    C.barrier()
    return {"errors": errs, "native": native, "ms": ms, "torch": torch.__version__}


class _CollectiveTimer:
    """Host time spent in the port's collectives (each call synchronised
    with the card on both sides), while installed."""

    def __init__(self, torch, C):
        self.torch, self.C, self.ms, self.depth = torch, C, 0.0, 0
        self.saved = {n: getattr(C, n) for n in ("all_reduce_", "all_gather_cat",
                                                 "reduce_scatter_dim")}
        for name, fn in self.saved.items():
            setattr(C, name, self._timed(fn))

    def _timed(self, fn):
        def call(*a, **k):
            if self.depth:  # inside another timed collective
                return fn(*a, **k)
            self.depth += 1
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.torch.cuda.synchronize()
                self.ms += (time.perf_counter() - t0) * 1e3
                self.depth -= 1
        return call

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.C, name, fn)


def p18_shapes(fa):
    """Record the (shape) of every flash launch while installed; ``close()``."""
    seen = set()
    saved = {n: getattr(fa, n) for n in ("_fwd_cuda", "_bwd_dkv_cuda", "_bwd_dq_cuda")}

    def wrap(fn):
        def call(q, *a, **k):
            seen.add(tuple(q.shape))
            return fn(q, *a, **k)
        return call

    for n, fn in saved.items():
        setattr(fa, n, wrap(fn))

    def close():
        for n, fn in saved.items():
            setattr(fa, n, fn)
        return sorted(list(s) for s in seen)
    return close


def p18_attention_masks(torch):
    """Record the attention's dropout draws while installed (the dense
    attention's ``nn_ops.dropout`` over [b, h, s, s] probabilities); the
    call returns their count and the hash of the first one's dropped
    positions, and uninstalls."""
    from paddle_tpu_torch.ops import nn_ops

    saved = nn_ops.dropout
    seen = []

    def call(x, *a, **k):
        y = saved(x, *a, **k)
        if x.dim() == 4:
            if not seen:
                seen.append(_p18_hash(torch, (y == 0) & (x != 0)))
            else:
                seen.append(None)
        return y

    nn_ops.dropout = call

    def close():
        nn_ops.dropout = saved
        return {"draws": len(seen), "first": seen[0] if seen else None}
    return close


def _p18_hash(torch, t):
    import hashlib

    raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha1(raw.tobytes()).hexdigest()[:20]


def p18_hybrid_345m(torch, pt, fa, dev, ids):
    """18b: GPT-2 345M at full width as dp2 x mp2 x sharding2 (ZeRO-2), O2
    bf16, AdamW, the global batch on every rank."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import (GPTAttention, GPTForPretraining,
                                             GPTPretrainingCriterion)

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in P18_DEGREES.items()}
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 2}
    strategy.amp = True
    strategy.amp_configs = {"use_pure_bf16": True}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    cfg = p18_gpt_cfg()
    with pt.parallel.topology.use_mesh(None):  # the whole model from SEED: phase 7's weights
        pt.seed(SEED)
        whole = GPTForPretraining(cfg, device=dev).state_dict()
    model = GPTForPretraining(cfg, device=dev)
    convert.load_global_state(model, whole)
    del whole
    torch.cuda.empty_cache()
    model = fleet.distributed_model(pt.amp.decorate(model, level="O2", dtype="bfloat16"))
    crit = GPTPretrainingCriterion(cfg)

    def loss_fn(logits, labels):
        return crit(logits.float(), labels)

    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=P18_LR, parameters=model.parameters(), weight_decay=0.01))
    step = fleet.distributed_train_step(model, loss_fn, opt)
    x = torch.as_tensor(ids[:, :-1], device=dev)
    y = torch.as_tensor(ids[:, 1:], device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"losses": [], "step_ms": [], "coll_ms": [], "launches_per_step": [], "hashes": [],
           "mp_rank": hcg.get_model_parallel_rank(), "layout": convert.model_layout(model)}
    timer = _CollectiveTimer(torch, C)
    close_shapes = p18_shapes(fa)
    masks = None
    try:
        for i in range(P18_STEPS + P18_DROPOUT_STEPS):
            if i == P18_STEPS:
                for m in model.modules():
                    if isinstance(m, pt.nn.Dropout):
                        m.p = P18_DROPOUT
                    if isinstance(m, GPTAttention):  # read in its forward
                        m.cfg = dataclasses.replace(m.cfg, attn_dropout=P18_DROPOUT)
                masks = p18_attention_masks(torch)
            before = flash_counts(fa)
            timer.ms = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(x, y))
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["coll_ms"].append(timer.ms)
            out["launches_per_step"].append(
                {k: v - before[k] for k, v in flash_counts(fa).items()})
            if i < P18_STEPS:
                out["losses"].append(loss)
            out["hashes"].append({n: _p18_hash(torch, p) for n, p in model.named_parameters()})
    finally:
        timer.close()
        out["shapes"] = close_shapes()
        if masks is not None:
            out["attn_masks"] = masks()
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    held = sum(opt._accumulators[id(p)]["moment1"].numel() for p in model.parameters())
    out["moment_share"] = held / sum(p.numel() for p in model.parameters())
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def p18_f32_parity(torch, pt, fa, dev, ids, directory, plan, degrees, stage):
    """18c: the f32 GPT at full width and ``P18_F32_LAYERS`` layers at
    ``degrees`` and ZeRO ``stage`` against the single card; rank 0 compares
    every gathered parameter."""
    import numpy as np

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    strategy.sharding = True
    strategy.sharding_configs = {"stage": stage}
    fleet.init(is_collective=True, strategy=strategy)
    cfg = p18_gpt_cfg(P18_F32_LAYERS)
    with pt.parallel.topology.use_mesh(None):
        pt.seed(SEED)
        whole = GPTForPretraining(cfg, device=dev).state_dict()
    model = GPTForPretraining(cfg, device=dev)
    convert.load_global_state(model, whole)
    model = fleet.distributed_model(model)
    label = " x ".join(f"{k}{v}" for k, v in degrees.items()) + f" (ZeRO-{stage})"
    out = {"label": label}
    if stage == 3:
        layout = convert.model_layout(model)
        cut = [(n, p) for n, p in model.named_parameters() if layout[n][1] is not None]
        shares = []
        for n, p in cut:
            mp = degrees["mp"] if layout[n][0] is not None else 1
            shares.append(p.numel() * mp / whole[n].numel())
        out["cut"] = len(cut)
        out["rest_share"] = max(shares)
        out["rest_ok"] = bool(cut) and all(abs(s - 1 / degrees["sharding"]) < 1e-9
                                           for s in shares)
    del whole
    crit = GPTPretrainingCriterion(cfg)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=P18_LR, parameters=model.parameters(), weight_decay=0.01))
    step = fleet.distributed_train_step(model, lambda lo, la: crit(lo, la), opt)
    x = torch.as_tensor(ids[:, :-1], device=dev)
    y = torch.as_tensor(ids[:, 1:], device=dev)
    before = flash_counts(fa)
    out["losses"] = [float(step(x, y)) for _ in range(P18_STEPS)]
    out["launches_per_step"] = {k: (v - before[k]) // P18_STEPS
                                for k, v in flash_counts(fa).items() if v - before[k]}
    # each rank's moment shards against the single card's moments cut as the
    # sharded step cuts them: a gradient averaged over the wrong ranks, or
    # summed, leaves AdamW's update and so the parameters nearly as they are,
    # but not the moments
    inner = getattr(opt, "_inner", opt)
    ref_m = np.load(os.path.join(directory, "ref_f32_moments.npz"))
    worst_m, rel_m, counted = ("", -1.0), 0.0, 0
    for name, p in model.named_parameters():
        for key in P18_MOMENTS:
            want = np.asarray(convert.shard_moment(ref_m[f"{name}:{key}"], p))
            got = inner._accumulators[id(p)][key].detach().cpu().numpy()
            check(got.shape == want.shape, f"18c {label}: {name} {key} holds {got.shape}, "
                                           f"expected {want.shape}")
            excess = float(np.max(np.abs(got - want) - TOL_P18_F32["atol"]
                                  - TOL_P18_F32["rtol"] * np.abs(want)))
            if excess > worst_m[1]:
                worst_m = (f"{name} {key}", excess)
            rel_m = max(rel_m, float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                                      1e-30)))
            counted += 1
    out["moments"] = {"worst": worst_m, "rel": rel_m, "counted": counted}
    state = convert.gather_model_state(model)
    worst = ("", -1.0)
    if pt.distributed.get_rank() == 0:
        ref = np.load(os.path.join(directory, "ref_f32.npz"))
        for name, got in state.items():
            want = ref[name]
            excess = float(np.max(np.abs(got - want) - TOL_P18_F32["atol"]
                                  - TOL_P18_F32["rtol"] * np.abs(want)))
            if excess > worst[1]:
                worst = (name, excess)
    out["worst"] = worst
    del model, opt, step, state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if "--scrape-child" in sys.argv:
        return scrape_child(sys.argv[sys.argv.index("--scrape-child") + 1])
    import torch

    if "--tf32-repeat" in sys.argv:
        return tf32_repeat_witness(int(sys.argv[sys.argv.index("--tf32-repeat") + 1]))
    if "--resume-child" in sys.argv:
        at = sys.argv.index("--resume-child")
        return resume_child(sys.argv[at + 1], sys.argv[at + 2])
    if "--trace" in sys.argv:
        return trace_child(sys.argv[sys.argv.index("--trace") + 1])
    if "--eager-dispatch" in sys.argv:
        return eager_dispatch_alone(torch)
    if "--phase14" in sys.argv:
        return slice16_alone(torch)
    if "--phase15" in sys.argv:
        return slice17_alone(torch)
    if "--phase16" in sys.argv:
        return slice18_alone(torch)
    if "--phase17" in sys.argv:
        return slice19_alone(torch)
    if "--phase18" in sys.argv:
        return slice20_alone(torch)
    if "--phase18-child" in sys.argv:
        at = sys.argv.index("--phase18-child")
        return p18_child(sys.argv[at + 1], sys.argv[at + 2])
    if "--profile16" in sys.argv:
        return profiler_child()
    if "--host-cost-child" in sys.argv:
        return host_cost_child(sys.argv[sys.argv.index("--host-cost-child") + 1])
    if "--host-cost-vs" in sys.argv:
        return host_cost_in_turns(sys.argv[sys.argv.index("--host-cost-vs") + 1])
    if "--tf32-repeat-once" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from paddle_tpu_torch.ops.kernels import flash_attention as fa

        return 0 if tf32_repeat_once(torch, fa, torch.device("cuda", 0)) else 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(label):
        """Each phase's time, printed at its end."""
        now = time.perf_counter()
        print(f"  [time] phase {label}: {now - laps[-1]:.1f} s ({now - t_start:.1f} s in)")
        laps.append(now)
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
    ps_built = start_ps_build()  # g++ builds phase 15's host libraries meanwhile
    logs = _build.build(sources)
    print(f"[2] built {sources} in {time.perf_counter() - t0:.1f} s")
    lap("2 build")
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
    lap("3")

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
    # the surface's host cost per op before any profiler session (phase 5c
    # and 8 trace, and a session makes later launches dearer on the host);
    # phase 11b-iii measures it again at its own place
    print("[5a] host cost per op of the tensor surface before any profiler session, small "
          "card tensors (16 x 16)")
    early_host_us = host_cost_per_op(torch, pt, dev)
    lap("4-5a")

    # 5b. the serving engine
    served = serve_345m(torch, pt, fa, fu, card)
    lap("5b")
    # 5c. serving under faults
    serve_under_faults(torch, pt, fa, fu, card, served)
    lap("5c")
    del served
    torch.cuda.empty_cache()

    bwd = check_backward_kernels(torch, fa, gen, dev)
    simt_path = simt_backward_path(torch, pt, fa, gen, dev)
    lap("6")
    train = train_345m(torch, pt, fa, gen, dev)
    lap("7")
    # 7b. recompute with dropout, the O1 fp16 loop, an input's gradient;
    # before phase 8's trace: a torch.profiler run leaves every later launch
    # dearer on the host
    recompute = recompute_step_345m(torch, pt, fa, gen, dev, train)
    o1 = o1_fp16_scaler_345m(torch, pt, fa, fu, gen, dev)
    grad_input_step(torch, pt, fa, gen, dev)
    lap("7b")
    torch.cuda.empty_cache()
    run_trace_child("gpt")
    lap("8")
    # 7c. checkpoint and resume, in processes of its own (phase 7's step is
    # freed by now)
    resume = checkpoint_resume_345m(torch, card)
    lap("7c")
    # 7d. BERT-base pretraining: the non-causal flash kernels on a model's path
    bert = bert_pretraining(torch, pt, fa, gen, dev)
    lap("7d")
    update = check_update_kernels(torch, fu, gen, dev)
    lap("9")
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
    lap("10-11")
    # 8b. a trace of one replayed BERT step, after every host-clock window
    torch.cuda.empty_cache()
    run_trace_child("bert")
    lap("8b")
    # 11b. the tensor surface: a Paddle user's 345M step, the surface on the card
    surface = tensor_surface(torch, pt, fa, fu, dev)
    lap("11b")
    sf = surface["flash"]
    # 12. paddle.nn and ResNet-50: the O2 step, the Momentum kernel at its
    # width, the encoder on the flash kernels, a traced replay
    nn12 = nn_and_resnet50(torch, pt, fa, fu, dev)
    lap("12")
    enc = nn12["encoder"]["launches"]
    # 13. eager lazy dispatch and whole-step capture
    p13 = eager_dispatch(torch, pt, fa, fu, dev)
    lap("13")
    l13 = p13["launches"]
    # 14. frozen parameters, O1 casts, linalg and autograd.functional, the
    # serve-probe CLI
    p14 = slice16(torch, pt, fa, fu, dev, p13["345m"])
    lap("14")
    l14 = p14["launches"]
    # 15. the PS tables and config 5's ERNIE CTR loop, the PS host rows, the
    # multi-process DataLoader
    p15 = slice17(torch, pt, fa, dev, ps_built)
    lap("15")
    # 16. the profiler and the ops plane: the telemetry variants, the 345M
    # f32 step with telemetry, serving under the diagnostics server and the
    # sentinel, the Profiler over the O2 step and obs_probe in processes of
    # their own
    p16 = slice18(torch, pt, fa, fu, dev, card)
    lap("16")
    # 17. static analysis and the memory plan: the lint and the certificates,
    # the remat plan of the O2 step, offload of the Adam moments, a
    # planner-sized KV pool, the two CLIs
    p17 = slice19(torch, pt, fa, fu, dev, card)
    lap("17")
    l17 = p17["remat"]["launches"]
    # 18. multi-GPU, part one: the collectives, fleet's hybrid GPT step and
    # ZeRO, ranks as processes of their own on the one card
    torch.cuda.empty_cache()
    p18 = slice20(torch, pt, fa, dev, card, train)
    lap("18")
    l18 = p18["launches"]

    # 19. per-kernel numbers, then the result
    fwd16, fwd32 = fwd[(FWD_MAIN_SHAPE, "bfloat16")], fwd[(FWD_MAIN_SHAPE, "float32")]
    fwd16_train = fwd[(BWD_MAIN_SHAPE, "bfloat16")]
    bwd16 = bwd["bfloat16"]
    print(f"[19] side by side, bf16, ms: forward at {FWD_MAIN_SHAPE} sm90 {fwd16['ms']:.4f} "
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
    print(f"    the tensor surface (11b): the Paddle-style 345M f32 step "
          f"{surface['step_ms']['surface']:.2f} ms against {surface['step_ms']['torch']:.2f} ms "
          f"with torch inputs; host us per call, surface against bare torch: "
          + ", ".join(f"{k} {v['surface']:.2f} vs {v['torch']:.2f}"
                      for k, v in surface["host_us"].items())
          + "; before any profiler session (5a): "
          + ", ".join(f"{k} {v['surface']:.2f} vs {v['torch']:.2f}"
                      for k, v in early_host_us.items()))
    print(f"    launches per path: the recompute step (7b-i, 2 eager steps and the capture) "
          f"{recompute['launches']}; the O1 loop (7b-ii, both runs) {o1['launches']}, Adam "
          f"{o1['adam']}")
    bk16, bk32 = bert["kernels"]["bfloat16"], bert["kernels"]["float32"]
    print(f"    BERT-base at {BERT_SHAPE} non-causal, projection-major qkv views: bf16 forward "
          f"sm90 {bk16['fwd']['ms']:.4f} SDPA {bk16['fwd']['library_ms']:.4f} (bound "
          f"{bk16['fwd']['bound_ms']:.4f}); dK/dV sm90 {bk16['dkv']['ms']:.4f} (bound "
          f"{bk16['dkv']['bound_ms']:.4f}), dQ sm90 {bk16['dq']['ms']:.4f} (bound "
          f"{bk16['dq']['bound_ms']:.4f}), the pair {bk16['pair_ms']:.4f} against SDPA's "
          f"backward {bk16['dkv']['library_ms']:.4f}; f32 forward tf32x3 "
          f"{bk32['fwd']['ms']:.4f} SDPA {bk32['fwd']['library_ms']:.4f} (bound "
          f"{bk32['fwd']['bound_ms']:.4f}); dK/dV tf32x3 {bk32['dkv']['ms']:.4f}, dQ "
          f"{bk32['dq']['ms']:.4f}, the pair {bk32['pair_ms']:.4f} against SDPA's "
          f"{bk32['dkv']['library_ms']:.4f}")
    pk16, pk32 = p18["kernels"]["bfloat16"], p18["kernels"]["float32"]
    print(f"    a rank's attention in phase 18 at {P18_SHAPE} causal, fused-qkv views: bf16 "
          f"forward sm90 {pk16['fwd']['ms']:.4f} SDPA {pk16['fwd']['library_ms']:.4f} (bound "
          f"{pk16['fwd']['bound_ms']:.4f}); dK/dV sm90 {pk16['dkv']['ms']:.4f} (bound "
          f"{pk16['dkv']['bound_ms']:.4f}), dQ sm90 {pk16['dq']['ms']:.4f} (bound "
          f"{pk16['dq']['bound_ms']:.4f}), the pair {pk16['pair_ms']:.4f} against SDPA's "
          f"backward {pk16['dkv']['library_ms']:.4f}; f32 forward tf32x3 "
          f"{pk32['fwd']['ms']:.4f} SDPA {pk32['fwd']['library_ms']:.4f} (bound "
          f"{pk32['fwd']['bound_ms']:.4f}); dK/dV tf32x3 {pk32['dkv']['ms']:.4f} (bound "
          f"{pk32['dkv']['bound_ms']:.4f}), dQ {pk32['dq']['ms']:.4f} (bound "
          f"{pk32['dq']['bound_ms']:.4f}), the pair {pk32['pair_ms']:.4f} against SDPA's "
          f"{pk32['dkv']['library_ms']:.4f}")
    print(f"    BERT-base steps, ms per replay: AdamW bf16 {bert['adamw']['step_ms']:.3f} "
          f"({bert['adamw']['tokens_per_s']:.1f} tokens/s), Lamb (f32 after its first update) "
          f"{bert['lamb']['step_ms']:.3f}, masked with dropout 0.1 (dense attention, f32 after "
          f"the first layer) {bert['masked']['step_ms']:.3f}; f32 eval forward "
          f"{bert['eval']['fwd_ms']:.3f}")
    o2, f32r = nn12["o2"], nn12["f32"]
    print(f"    ResNet-50 (12a, O2 bf16, {RESNET_BATCH} x 224^2): {o2['step_ms']:.3f} ms per "
          f"replay, resnet50_amp_o2_imgs_per_sec_per_chip {o2['imgs_per_s']:.1f}, peak "
          f"{o2['peak_gb']:.2f} GB; f32 eager (12b, {RESNET_F32_BATCH} images): opt.step() "
          f"{f32r['opt_ms']:.3f} ms with the Momentum kernel, {f32r['opt_ms_rule']:.3f} with "
          f"the rule, the step {f32r['step_ms']:.3f} / {f32r['step_ms_rule']:.3f} ms; the "
          f"encoder step (12c) {nn12['encoder']['step_ms']:.3f} ms per replay")
    lenet = p13["lenet"]
    print("    eager dispatch (13a), mnist_lenet_eager_steps_per_sec per-op / lazy / captured: "
          + "; ".join(f"fused update {'on' if f else 'off'} "
                      + " / ".join(f"{lenet[f][r]['steps_per_s']:.1f}" for r in REGIMES)
                      for f in (False, True))
          + f"; the 345M captured step (13b) {p13['345m']['step_ms']['captured']:.2f} ms "
          f"against {p13['345m']['step_ms']['per_op']:.2f} per-op; the PTB LM (13c) "
          + " / ".join(f"{p13['ptb'][r]['ms']:.3f}" for r in REGIMES) + " ms a step")
    f14, o14, la14 = p14["frozen"], p14["o1"], p14["linalg"]["rows"]
    print(f"    the half-frozen 345M fine-tune (14a): captured "
          f"{f14['step_ms']['captured']:.2f} ms, per-op {f14['step_ms']['per_op']:.2f} ms a step, peak {f14['peak_gb']:.2f} GB; the O1 "
          f"product (14b) {o14['o1_ms']:.3f} ms against {o14['f32_ms']:.3f} in f32; paddle.linalg "
          f"at {LINALG_N} (14c), ms: " + ", ".join(f"{k} {r['ms']:.2f}" for k, r in la14.items()))
    k15, loop15, host15 = p15["kernels"], p15["loop"], p15["host"]
    print(f"    config 5 (15a-15d): tf32x3 at {ERNIE_SHAPE} forward {k15['fwd']['ms']:.4f} ms "
          f"(SDPA {k15['fwd']['library_ms']:.4f}), dK/dV {k15['dkv']['ms']:.4f}, dQ "
          f"{k15['dq']['ms']:.4f}, the pair {k15['pair_ms']:.4f} (SDPA's backward "
          f"{k15['dkv']['library_ms']:.4f}); ernie_ctr_sparse_ps_tokens_per_sec_per_chip "
          f"{loop15['tokens_per_s']:.1f} (sync {loop15['sync_tokens_per_s']:.1f}); "
          f"ps_sparse_pull_push_m_lookups_per_sec {host15['table_m_lookups_per_s']:.2f}, "
          f"ps_wire_pull_push_m_lookups_per_sec {host15['wire_m_lookups_per_s']:.2f}, "
          f"dataloader_mp_imgs_per_sec {p15['loader']['imgs_per_s']:.1f} on {host15['cpu']}")
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
            + recompute["launches"]["fwd_sm90"] + o1["launches"]["fwd_sm90"]
            + enc["fwd_sm90"] + l17["fwd_sm90"] + l18["fwd_sm90"], fwd16),
        row("flash_attention_fwd_tf32", "flash_attention_fwd_tf32.cu", 69,
            inference["fwd_tf32x3"] + f32_train["fwd_tf32x3"] + sf["fwd_tf32x3"]
            + enc["fwd_tf32x3"] + l13["fwd_tf32x3"] + l14["fwd_tf32x3"] + l18["fwd_tf32x3"],
            fwd32),
        # the SIMT kernel at the main f32 shape, on the tf32x3 case's inputs
        row("flash_attention_fwd_simt", "flash_attention_fwd.cu", 69, simt_path["fwd_simt"],
            dict(fwd32, ms=fwd32["simt_ms"], max_abs_err=fwd32["simt_max_abs_err"])),
        row("flash_attention_bwd_dkv", "flash_attention_bwd_dkv_sm90.cu", 151,
            train["launches"]["dkv_sm90"] + resume["dkv_sm90"] + recompute["launches"]["dkv_sm90"]
            + o1["launches"]["dkv_sm90"] + enc["dkv_sm90"] + l17["dkv_sm90"] + l18["dkv_sm90"],
            bwd["bfloat16"]["dkv"]),
        row("flash_attention_bwd_dkv_tf32", "flash_attention_bwd_tf32.cu", 151,
            f32_train["dkv_tf32x3"] + sf["dkv_tf32x3"] + l13["dkv_tf32x3"] + l14["dkv_tf32x3"]
            + l18["dkv_tf32x3"],
            bwd32["dkv"]),
        row("flash_attention_bwd_dkv_simt", "flash_attention_bwd.cu", 151,
            simt_path["dkv_simt"], bwd32["dkv_simt"]),
        row("flash_attention_bwd_dq", "flash_attention_bwd_dq_sm90.cu", 197,
            train["launches"]["dq_sm90"] + resume["dq_sm90"] + recompute["launches"]["dq_sm90"]
            + o1["launches"]["dq_sm90"] + enc["dq_sm90"] + l17["dq_sm90"] + l18["dq_sm90"],
            bwd["bfloat16"]["dq"]),
        row("flash_attention_bwd_dq_tf32", "flash_attention_bwd_tf32.cu", 197,
            f32_train["dq_tf32x3"] + sf["dq_tf32x3"] + l13["dq_tf32x3"] + l14["dq_tf32x3"]
            + l18["dq_tf32x3"],
            bwd32["dq"]),
        row("flash_attention_bwd_dq_simt", "flash_attention_bwd.cu", 197,
            simt_path["dq_simt"], bwd32["dq_simt"]),
    ]
    # the non-causal kernels at BERT's shape, launched on the BERT path: bf16
    # (the bf16 steps) on sm90, f32 (Lamb's later steps, the eval forward, the
    # six optimizers' steps) on tf32x3
    bl = bert["launches"]
    for dname, route, suffix in (("bfloat16", "sm90", ""), ("float32", "tf32x3", "_tf32")):
        k = bert["kernels"][dname]
        source = {"sm90": ("flash_attention_fwd_sm90.cu", "flash_attention_bwd_dkv_sm90.cu",
                           "flash_attention_bwd_dq_sm90.cu"),
                  "tf32x3": ("flash_attention_fwd_tf32.cu", "flash_attention_bwd_tf32.cu",
                             "flash_attention_bwd_tf32.cu")}[route]
        rows += [
            row(f"flash_attention_fwd{suffix}_noncausal_bert", source[0], 69,
                bl[f"fwd_{route}"], k["fwd"]),
            row(f"flash_attention_bwd_dkv{suffix}_noncausal_bert", source[1], 151,
                bl[f"dkv_{route}"], k["dkv"]),
            row(f"flash_attention_bwd_dq{suffix}_noncausal_bert", source[2], 197,
                bl[f"dq_{route}"], k["dq"]),
        ]
    # the tf32x3 kernels at config 5's shape (head dim 32), launched on 15b's path
    l15 = loop15["launches"]
    rows += [
        row("flash_attention_fwd_tf32_ernie_ctr", "flash_attention_fwd_tf32.cu", 69,
            l15["fwd_tf32x3"], k15["fwd"]),
        row("flash_attention_bwd_dkv_tf32_ernie_ctr", "flash_attention_bwd_tf32.cu", 151,
            l15["dkv_tf32x3"], k15["dkv"]),
        row("flash_attention_bwd_dq_tf32_ernie_ctr", "flash_attention_bwd_tf32.cu", 197,
            l15["dq_tf32x3"], k15["dq"]),
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
            "launches": launches_f32[kind] + (o1["adam"] + surface["adam"] if kind == "adam"
                                              else 0)
            + (f32r["launches"] if kind == "momentum" else 0) + l13[kind] + l14[kind],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    k16, f16, o16, pr16 = p16["kernels"], p16["f32"], p16["o2"], p16["probe"]
    print(f"    the ops plane (16a-16e): telemetry variants at {EMBED_NUMEL} elements, ms: "
          + ", ".join(f"{k} {v['ms']:.4f} (kernel {v['kernel_ms']:.4f})" for k, v in k16.items())
          + f"; the 345M f32 captured step with telemetry {f16['step_ms']['on']:.2f} ms, without "
          f"{f16['step_ms']['off']:.2f} ms; the O2 replay with a closed Profiler "
          f"{o16['replay_ms']['closed']:.3f} ms, without {o16['replay_ms']['none']:.3f} ms, "
          f"RecordEvent {o16['span_us']:.3f} us a span; decode with 10 Hz scrapes "
          f"{p16['serving']['decode_gap_ms']:+.4f} ms; obs_probe overheads (% of the O2 step / of "
          f"LeNet's): " + ", ".join(f"{k} {g:.4f} / {l:.4f}" for k, (g, l, _) in pr16.items()))
    for kind, line in (("adam", 145), ("momentum", 127), ("sgd", 116)):
        t = k16[kind]
        rows.append({
            "name": f"fused_update_{kind}_telemetry",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_update.cu",
            "replaces": f"paddle_tpu/ops/pallas/fused_update.py:{line}",
            "launches": f16["launches_adam_telemetry"] if kind == "adam" else t["launches"],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        check(rows[-1]["launches"] > 0, f"the {kind} telemetry variant was launched no time "
                                        f"on its path")
    r17, o17, d17 = p17["remat"], p17["offload"], p17["pool"]
    print(f"    static analysis and the memory plan (17a-17e): the remat plan of the O2 step "
          f"{r17['plan']['peak_before_mb'] / 1024:.3f} -> {r17['plan']['peak_after_mb'] / 1024:.3f} "
          f"GB (planner), {r17['plan']['recompute_pct']}% recompute; measured capture peaks "
          f"unplanned / planned / uniform " + " / ".join(
              f"{r17['peaks_gb'][k]:.3f}" for k in ("unplanned", "planned", "uniform"))
          + " GB; ms per replay " + " / ".join(f"{r17['ms'][k]:.3f}" for k in
                                                ("unplanned", "planned", "uniform"))
          + f"; offload step ms (without / with) per-op {o17['per_op']['step_ms_off']:.2f} / "
          f"{o17['per_op']['step_ms_on']:.2f}, captured {o17['captured']['step_ms_off']:.2f} / "
          f"{o17['captured']['step_ms_on']:.2f}; the planner's pool overhead "
          f"{d17['ratio']:.3f}x the measured one")
    print(f"[19] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s after the CUDA "
          f"check")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
