#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from ``paddle_tpu_torch/csrc`` with nvcc;
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at ragged and non-causal ones, and time kernel,
     plain version and the PyTorch library call;
  4. the full-sequence forward of GPT-2 345M (random weights from a seed) at
     4 x 1024 tokens through the flash kernel, against the dense path, in f32,
     then once in bf16;
  5. serve a few requests: greedy ``generate()`` on 4 prompts, cross-checked
     token by token against the kernel-path forward;
  6. one JSON line of per-kernel numbers, then the result line.

It needs CUDA and the repository around it; without either it exits non-zero
and prints no result. It imports nothing of JAX or of ``paddle_tpu``.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, bf16/f16 on
# the tensor cores, and HBM3 bandwidth. Bounds below are stated against these.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of tests/test_flash_attention.py for the kernel against its plain
# version, on O and on lse.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}

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


def time_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms, each run between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def attention_bound_ms(b, s, h, d, dtype_name, causal):
    """Least time for the flash forward: max(operations / peak, bytes / HBM rate).

    Operations: 4·D per attended (query, key) pair (Q·Kᵀ and P·V, 2 FLOP per
    FMA); causal attends S(S+1)/2 pairs per head. Bytes: q, k, v read once, o
    written once, lse (f32) written once."""
    elem = 4 if dtype_name == "float32" else 2
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * d * pairs * b * h
    nbytes = 4 * b * s * h * d * elem + b * h * s * 4
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt2_345m
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

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
    logs = _build.build([fa.KERNEL_NAME])
    print(f"[2] built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():  # ptxas -v: each instantiation, its registers and spills
            if any(w in line for w in ("Function properties", "registers", "spill")):
                print(f"  {name}: {line.strip()}")

    # 3. each kernel against its plain version
    print("[3] flash_attention_fwd vs plain")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    main_shape = (4, 1024, 16, 64)
    cases = [  # (shape, causal, dtype, layout)
        (main_shape, True, torch.float32, "fused"),
        (main_shape, True, torch.bfloat16, "fused"),
        ((1, 600, 2, 24), True, torch.float32, "fused"),
        ((1, 128, 2, 32), False, torch.float32, "contiguous"),
    ]
    timings = {}
    max_err_main = 0.0
    for shape, causal, dtype, layout in cases:
        b, s, h, d = shape
        dname = str(dtype).replace("torch.", "")
        if layout == "fused":  # q, k, v as strided views of one [b, s, h, 3, d] qkv, as GPT makes them
            qkv = torch.randn((b, s, h, 3, d), generator=gen, device=dev).to(dtype)
            q, k, v = qkv.unbind(dim=3)
        else:
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
        scale = d ** -0.5
        o_k, lse_k = fa.flash_attention_fwd(q, k, v, scale, causal)
        o_p, lse_p = fa.fwd_plain(q, k, v, scale, causal)
        torch.cuda.synchronize()
        err_o = (o_k.float() - o_p.float()).abs().max().item()
        err_lse = (lse_k - lse_p).abs().max().item()
        ok = err_o <= TOL[dname] and err_lse <= TOL[dname]
        print(f"  {shape} causal={causal} {dname} {layout}: max|dO|={err_o:.3e} "
              f"max|dlse|={err_lse:.3e} tol={TOL[dname]:g} {'ok' if ok else 'FAIL'}")
        check(ok, f"kernel disagrees with its plain version at {shape} {dname}")
        check(bool(torch.isfinite(o_k).all()), f"non-finite kernel output at {shape}")
        if shape == main_shape:
            if dtype == torch.float32:
                max_err_main = max(err_o, err_lse)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kernel_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale, causal))
            plain_ms = time_ms(lambda: fa.fwd_plain(q, k, v, scale, causal))
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale))
            bound_ms, bound_by = attention_bound_ms(b, s, h, d, dname, causal)
            timings[dname] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
            print(f"  {shape} {dname}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms:.4f} (torch SDPA) bound_ms={bound_ms:.4f} "
                  f"({bound_by}); kernel at {bound_ms / kernel_ms:.1%} of bound")
    del q, k, v, o_k, o_p, lse_k, lse_p

    # 4. full-sequence forward of GPT-2 345M through the kernel
    print("[4] GPT-2 345M forward, 4 x 1024 tokens")
    pt.seed(SEED)
    cfg = gpt2_345m()
    model = GPTForPretraining(cfg, device="gpu:0").eval()
    n_params = sum(p.numel() for p in model.parameters())
    batch, seq = 4, cfg.max_seq_len
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
    fa.flash_attention_fwd.launches = 0  # the main path's count starts here
    with torch.no_grad():
        logits = model(ids)
        torch.cuda.synchronize()
        per_forward = fa.flash_attention_fwd.launches
        print(f"  params={n_params} layers={cfg.num_layers}; flash launches in one "
              f"forward: {per_forward}")
        check(per_forward == cfg.num_layers,
              f"expected {cfg.num_layers} kernel launches per forward, got {per_forward}")
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
        logits16 = model_bf16(ids)
        torch.cuda.synchronize()
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
    launches = fa.flash_attention_fwd.launches  # the main path's count ends here

    # 6. per-kernel numbers, then the result
    f32 = timings["float32"]
    print(f"bf16 at {main_shape}: " + json.dumps(timings["bfloat16"]))
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:69",
        "launches": launches,
        "max_abs_err": max_err_main,
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
