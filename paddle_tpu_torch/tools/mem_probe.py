"""Memory-plan probe of the port: the remat plan and host offload acceptance
gates of the JAX package's ``tools/mem_probe.py``, on a small GPT (the
planner's workload: activations dominate) through ``compile_train_step``:

  planned-under-budget   at a budget halfway between the unplanned step's
                         planner peak and the uniform per-block recompute
                         step's, ``plan_remat()`` returns a FEASIBLE plan,
                         the planned step's recorded peak is under the
                         budget, and its predicted recompute is below the
                         uniform plan's
  bitwise-parity         every loss of an N-step planned run is bitwise the
                         unplanned run's
  beats-naive-recompute  the planned step is faster than the model built
                         with ``use_recompute=True`` (best of 3 rounds)
  offload-overhead       host offload of the Adam moments parks them (D2H
                         copies happen), the run is bitwise the unparked
                         one, and the measured prefetch share of the step
                         stays under ``--overhead-budget-pct``

The JAX probe's budget is 60% of the peak; the port's remat unit is a
whole layer call (``analysis.plan``), whose floor is the uniform plan's
peak, hence the midpoint. It runs on the card unless ``--device cpu``.
Exits nonzero on a failed gate and prints ALL SCENARIOS PASSED on success.

    python -m paddle_tpu_torch.tools.mem_probe [--steps 8] [--overhead-budget-pct 1.0]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

BSZ, SEQ = 4, 256
CFG = dict(vocab_size=256, hidden_size=128, num_layers=4, num_heads=4, max_seq_len=SEQ,
           dropout=0.0, attn_dropout=0.0)


def _batches(torch, steps, device, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = torch.tensor(rng.integers(0, CFG["vocab_size"], (BSZ, SEQ + 1)), device=device)
        out.append((ids[:, :-1].contiguous(), ids[:, 1:].contiguous()))
    return out


def _build_step(pt, device, use_recompute=False, memory_plan=None, seed=0):
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTPretrainingCriterion)

    pt.seed(seed)
    cfg = GPTConfig(use_recompute=use_recompute, **CFG)
    model = GPTForPretraining(cfg, device=device)
    opt = pt.optimizer.Adam(learning_rate=1e-4, parameters=model.parameters())
    return pt.jit.compile_train_step(model, GPTPretrainingCriterion(cfg), opt,
                                     memory_plan=memory_plan)


def _time_steps(step, batches, rounds=3):
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for x, y in batches:
            float(step(x, y))  # a host read: the step is done
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mem_probe")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--overhead-budget-pct", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core.place import torch_device
    from paddle_tpu_torch.optimizer import offload

    if args.device:
        pt.set_device(args.device)
    device = torch_device()
    if device.type == "cpu":
        # the CPU's multi-threaded kernels do not repeat a step bit for bit
        # from run to run (the unplanned step against itself differs in the
        # last place): the parity gate needs one thread
        torch.set_num_threads(1)
    print(f"mem_probe on {device}")
    state = {}

    def plan_and_parity():
        batches = _batches(torch, args.steps, device)
        base = _build_step(pt, device)
        base_losses = [float(base(x, y)) for x, y in batches]
        uniform = _build_step(pt, device, use_recompute=True)
        for x, y in batches[:3]:  # on the card the third step's capture is recorded
            float(uniform(x, y))
        peak, peak_u = base.memory_plan().peak_bytes, uniform.memory_plan().peak_bytes
        budget_mb = (peak + peak_u) / 2 / 2**20
        plan = base.plan_remat(budget_mb=budget_mb)
        print(plan.summary())
        print(f"  planner peaks: unplanned {peak / 2**20:.2f} MB, uniform recompute "
              f"{peak_u / 2**20:.2f} MB, budget {budget_mb:.2f} MB")
        assert plan.has_cuts and plan.feasible, plan.summary()
        assert plan.recompute_pct < 100.0 * 0.999, plan.recompute_pct
        planned = _build_step(pt, device, memory_plan=plan)
        losses = [float(planned(x, y)) for x, y in batches]
        assert losses == base_losses, (losses, base_losses)
        recorded = planned.memory_plan().peak_bytes
        assert recorded <= budget_mb * 2**20, (recorded, budget_mb)
        print(f"  bitwise parity over {args.steps} steps: OK (final loss {losses[-1]:.6f}); "
              f"the planned step's recorded peak {recorded / 2**20:.2f} MB")
        state.update(planned=planned, uniform=uniform, batches=batches)

    def throughput():
        planned, uniform, batches = state["planned"], state["uniform"], state["batches"]
        t_p, t_u = _time_steps(planned, batches), _time_steps(uniform, batches)
        print(f"  planned {len(batches) / t_p:.2f} steps/s against uniform recompute "
              f"{len(batches) / t_u:.2f} ({t_u / t_p:.2f}x)")
        assert t_p < t_u, (t_p, t_u)

    def offload_overhead():
        def train(use_offload, steps=10):
            pt.seed(0)
            m = nn.Sequential(nn.Linear(128, 256), nn.GELU(approximate=True),
                              nn.Linear(256, 16)).to(device)
            o = pt.optimizer.Adam(learning_rate=1e-3, parameters=m.parameters())
            if use_offload:
                offload.enable(o, overhead_pct=args.overhead_budget_pct, min_bytes=1024)
            lf = nn.CrossEntropyLoss()
            rng = np.random.default_rng(0)
            losses = []
            for _ in range(steps):
                x = torch.tensor(rng.standard_normal((256, 128)), dtype=torch.float32,
                                 device=device)
                y = torch.tensor(rng.integers(0, 16, (256,)), device=device)
                loss = lf(m(x), y)
                loss.backward()
                o.step()
                o.clear_grad()
                losses.append(float(loss.detach()))
            return m, o, losses

        m0, _o0, base = train(False)
        m1, o1, offl = train(True)
        snap = offload.scheduler_of(o1).snapshot()
        print(f"  offload snapshot: {snap}")
        assert snap["d2h_count"] > 0, "no device-to-host copy happened"
        assert base == offl, "offload changed a loss"
        for a, b in zip(m0.parameters(), m1.parameters()):
            assert torch.equal(a, b)
        assert snap["overhead_pct_ema"] < args.overhead_budget_pct, snap
        offload.disable(o1)

    failed = []
    for name, fn in (("planned-under-budget+bitwise-parity", plan_and_parity),
                     ("beats-naive-recompute", throughput),
                     ("offload-overhead", offload_overhead)):
        print(f"=== {name} ===")
        try:
            if name == "beats-naive-recompute" and "planned" not in state:
                raise RuntimeError("skipped: the planning scenario failed")
            fn()
            print(f"=== {name}: PASSED ===")
        except Exception as e:  # noqa: BLE001 — every scenario reports
            failed.append(name)
            print(f"=== {name}: FAILED: {type(e).__name__}: {e} ===")
    if failed:
        print(f"FAILED SCENARIOS: {', '.join(failed)}")
        return 1
    print("ALL SCENARIOS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
