"""Lint a model file with the port's analysis passes: the port of the JAX
package's ``tools/graph_lint.py``.

    python -m paddle_tpu_torch.tools.graph_lint paddle_tpu_torch/examples/lint_models.py
    python -m paddle_tpu_torch.tools.graph_lint FILE --builder build_resnet --json
    python -m paddle_tpu_torch.tools.graph_lint FILE --memory-budget-mb 64 --plan
    python -m paddle_tpu_torch.tools.graph_lint FILE --diff OTHER_FILE

The model file exposes a builder (default ``build_model``) that takes
``device`` and returns ``(layer_or_fn, input_specs)``, or a layer or
callable that ``--input-spec`` completes (``1,3,64,64:float32``). The
subject is run once on zero inputs under a recording
(``analysis.check``); a layer's forward runs under ``no_grad``. ``--plan``
records a synthetic training step of a layer and prints the remat plan
that fits ``--memory-budget-mb`` (``analysis.plan.plan_program``);
``--diff`` proves the two files' programs equivalent or prints the first
divergence (``analysis.equivalence.program_diff``). It runs on the card
unless ``--device cpu``. Exit status 1 when a diagnostic at or above
``--fail-on`` (default: error) is found, or a diff is not proven; else 0.
``--mesh`` (the per-shard analyzer) waits for ROADMAP queue 1 item 13.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys


def _load_module(path: str):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"_graph_lint_{name}", path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"graph_lint: cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _parse_spec(text: str):
    shape_s, _, dtype = text.partition(":")
    shape = [None if d in ("None", "-1") else int(d) for d in shape_s.split(",") if d]
    return tuple(shape), (dtype or "float32")


def _build(path, name, device, specs_override):
    builder = getattr(_load_module(path), name, None)
    if builder is None:
        raise SystemExit(f"graph_lint: {path} has no {name}(): expose a builder returning "
                         "(model, input_specs)")
    try:
        takes_device = "device" in inspect.signature(builder).parameters
    except (TypeError, ValueError):
        takes_device = False
    built = builder(device=device) if takes_device else builder()
    target, specs = built if isinstance(built, tuple) and len(built) == 2 else (built, None)
    if specs_override:
        specs = [_parse_spec(s) for s in specs_override]
    return target, specs


def _record(d) -> dict:
    return {"severity": str(d.severity), "pass": d.pass_name, "op": d.op,
            "message": d.message, "hint": d.hint, "source": d.source,
            "shapes": [list(map(int, s)) for s in d.shapes if s is not None],
            "dtypes": [str(t) for t in d.dtypes], "data": d.data}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="graph_lint", description=__doc__.splitlines()[0])
    ap.add_argument("model_file", help="python file exposing the builder")
    ap.add_argument("--builder", default="build_model",
                    help="builder callable name (default: build_model)")
    ap.add_argument("--input-spec", nargs="*", default=None, metavar="SHAPE:DTYPE",
                    help="input specs like 1,3,64,64:float32 (override the builder's)")
    ap.add_argument("--passes", default=None, help="comma-separated pass subset")
    ap.add_argument("--memory-budget-mb", type=float, default=None, metavar="MB",
                    help="the memory_budget pass reports the estimated peak against this "
                         "budget and errors above it")
    ap.add_argument("--plan", action="store_true",
                    help="with --memory-budget-mb: print the remat plan of a training step "
                         "of the layer")
    ap.add_argument("--diff", default=None, metavar="MODEL_FILE_B",
                    help="prove this file's program equivalent to the one of MODEL_FILE_B")
    ap.add_argument("--builder-b", default=None, metavar="NAME",
                    help="builder name in the --diff file (default: --builder)")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help="the per-shard analyzer (ROADMAP queue 1 item 13)")
    ap.add_argument("--device", default=None,
                    help="where the subject runs: the card unless 'cpu'")
    ap.add_argument("--fail-on", default="error", choices=["info", "warning", "error"],
                    help="exit nonzero at or above this severity (default: error)")
    ap.add_argument("--json", action="store_true", help="diagnostics as JSON lines")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit("graph_lint: --mesh, the per-shard analyzer, is not ported yet "
                         "(ROADMAP, open items, queue 1 item 13)")

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.core.flags import describe_flags

    if args.device:
        pt.set_device(args.device)
    from paddle_tpu_torch.core.place import torch_device

    device = torch_device()
    target, specs = _build(args.model_file, args.builder, device, args.input_spec)

    if args.diff:
        from paddle_tpu_torch.analysis.equivalence import program_diff

        target_b, specs_b = _build(args.diff, args.builder_b or args.builder, device,
                                   args.input_spec)
        cert, lines = program_diff(analysis.record(target, specs),
                                   analysis.record(target_b, specs_b),
                                   label_a=os.path.basename(args.model_file),
                                   label_b=os.path.basename(args.diff))
        if args.json:
            print(json.dumps({"severity": "info" if cert.equivalent else "error",
                              "pass": "equivalence", "op": None, "message": cert.summary(),
                              "hint": None, "source": "graph_lint --diff", "shapes": [],
                              "dtypes": [], "data": {"certificate": cert.to_dict(),
                                                     "diff": lines}}))
        else:
            print("\n".join(lines))
        return 0 if cert.equivalent else 1

    passes = args.passes.split(",") if args.passes else None
    diags = analysis.check(target, specs, passes=passes, memory_budget_mb=args.memory_budget_mb)
    plan = None
    if args.plan:
        if args.memory_budget_mb is None:
            raise SystemExit("graph_lint: --plan requires --memory-budget-mb")
        from paddle_tpu_torch.analysis import plan as plan_mod

        try:
            plan = plan_mod.plan_program(target, specs, memory_budget_mb=args.memory_budget_mb)
        except Exception as e:  # noqa: BLE001 — a planner failure is a finding
            plan_mod.record_failure("graph_lint", e)
            print(f"graph_lint: plan failed: {type(e).__name__}: {e}", file=sys.stderr)

    if args.json:
        for d in diags:
            print(json.dumps(_record(d)))
        if plan is not None:
            print(json.dumps({"severity": "info", "pass": "memory_plan", "op": None,
                              "message": plan.summary(), "hint": None, "source": None,
                              "shapes": [], "dtypes": [], "data": plan.to_dict()}))
    else:
        if not diags:
            print(f"graph_lint: {args.model_file}: clean ({len(analysis.pass_names())} passes)")
        for d in diags:
            print(f"  {d}")
        if plan is not None:
            print(plan.summary())
        active = (describe_flags("check") + describe_flags("memory_budget")
                  + describe_flags("memory_plan"))
        flags_str = ", ".join(f"{f['name']}={f['value']}" for f in active)
        counts = {}
        for d in diags:
            counts[str(d.severity)] = counts.get(str(d.severity), 0) + 1
        summary = ", ".join(f"{v} {k}" for k, v in sorted(counts.items())) or "0 findings"
        print(f"graph_lint: {summary} on {device}  [{flags_str}]")
    threshold = {"info": analysis.Severity.INFO, "warning": analysis.Severity.WARNING,
                 "error": analysis.Severity.ERROR}[args.fail_on]
    return 1 if any(d.severity >= threshold for d in diags) else 0


if __name__ == "__main__":
    sys.exit(main())
