"""The lint passes over the recorded aten IR: the port of
``paddle_tpu/analysis/passes.py`` (``dtype_check`` :77, ``dead_code``
:204, ``redundant_ops`` :275, ``numeric_hazards`` :492, ``launch_budget``
:572, ``determinism`` :728).

The JAX passes walk a jaxpr's producer chains; these walk the chains of
the tensors a recorded run read and wrote (``Op.tin``/``Op.tout``), with
the ops' recorded non-tensor arguments (a scale, a dim list, a dtype, a
clamp floor). A scalar is a Python number among an op's arguments, or a
0-d tensor made from one (``scalar_tensor``, ``full``, a lifted literal),
chased through views and casts. Severities are the JAX package's:

  ERROR   wrong numbers or a failure on the device (float64 upcast,
          unguarded log);
  WARNING probably a bug or a real cost (dead op, redundant pair, fp16
          long-axis sum, possible division by zero, an order-dependent
          float scatter);
  INFO    worth knowing (a transpose pair that fuses, a bf16 long sum).

The collective and rank-variant halves of ``determinism`` wait for item 13
(multi-GPU): a one-card program has no collective.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import Context, Diagnostic, Op, Severity, register_pass

_LOW = {"torch.float16", "torch.bfloat16"}
_NARROW = _LOW | {"torch.float32"}
_FLOATS = _NARROW | {"torch.float64"}

# ops that keep the value they read (views, casts, copies)
_PLUMBING = {"view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
             "squeeze", "unsqueeze", "slice", "select", "_to_copy", "clone", "detach",
             "alias", "contiguous", "lift_fresh", "lift_fresh_copy", "as_strided",
             "_reshape_alias", "copy", "to"}
_HEAVY = {"mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
          "cudnn_convolution", "convolution_overrideable"}


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class _Chains:
    """Producer lookups at the time each op ran: which op wrote the tensor
    an op read (views and in-place writes included)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        cur: Dict[int, Op] = {}
        self.at: Dict[int, List[Optional[Op]]] = {}
        for op in ctx.ops:
            self.at[op.index] = [cur.get(t) for t in op.tin]
            for t in op.tout:
                cur[t] = op
        self.inputs = set(ctx.program.inputs) if ctx.program is not None else set()

    def producer(self, op: Op, i: int) -> Optional[Op]:
        ps = self.at.get(op.index, ())
        return ps[i] if i < len(ps) else None

    def slot(self, op: Op, slot) -> Optional[int]:
        """The tensor index ``i`` of a ``"$i"`` argument, or None."""
        if isinstance(slot, str) and slot.startswith("$") and slot[1:].isdigit():
            return int(slot[1:])
        return None

    def const(self, op: Op, slot, depth=8):
        """The Python scalar behind argument ``slot`` of ``op`` (a number, or
        a tensor made from one), or None."""
        if _is_num(slot):
            return slot
        i = self.slot(op, slot)
        if i is None or depth <= 0:
            return None
        if i < len(op.in_shapes) and int(np.prod(op.in_shapes[i] or (1,))) != 1:
            return None
        p = self.producer(op, i)
        if p is None:
            return None
        if p.name in ("lift_fresh", "lift_fresh_copy") and p.kw("value") is not None:
            return p.kw("value")
        if p.name in ("scalar_tensor", "full", "full_like"):
            return p.arg(1 if p.name != "scalar_tensor" else 0)
        if p.name in ("ones", "ones_like"):
            return 1.0
        if p.name in ("zeros", "zeros_like"):
            return 0.0
        if p.name in _PLUMBING and p.tin:
            return self.const(p, "$0", depth - 1)
        return None

    def chase(self, op: Op, i: int, names, depth=12):
        """Follow tensor ``i`` of ``op`` back through plumbing; the first
        producer whose name is in ``names``, else None."""
        cur, idx = op, i
        for _ in range(depth):
            p = self.producer(cur, idx)
            if p is None:
                return None
            if p.name in names:
                return p
            if p.name not in _PLUMBING or not p.tin:
                return None
            cur, idx = p, 0
        return None

    def root(self, op: Op, i: int, depth=12):
        """(op, index) of the tensor behind ``op``'s input ``i`` after the
        plumbing: the tensor id at the root of the chain."""
        cur, idx = op, i
        for _ in range(depth):
            p = self.producer(cur, idx)
            if p is None or p.name not in _PLUMBING or not p.tin:
                return cur.tin[idx] if idx < len(cur.tin) else None, p
            cur, idx = p, 0
        return cur.tin[idx] if idx < len(cur.tin) else None, None


def _float(dt) -> bool:
    return str(dt) in _FLOATS


# ---------------------------------------------------------------------------
# 1. dtype verifier
# ---------------------------------------------------------------------------
@register_pass("dtype_check")
def dtype_check(ctx: Context) -> List[Diagnostic]:
    diags = []
    # a silent float64 upcast: a narrower float becomes a float64 value
    for op in ctx.ops:
        if op.view or not any(str(d) in _NARROW for d in op.in_dtypes):
            continue
        for shape, dt in zip(op.out_shapes, op.out_dtypes):
            if str(dt) == "torch.float64":
                diags.append(Diagnostic(
                    Severity.ERROR, "dtype_check", op.path,
                    f"silent float64 upcast: {op.in_dtypes[0]} input becomes float64",
                    hint="cast to float32/bfloat16: check numpy float64 scalars and arrays "
                         "entering the program and torch.set_default_dtype",
                    shapes=(tuple(shape),), dtypes=("float64",)))
                break
    # matmuls and convolutions split across float widths in one program
    widths: Dict[str, Op] = {}
    for op in ctx.ops:
        if op.name in _HEAVY:
            for dt in op.out_dtypes:
                if _float(dt):
                    widths.setdefault(str(dt), op)
    low = [d for d in widths if d in _LOW]
    if low and "torch.float32" in widths:
        diags.append(Diagnostic(
            Severity.WARNING, "dtype_check", widths["torch.float32"].path,
            f"mixed-precision compute: both {low[0].split('.')[-1]} and float32 "
            "matmul/conv ops in one program",
            hint="run the model under paddle.amp.auto_cast (O1/O2) or cast weights and "
                 "inputs consistently; stray f32 matmuls forfeit most of the AMP speedup",
            dtypes=(low[0].split(".")[-1], "float32")))
    # a float feed whose every use first casts it to another float width
    program = ctx.program
    if program is not None:
        consumers: Dict[int, List[Op]] = {}
        for op in ctx.ops:
            if op.view:
                continue
            for vid in set(op.inputs):
                consumers.setdefault(vid, []).append(op)
        for vid, (kind, name) in program.roles.items():
            if kind != "feed":
                continue
            dt = "torch." + program.values[vid].dtype.split(".")[-1]
            uses = consumers.get(vid, [])
            if not _float(dt) or not uses:
                continue
            casts = {str(op.kw("dtype")) for op in uses if op.name == "_to_copy"}
            if len(casts) == 1 and all(op.name == "_to_copy" for op in uses):
                (target,) = casts
                if target != dt and target in _FLOATS:
                    diags.append(Diagnostic(
                        Severity.WARNING, "dtype_check", f"feed:{name}",
                        f"feed '{name}' declared {dt.split('.')[-1]} but every use first "
                        f"casts it to {target.split('.')[-1]}",
                        hint=f"declare the feed as {target.split('.')[-1]} (or drop the "
                             "casts) to avoid a per-step convert",
                        dtypes=(dt.split(".")[-1], target.split(".")[-1])))
    return diags


# ---------------------------------------------------------------------------
# 2. dead code, unused feeds and parameters
# ---------------------------------------------------------------------------
@register_pass("dead_code")
def dead_code(ctx: Context) -> List[Diagnostic]:
    program = ctx.program
    if program is None:
        return []
    # liveness from what outlives the run: the escaping values (outputs a
    # caller keeps, tensors autograd saved) and the inputs written in place
    live = set(program.escaping) | {v.vid for v in program.values.values() if v.written}
    dead = []
    for op in reversed(ctx.ops):
        writes = set(op.outputs)
        if not writes or writes & live:  # an op with no tensor output is a side effect
            live.update(op.inputs)
        elif not op.view and not writes & set(op.inputs):
            dead.append(op)  # a fresh result nothing reads
    diags = []
    for op in reversed(dead):
        diags.append(Diagnostic(
            Severity.WARNING, "dead_code", op.path,
            "dead op: results are never used",
            hint="remove the computation (it still runs on every step)",
            shapes=tuple(tuple(s) for s in op.out_shapes)))
    for kind, name, shape in program.unused:
        if kind == "feed":
            diags.append(Diagnostic(
                Severity.WARNING, "dead_code", f"feed:{name}",
                f"unused feed '{name}': declared but never consumed",
                hint="drop the input or wire it into the program", shapes=(shape,)))
        elif kind == "param":
            diags.append(Diagnostic(
                Severity.WARNING, "dead_code", f"param:{name}",
                f"unused parameter '{name}': it will train as dead weight",
                hint="delete the parameter or stop passing it to the optimizer",
                shapes=(shape,)))
        elif kind == "buffer":
            diags.append(Diagnostic(
                Severity.INFO, "dead_code", f"buffer:{name}", f"unused buffer '{name}'",
                shapes=(shape,)))
    return diags


# ---------------------------------------------------------------------------
# 3. redundant-op patterns
# ---------------------------------------------------------------------------
_TRANSPOSES = {"permute", "transpose", "t", "numpy_T"}


def _perm(op: Op) -> Optional[tuple]:
    nd = len(op.in_shapes[0]) if op.in_shapes else 0
    if op.name == "permute":
        dims = op.arg(1, "dims")
        return tuple(int(d) % max(nd, 1) for d in dims) if dims is not None else None
    if op.name == "t" or op.name == "numpy_T":
        return tuple(reversed(range(nd)))
    if op.name == "transpose":
        d0, d1 = int(op.arg(1)) % nd, int(op.arg(2)) % nd
        p = list(range(nd))
        p[d0], p[d1] = p[d1], p[d0]
        return tuple(p)
    return None


def _reduce_dims(op: Op, nd: int):
    dims = op.arg(1, "dim")
    if dims is None or dims == ():
        return set(range(nd))
    if isinstance(dims, int):
        dims = (dims,)
    return {int(d) % nd for d in dims}


def _from_rng(chains: _Chains, op: Op, i: int, depth=12) -> bool:
    """The value comes from a random op (the arithmetic of a sampler, not
    user code)."""
    stack = [(op, i)]
    seen = 0
    while stack and seen < depth:
        cur, idx = stack.pop()
        seen += 1
        p = chains.producer(cur, idx)
        if p is None:
            continue
        if p.rng is not None:
            return True
        stack.extend((p, j) for j in range(len(p.tin)))
    return False


@register_pass("redundant_ops")
def redundant_ops(ctx: Context) -> List[Diagnostic]:
    if ctx.program is None:
        return []
    chains = _Chains(ctx)
    diags = []
    for op in ctx.ops:
        if op.name in _TRANSPOSES and op.tin:
            p = chains.producer(op, 0)
            if p is not None and p.name in _TRANSPOSES:
                p1, p2 = _perm(p), _perm(op)
                if p1 is None or p2 is None or len(p1) != len(p2):
                    continue
                perm = tuple(p1[i] for i in p2)
                if perm == tuple(range(len(perm))):
                    diags.append(Diagnostic(
                        Severity.WARNING, "redundant_ops", op.path,
                        "transpose∘transpose cancels out to identity",
                        hint="remove both transposes", shapes=(tuple(op.in_shapes[0]),)))
                else:
                    diags.append(Diagnostic(
                        Severity.INFO, "redundant_ops", op.path, "back-to-back transposes",
                        hint=f"fuse into one transpose with perm={list(perm)}"))
        elif op.name in ("mul", "add", "sub", "div") and len(op.pos) >= 2:
            if op.name in ("add", "sub") and op.kw("alpha", 1) != 1:
                continue
            checks = {"mul": ((0, 1.0), (1, 1.0)), "add": ((0, 0.0), (1, 0.0)),
                      "sub": ((1, 0.0),), "div": ((1, 1.0),)}[op.name]
            for idx, ident in checks:
                v = chains.const(op, op.pos[idx])
                if not _is_num(v) or float(v) != ident:
                    continue
                other = op.pos[1 - idx]
                if chains.const(op, other) is not None:
                    break  # constant arithmetic
                j = chains.slot(op, other)
                if j is not None and _from_rng(chains, op, j):
                    break
                expr = {"mul": "x*1", "add": "x+0", "sub": "x-0", "div": "x/1"}[op.name]
                diags.append(Diagnostic(
                    Severity.WARNING, "redundant_ops", op.path,
                    f"identity arithmetic: {expr} is a no-op",
                    hint="drop the op (likely a stale scale or bias, or a disabled branch "
                         "left in the program)",
                    shapes=(tuple(op.out_shapes[0]),) if op.out_shapes else ()))
                break
        elif op.name in ("sum", "amax", "amin", "prod", "max", "min", "mean") and op.tin \
                and len(op.pos) >= 2:
            p = chains.producer(op, 0)
            if p is None or p.name != "expand" or not p.in_shapes:
                continue
            out_shape = tuple(p.out_shapes[0])
            in_shape = (1,) * (len(out_shape) - len(p.in_shapes[0])) + tuple(p.in_shapes[0])
            expanded = {d for d in range(len(out_shape)) if in_shape[d] != out_shape[d]}
            hit = expanded & _reduce_dims(op, len(out_shape))
            if hit:
                factor = int(np.prod([out_shape[d] for d in hit]))
                diags.append(Diagnostic(
                    Severity.WARNING, "redundant_ops", op.path,
                    f"broadcast-then-reduce: materializes and reduces {factor}× redundant "
                    "data",
                    hint="reduce before broadcasting, or express the contraction as "
                         "matmul/einsum",
                    shapes=(tuple(p.in_shapes[0]), out_shape)))
        elif op.name == "log" and op.tin:
            p = chains.chase(op, 0, {"_softmax", "softmax", "div"})
            hit = p is not None and (p.name in ("_softmax", "softmax") or (
                p.name == "div" and chains.chase(p, 0, {"exp"}) is not None))
            if hit:
                diags.append(Diagnostic(
                    Severity.WARNING, "redundant_ops", op.path,
                    "log(softmax(x)) computed as two ops",
                    hint="use F.log_softmax: one fused op, and it cannot underflow to "
                         "log(0) = -inf"))
    return diags


# ---------------------------------------------------------------------------
# 4. numerical hazards
# ---------------------------------------------------------------------------
# ops that keep the sign or positivity being chased
_SIGN_PLUMBING = _PLUMBING | {"sum", "mean", "amin", "min", "cat", "sqrt", "rsqrt"}
_POSITIVE = {"exp", "sigmoid", "softplus"}
_NONNEG = {"abs", "relu", "square"} | _POSITIVE


def _guarded(chains: _Chains, op: Op, i: int, nonneg_ok=False, depth=8) -> bool:
    """Best-effort proof that input ``i`` of ``op`` is positive (or >= 0
    when ``nonneg_ok``): a positive constant, a clamp or max with a positive
    floor, ``+ eps``, exp or sigmoid, |x|, x², an even power."""
    stack = [(op, i)]
    seen = 0
    while stack and seen < depth:
        cur, idx = stack.pop()
        seen += 1
        c = chains.const(cur, f"${idx}")
        if c is not None:
            if _is_num(c) and (c > 0 or (nonneg_ok and c >= 0)):
                return True
            continue
        p = chains.producer(cur, idx)
        if p is None:
            continue
        if p.name in _POSITIVE:
            return True
        if nonneg_ok and p.name in _NONNEG:
            return True
        if p.name in ("clamp", "clamp_min", "clip"):
            lo = chains.const(p, p.arg(1, "min"))
            if _is_num(lo) and (lo > 0 or (nonneg_ok and lo >= 0)):
                return True
        elif p.name == "maximum":
            for j in range(len(p.pos)):
                c = chains.const(p, p.pos[j])
                if _is_num(c) and (c > 0 or (nonneg_ok and c >= 0)):
                    return True
            stack.extend((p, j) for j in range(len(p.tin)))
        elif p.name == "add" and p.kw("alpha", 1) == 1:
            for slot in p.pos[:2]:
                c = chains.const(p, slot)
                if _is_num(c) and c > 0:
                    return True
        elif p.name == "pow" and nonneg_ok:
            e = chains.const(p, p.arg(1))
            if _is_num(e) and float(e) % 2 == 0:
                return True
        elif p.name == "mul" and nonneg_ok and len(p.tin) == 2 and p.tin[0] == p.tin[1]:
            return True
        elif p.name == "where" and len(p.tin) >= 1:
            # where(x == 0, c, x) with c > 0: the zero case is replaced
            cond = chains.producer(p, 0)
            if cond is not None and cond.name == "eq" and chains.const(cond, cond.arg(1)) == 0:
                for a, b in ((1, 2), (2, 1)):
                    c = chains.const(p, p.arg(a))
                    if _is_num(c) and c > 0:
                        return True
        elif p.name in _SIGN_PLUMBING and p.tin:
            stack.append((p, 0))
    return False


@register_pass("numeric_hazards")
def numeric_hazards(ctx: Context) -> List[Diagnostic]:
    if ctx.program is None:
        return []
    chains = _Chains(ctx)
    program = ctx.program
    diags = []
    for op in ctx.ops:
        if op.name == "log" and op.tin:
            if not _guarded(chains, op, 0):
                diags.append(Diagnostic(
                    Severity.ERROR, "numeric_hazards", op.path,
                    "unguarded log: operand can reach 0 or go negative (NaN/-inf)",
                    hint="clip first (paddle.log(paddle.clip(x, min=eps))), or use "
                         "paddle.log1p / F.log_softmax",
                    shapes=(tuple(op.in_shapes[0]),), dtypes=(str(op.in_dtypes[0]),)))
        elif op.name == "div" and len(op.pos) > 1:
            den = op.pos[1]
            c = chains.const(op, den)
            if c is not None:
                continue
            j = chains.slot(op, den)
            if j is not None and not _guarded(chains, op, j):
                diags.append(Diagnostic(
                    Severity.WARNING, "numeric_hazards", op.path,
                    "possible division by zero: denominator has no positivity guard",
                    hint="add an epsilon (x / (d + eps)) or clip the denominator",
                    shapes=(tuple(op.in_shapes[j]),)))
        elif op.name in ("sqrt", "rsqrt") and op.tin:
            if not _guarded(chains, op, 0, nonneg_ok=(op.name == "sqrt")):
                diags.append(Diagnostic(
                    Severity.WARNING, "numeric_hazards", op.path,
                    f"unguarded {op.name}: negative input gives NaN"
                    + ("" if op.name == "sqrt" else ", zero gives inf"),
                    hint=f"add an epsilon under the root ({op.name}(x + eps)) or clip to "
                         "≥ 0",
                    shapes=(tuple(op.in_shapes[0]),)))
        elif op.name == "exp" and op.tin:
            vid = op.inputs[0] if op.inputs else None
            p = chains.producer(op, 0)
            if p is None and vid is not None and vid in program.values \
                    and program.values[vid].producer < 0 \
                    and ctx.role_of(vid)[0] in ("feed", "arg"):
                diags.append(Diagnostic(
                    Severity.WARNING, "numeric_hazards", op.path,
                    "exp applied directly to a raw input: overflows to inf beyond ~88 "
                    "(f32) / ~11 (f16)",
                    hint="normalize first (subtract the max, as softmax does) or clip the "
                         "input range",
                    shapes=(tuple(op.in_shapes[0]),)))
        elif op.name in ("sum", "prod", "cumsum") and op.tin and op.out_dtypes:
            dt = str(op.out_dtypes[0])
            if dt not in _LOW or str(op.in_dtypes[0]) not in _LOW:
                continue
            shape = tuple(op.in_shapes[0])
            nd = max(len(shape), 1)
            if op.name == "cumsum":
                dims = {int(op.arg(1, "dim", 0)) % nd}
            else:
                dims = _reduce_dims(op, nd) if len(op.pos) >= 2 else set(range(len(shape)))
            n = int(np.prod([shape[d] for d in dims])) if shape else 1
            if n > 2048:
                half = dt == "torch.float16"
                name = dt.split(".")[-1]
                diags.append(Diagnostic(
                    Severity.WARNING if half else Severity.INFO, "numeric_hazards", op.path,
                    f"{name} reduction over {n} elements: "
                    + ("float16 saturates at 65504" if half else
                       "bfloat16 has an 8-bit mantissa")
                    + ", long-axis accumulation loses precision",
                    hint="accumulate in float32: x.astype('float32').sum(...).astype(x.dtype)",
                    shapes=(shape,), dtypes=(name,)))
    return diags


# ---------------------------------------------------------------------------
# 5. program/launch budget over the dispatch counters
# ---------------------------------------------------------------------------
@register_pass("launch_budget")
def launch_budget(ctx: Context) -> List[Diagnostic]:
    if not ctx.counters:
        return []  # only meaningful when a counter snapshot is provided
    c = ctx.counters
    # a captured steady-state step is ONE program (one CUDA graph), and each
    # accumulate-only microstep of a k-step cycle one more: the auto budget
    # is one program per replay in the measured window
    replays = int(c.get("capture_replays", 0))
    accum_replays = int(c.get("capture_accum_replays", 0))
    captured = replays > 0 or accum_replays > 0
    budget = ctx.budget if ctx.budget is not None else (
        (replays + accum_replays) if captured else 3)
    diags = []
    programs = int(c.get("programs", 0))
    if programs > budget:
        parts = ", ".join(
            f"{k.removesuffix('_programs')}={c[k]}"
            for k in ("op_programs", "segment_programs", "backward_programs",
                      "optimizer_programs", "captured_programs") if c.get(k))
        what = ("one captured program per update step / accumulate microstep" if captured
                else "one segment + one backward + one optimizer update")
        diags.append(Diagnostic(
            Severity.WARNING, "launch_budget", "step",
            f"step launched {programs} device programs (budget {budget}: {what}); "
            f"breakdown: {parts}",
            hint="enable FLAGS_eager_lazy_dispatch and FLAGS_eager_step_capture, keep "
                 "data-dependent ops out of the hot loop, and check flush_reasons in "
                 "paddle.profiler.dispatch_counters()"))
    if captured and programs <= budget:
        what_ran = ("each microstep of the accumulation cycle replayed as one captured "
                    "program (update step in place)" if accum_replays else
                    "the step replayed as 1 program (one CUDA graph on the card) with "
                    "parameters and optimizer state written in place")
        diags.append(Diagnostic(
            Severity.INFO, "launch_budget", "step",
            f"whole-step capture active: {what_ran} (capture_replays={replays}"
            + (f", capture_accum_replays={accum_replays}" if accum_replays else "") + ")"))
    fallbacks = int(c.get("capture_fallbacks", 0))
    if fallbacks > 0:
        reasons = c.get("capture_fallback_reasons") or {}
        parts = ", ".join(f"{k}={v}" for k, v in sorted(dict(reasons).items()))
        diags.append(Diagnostic(
            Severity.WARNING, "launch_budget", "step",
            f"step fell back out of whole-step capture {fallbacks} time(s)"
            + (f" ({parts})" if parts else ""),
            hint="a steady-state step keeps capture only when its signature is stable: "
                 "avoid per-step shape/scalar changes, tensor hooks, "
                 "retain_graph/create_graph, custom grad-clip subclasses, irregular "
                 "accumulation cycles, and reads of .grad or pending tensors between "
                 "backward() and optimizer.step()"))
    if int(c.get("segment_cache_misses", 0)) > 0:
        diags.append(Diagnostic(
            Severity.INFO, "launch_budget", "step",
            f"steady-state step still built {c['segment_cache_misses']} new segment(s)",
            hint="unstable segment signatures (varying shapes/scalars) defeat the "
                 "segment cache; check flush_reasons"))
    return diags


# ---------------------------------------------------------------------------
# 6. determinism: the static twin of the bitwise guarantees
# ---------------------------------------------------------------------------
# float scatters that COMBINE duplicate-index updates: (name, index argument)
_ACCUM = {"index_add": 2, "index_add_": 2, "scatter_add": 2, "scatter_add_": 2,
          "scatter_reduce": 2, "scatter_reduce_": 2, "index_put": 1, "index_put_": 1,
          "_index_put_impl_": 1, "index_reduce": 2, "index_reduce_": 2}
# ops that read rows by index: a scatter over the same indices is their
# gradient (autograd's transpose of a gather)
_GATHERS = {"index_select", "gather", "embedding", "index", "take", "_embedding_bag"}
# a host read inside the program: its value leaves the device and can come
# back through the host's arithmetic
_HOST_READS = {"_local_scalar_dense"}


def _accumulates(op: Op) -> bool:
    if op.name.startswith("index_put") or op.name == "_index_put_impl_":
        return bool(op.arg(3, "accumulate", False))
    if op.name.startswith("scatter_reduce") or op.name.startswith("index_reduce"):
        return op.arg(4, "reduce") in ("sum", "prod", "mean")
    return True


@register_pass("determinism")
def determinism(ctx: Context) -> List[Diagnostic]:
    if ctx.program is None:
        return []
    chains = _Chains(ctx)
    diags = []
    gather_roots = set()
    for op in ctx.ops:
        if op.name in _GATHERS:
            for i in range(1, len(op.tin)):
                root, _ = chains.root(op, i)
                if root is not None:
                    gather_roots.add(root)
    draws: Dict[tuple, List[Op]] = {}
    for op in ctx.ops:
        if op.name in _ACCUM and op.out_dtypes and _float(op.out_dtypes[0]) \
                and _accumulates(op):
            slot = op.arg(_ACCUM[op.name])
            slots = slot if isinstance(slot, tuple) else (slot,)
            idx = [chains.slot(op, s) for s in slots if chains.slot(op, s) is not None]
            unique = True
            for i in idx:
                root, p = chains.root(op, i)
                if p is not None and p.name == "arange":
                    continue
                if root is not None and root in gather_roots:
                    continue  # the gradient of a gather over the same indices
                unique = False
            if unique:
                continue
            diags.append(Diagnostic(
                Severity.WARNING, "determinism", op.path,
                f"float {op.name} with potentially-duplicate indices: the order duplicate "
                "updates combine in is up to the device (atomics on a GPU), so results "
                "need not be bitwise reproducible",
                hint="index with provably unique indices (torch.arange), accumulate in "
                     "int/f64 and cast, or sort the indices first (segment sums over "
                     "sorted ids); torch.use_deterministic_algorithms makes the order fixed",
                shapes=(tuple(op.out_shapes[0]),), dtypes=(str(op.out_dtypes[0]),)))
        elif op.rng is not None:
            draws.setdefault(op.rng, []).append(op)
        elif op.name in _HOST_READS:
            diags.append(Diagnostic(
                Severity.WARNING, "determinism", op.path,
                "host callback inside the program: a value is read on the host mid-run, "
                "so what follows can depend on host arithmetic and timing, and a CUDA "
                "graph replay does not repeat it",
                hint="keep the computation on the device, or accept that this step is "
                     "unreproducible and exclude it from parity checks"))
    for ops in draws.values():
        first = ops[0]
        for op in ops[1:]:
            diags.append(Diagnostic(
                Severity.WARNING, "determinism", op.path,
                f"generator state reused: the same state feeds {first.path} and {op.path}, "
                "which therefore draw IDENTICAL random streams",
                hint="let the generator advance between draws (no manual_seed or "
                     "set_state in between), or use one generator per consumer; reused "
                     "states silently correlate dropout masks and init draws"))
    return diags


__all__ = ["dtype_check", "dead_code", "redundant_ops", "numeric_hazards", "launch_budget",
           "determinism"]
