"""The structural equivalence prover over recorded programs: the port of
``paddle_tpu/analysis/equivalence.py`` (``canonicalize`` :320,
``prove_equivalent`` :411, ``certify_callables`` :454, ``program_diff``
:465, the ``equivalence`` pass :519).

Every execution tier carries a bitwise parity contract (per-op, lazy
3-program, captured 1-program, planned against unplanned). The prover turns
it into an artifact: canonical value numbering over two recorded
``analysis.Program``s. Values there are storages; each write of a storage
(a fresh output, or an in-place update) is a new VERSION, keyed by the op
that wrote it (its aten name, its non-tensor arguments, the keys of what it
read); a read of a version keys on the version and on the geometry it was
read at (shape, strides, offset, dtype) when that differs from the one it
was written with. Keys never mention storage addresses or value ids, so
renaming is free, and a declared allowlist of bitwise-safe rewrites folds
into them:

  - commutative operand order: ``add`` (alpha 1), ``mul``, ``maximum``,
    ``minimum``, ``eq``, ``ne``, the logical ops sort their two operands;
  - elided views and copies: ``detach``, ``alias``, every view op (the
    geometry of the read carries what a view changes), ``clone``,
    ``contiguous``, a same-dtype ``_to_copy``, and a ``copy_`` over the
    whole of its destination (the JAX prover's ``stop_gradient`` / ``copy``
    elision; the last makes a moment brought back from the host the value
    it was parked with);
  - folded constants: a Python scalar argument, a 0-d tensor made from one
    (``scalar_tensor``, ``full``, a lifted literal) and constant arithmetic
    over them key as the value;
  - recompute duplicates: a replayed forward (a recompute segment's, or
    the 3-program composition's) reads the same versions with the same
    arguments, so it hashes to the same keys as the original (hash
    consing).

Kernel entries (``analysis.kernel_region``) compare by kernel name and
shapes, over the keys of what they read. Random ops key on the generator
state they drew from. The outputs compared are, by default, the final
version of every input the program wrote in place (by label: parameters,
optimizer states) and of every value still held when it ended; a caller
may name them (``outputs=``: tensors, read at the end of each recording).
Where two programs disagree, a synchronized backward walk from the first
mismatched output gives a structured first-divergence ``Diagnostic``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import Context, Diagnostic, Op, Program, Severity, recording, register_pass

__all__ = [
    "CanonicalProgram",
    "EquivalenceCertificate",
    "canonicalize",
    "certify_callables",
    "program_diff",
    "prove_equivalent",
]

_COMMUTATIVE = {"add", "mul", "maximum", "minimum", "eq", "ne", "logical_and",
                "logical_or", "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor"}
_IDENTITY = {"detach", "alias", "clone", "contiguous", "lift_fresh"}
_CONST = {"scalar_tensor", "full", "lift_fresh_copy"}
_FOLD = {"add": lambda a, b, al=1: a + al * b, "sub": lambda a, b, al=1: a - al * b,
         "mul": lambda a, b: a * b, "div": lambda a, b: a / b if b else None}


def _h(text: str) -> str:
    return hashlib.sha1(text.encode()).hexdigest()[:20]


class CanonicalProgram:
    """One side of a proof: a recorded program with the canonical key of
    every version of every value, its output keys, and which op wrote each
    key (for the divergence walk)."""

    def __init__(self, program: Program, outputs: Optional[Sequence] = None,
                 labels: Optional[Dict[int, str]] = None):
        self.program = program
        self.ops = program.ops
        self.rewrites: Counter = Counter()
        self.writer: Dict[str, Tuple[Op, int]] = {}  # key -> (op, output position)
        self.input_keys: Dict[int, str] = {}
        self.op_ins: Dict[int, List[str]] = {}  # op index -> the keys it read
        labels = dict(labels or {})
        ver: Dict[int, str] = {}   # vid -> its current version's key
        geom: Dict[int, tuple] = {}  # vid -> the geometry that version was written at
        first = [0]

        def read(vid, g):
            if vid not in ver:  # a program input
                label = labels.get(vid)
                if label is None:
                    role = program.roles.get(vid)
                    label = f"{role[0]}:{role[1]}" if role else f"#{first[0]}"
                    first[0] += 1
                # a label "sc:<v>" names an input by its constant value (a
                # captured step's learning-rate scalar)
                ver[vid] = self.input_keys[vid] = (label if label.startswith("sc:")
                                                   else f"in:{label}")
                geom[vid] = g
            k = ver[vid]
            return k if geom.get(vid) == g else f"{k}@{g}"

        for op in self.ops:
            n_in = len(op.tin)
            gs = [(tuple(op.shapes[i]), op.geoms[i] if i < len(op.geoms) else None,
                   str(op.dtypes[i])) for i in range(len(op.shapes))]
            in_vids = self._vids(op, "in")
            ins = [read(v, gs[i]) if v is not None else "none" for i, v in enumerate(in_vids)]
            self.op_ins[op.index] = ins
            if op.view:
                self.rewrites["view_elisions"] += 1
                continue
            out_vids = self._vids(op, "out")
            name = op.name
            if name == "copy_" and n_in == 2 and in_vids[0] is not None \
                    and _covers(gs[0], program.values[in_vids[0]].nbytes) \
                    and gs[1][0] == gs[0][0] and gs[1][2] == gs[0][2]:
                # a copy over the whole of its destination, of its shape and
                # dtype (across devices too): the destination holds the source
                self.rewrites["copy_elisions"] += 1
                ver[in_vids[0]], geom[in_vids[0]] = ins[1], gs[0]
                continue
            if name in _IDENTITY or (name == "_to_copy" and len(gs) > n_in and gs[0][2]
                                     == gs[n_in][2]):
                if n_in and out_vids and out_vids[0] is not None:
                    self.rewrites["identity_elisions"] += 1
                    ver[out_vids[0]], geom[out_vids[0]] = ins[0], gs[n_in]
                    continue
            key = self._const_key(op, ins)
            if key is not None:
                self.rewrites["literal_folds"] += 1
                base = key
            else:
                base = f"{name}:" + _h(f"{name}|{self._args_key(op, ins)}")
            for j, v in enumerate(out_vids):
                if v is None:
                    continue
                k = base if key is not None else (f"{base}:{j}" if v not in in_vids
                                                  else f"{base}:w{j}")
                ver[v], geom[v] = k, gs[n_in + j]
                self.writer.setdefault(k, (op, j))
        self.final = ver
        if outputs is not None:
            vids = [program.value_of(t) if not isinstance(t, int) else t for t in outputs]
        else:
            written = sorted((v.vid for v in program.values.values() if v.written),
                             key=lambda vid: self.input_keys.get(vid, ""))
            held = sorted((v for v in program.escaping if program.values[v].producer >= 0),
                          key=lambda v: ver.get(v, ""))
            vids = written + held  # the held values as a multiset: sorted by key
        self.out_vids = vids
        self.out_keys = [ver.get(v, "missing") if v is not None else "missing" for v in vids]

    def _vids(self, op: Op, side: str) -> List[Optional[int]]:
        """The value id of each tensor of ``op`` (input or output side): ops
        list only the tensors that have storage, in order."""
        tensors = op.tin if side == "in" else op.tout
        vids = list(op.inputs if side == "in" else op.outputs)
        if len(vids) == len(tensors):
            return vids
        return vids + [None] * (len(tensors) - len(vids))

    def _const_key(self, op: Op, ins) -> Optional[str]:
        if op.name in _CONST:
            v = op.kw("value") if op.name == "lift_fresh_copy" else op.arg(
                0 if op.name == "scalar_tensor" else 1)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return f"sc:{float(v)!r}"
            return None
        fold = _FOLD.get(op.name)
        if fold is not None and len(op.pos) >= 2:
            vals = []
            for slot in op.pos[:2]:
                k = ins[int(slot[1:])] if isinstance(slot, str) and slot.startswith("$") \
                    and slot[1:].isdigit() else _scalar(slot)
                if not (isinstance(k, str) and k.startswith("sc:")):
                    return None
                vals.append(float(k[3:]))
            try:
                alpha = op.kw("alpha", 1)
                r = fold(*vals, alpha) if op.name in ("add", "sub") else fold(*vals)
            except Exception:
                return None
            return None if r is None else f"sc:{float(r)!r}"
        return None

    def _args_key(self, op: Op, ins) -> str:
        def sub(x):
            if isinstance(x, str) and x.startswith("$") and x[1:].isdigit():
                return ins[int(x[1:])]
            if isinstance(x, tuple):
                return "(" + ",".join(sub(v) for v in x) + ")"
            return _scalar(x)

        pos = [sub(x) for x in op.pos]
        if op.name in _COMMUTATIVE and len(pos) >= 2 and op.kw("alpha", 1) == 1:
            pos[:2] = sorted(pos[:2])
        kws = [f"{k}={sub(v)}" for k, v in (op.args[1] if op.args else ())]
        parts = pos + kws
        if op.kernel:
            parts += [f"shapes={[tuple(s) for s in op.shapes]}"] + ins
        if op.rng is not None:
            parts.append(f"rng={op.rng}")
        return "|".join(parts)

    def describe(self, key: str) -> str:
        if key.startswith("in:"):
            return f"input {key[3:].split('@')[0]}"
        if key.startswith("sc:"):
            return f"constant {key[3:]}"
        w = self.writer.get(key.split("@")[0])
        return w[0].path if w is not None else key


def _covers(g, nbytes) -> bool:
    """Whether a read at geometry ``g`` (shape, (strides, offset), dtype) is
    the whole of a contiguous storage of ``nbytes``."""
    shape, (strides, offset), dtype = g
    n, expect = 1, []
    for d in reversed(shape):
        expect.append(n)
        n *= d
    itemsize = {"torch.float64": 8, "torch.int64": 8, "torch.float32": 4, "torch.int32": 4,
                "torch.float16": 2, "torch.bfloat16": 2, "torch.int16": 2}.get(dtype, 1)
    dense = all(s == e for s, e, d in zip(strides, reversed(expect), shape) if d > 1)
    return offset == 0 and dense and n * itemsize == nbytes


def _scalar(x) -> str:
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return repr(x)
    if isinstance(x, (int, float)):
        return f"sc:{float(x)!r}"
    return repr(x)


@dataclasses.dataclass
class EquivalenceCertificate:
    """Outcome of one structural equivalence proof."""

    equivalent: bool
    reason: str
    label_a: str = "A"
    label_b: str = "B"
    n_ops: Tuple[int, int] = (0, 0)
    outputs_compared: int = 0
    rewrites: Dict[str, int] = dataclasses.field(default_factory=dict)
    divergence: Optional[Diagnostic] = None

    def summary(self) -> str:
        state = "EQUIVALENT" if self.equivalent else "DIVERGENT"
        rw = ", ".join(f"{k}={v}" for k, v in sorted(self.rewrites.items()))
        return (f"equivalence[{self.label_a} ≡ {self.label_b}]: {state} — "
                f"{self.reason} ({self.n_ops[0]}/{self.n_ops[1]} ops, "
                f"{self.outputs_compared} outputs" + (f"; rewrites: {rw}" if rw else "") + ")")

    def to_dict(self) -> Dict[str, Any]:
        return {"equivalent": self.equivalent, "reason": self.reason,
                "labels": [self.label_a, self.label_b], "n_ops": list(self.n_ops),
                "outputs_compared": self.outputs_compared, "rewrites": dict(self.rewrites),
                "divergence": None if self.divergence is None else str(self.divergence)}


def canonicalize(program: Program, outputs=None, labels=None) -> CanonicalProgram:
    """Canonical value numbering of a recorded program: one side of a proof."""
    return CanonicalProgram(program, outputs=outputs, labels=labels)


def _first_divergence(A: CanonicalProgram, B: CanonicalProgram, out_idx: int,
                      source: str) -> Diagnostic:
    stack = [(A.out_keys[out_idx], B.out_keys[out_idx])]
    seen = set()
    for _ in range(20000):
        if not stack:
            break
        ka, kb = stack.pop()
        if ka == kb or (ka, kb) in seen:
            continue
        seen.add((ka, kb))
        wa, wb = A.writer.get(ka.split("@")[0]), B.writer.get(kb.split("@")[0])
        if wa is None or wb is None or "@" in ka or "@" in kb:
            return Diagnostic(
                Severity.ERROR, "equivalence", f"{A.describe(ka)} vs {B.describe(kb)}",
                f"programs diverge at output {out_idx}: {A.describe(ka)} ≠ {B.describe(kb)}",
                hint="the two tiers do not compute the same value here", source=source,
                data={"output_index": out_idx, "a": A.describe(ka), "b": B.describe(kb)})
        (opa, _), (opb, _) = wa, wb
        shapes = (tuple(opa.out_shapes[0]) if opa.out_shapes else (),
                  tuple(opb.out_shapes[0]) if opb.out_shapes else ())
        dtypes = (str(opa.out_dtypes[0]) if opa.out_dtypes else "",
                  str(opb.out_dtypes[0]) if opb.out_dtypes else "")
        ia, ib = _input_keys(A, opa), _input_keys(B, opb)
        same_args = _shape_of_args(opa) == _shape_of_args(opb)
        if opa.name != opb.name or not same_args:
            why = "op kinds differ" if opa.name != opb.name else "op arguments differ"
            return Diagnostic(
                Severity.ERROR, "equivalence", f"{opa.path} vs {opb.path}",
                f"first divergence (output {out_idx}): {why} — {opa.name} vs {opb.name}",
                hint="inspect the two op paths; this is the first point where the programs "
                     "stop being isomorphic",
                shapes=shapes, dtypes=dtypes, source=source,
                data={"output_index": out_idx, "a_path": opa.path, "b_path": opb.path,
                      "a_op": opa.name, "b_op": opb.name})
        if opa.name in _COMMUTATIVE and len(ia) == 2:
            ia, ib = sorted(ia), sorted(ib)
        for x, y in zip(ia, ib):
            if x != y:
                stack.append((x, y))
                break
        else:
            return Diagnostic(
                Severity.ERROR, "equivalence", f"{opa.path} vs {opb.path}",
                f"first divergence (output {out_idx}): same op, same inputs, different "
                "output position or scalar argument",
                shapes=shapes, dtypes=dtypes, source=source,
                data={"output_index": out_idx, "a_path": opa.path, "b_path": opb.path})
    return Diagnostic(Severity.ERROR, "equivalence", f"output[{out_idx}]",
                      f"programs diverge at output {out_idx} (divergence deeper than the "
                      "walk budget)", source=source, data={"output_index": out_idx})


def _shape_of_args(op: Op):
    def strip(x):
        if isinstance(x, str) and x.startswith("$"):
            return "$"
        if isinstance(x, tuple):
            return tuple(strip(v) for v in x)
        return x

    return strip(op.pos), tuple((k, strip(v)) for k, v in (op.args[1] if op.args else ()))


def _input_keys(C: CanonicalProgram, op: Op) -> List[str]:
    """The keys ``op`` read."""
    return C.op_ins.get(op.index, [])


def prove_equivalent(a, b, *, extra_outputs_a: int = 0, extra_outputs_b: int = 0,
                     label_a: str = "A", label_b: str = "B", source: str = "equivalence",
                     outputs_a=None, outputs_b=None, labels_a=None,
                     labels_b=None) -> EquivalenceCertificate:
    """Certify two recorded programs structurally equivalent.
    ``extra_outputs_a``/``extra_outputs_b`` declare how many TRAILING outputs
    each side carries beyond the common contract (they are left out);
    ``outputs_*`` name the outputs (tensors or value ids) and ``labels_*``
    name inputs ({value id: label}) where positions would not match. The
    certificate's ``divergence`` is the structured first-divergence
    diagnostic when the proof fails."""
    A = a if isinstance(a, CanonicalProgram) else canonicalize(a, outputs_a, labels_a)
    B = b if isinstance(b, CanonicalProgram) else canonicalize(b, outputs_b, labels_b)
    n_ops = (len(A.ops), len(B.ops))
    rewrites = dict(Counter(A.rewrites) + Counter(B.rewrites))
    ka = A.out_keys[:len(A.out_keys) - int(extra_outputs_a)]
    kb = B.out_keys[:len(B.out_keys) - int(extra_outputs_b)]
    if len(ka) != len(kb):
        d = Diagnostic(
            Severity.ERROR, "equivalence", "outputs",
            f"output arity mismatch: {label_a} has {len(ka)} outputs, {label_b} has "
            f"{len(kb)} (beyond the declared extras)",
            hint="declare extra outputs (telemetry/sentinel) explicitly", source=source,
            data={"n_outputs": [len(ka), len(kb)],
                  "declared_extras": [extra_outputs_a, extra_outputs_b]})
        return EquivalenceCertificate(False, "output arity mismatch", label_a, label_b, n_ops,
                                      min(len(ka), len(kb)), rewrites, d)
    for i, (x, y) in enumerate(zip(ka, kb)):
        if x != y:
            return EquivalenceCertificate(
                False, f"outputs diverge starting at index {i}", label_a, label_b, n_ops,
                len(ka), rewrites, _first_divergence(A, B, i, source))
    return EquivalenceCertificate(True, "all outputs canonically identical", label_a,
                                  label_b, n_ops, len(ka), rewrites)


def _record_fn(fn, args, source):
    from . import _tensors

    with recording(source) as r:
        out = fn(*args)
    return r.program, _tensors(out, [])


def certify_callables(fn_a, fn_b, arg_specs, **kw) -> EquivalenceCertificate:
    """Run two callables once each on the same inputs under a recording and
    prove them equivalent. ``arg_specs`` are tensors (used as they are) or
    ``(shape, dtype)`` pairs (zeros); each side's outputs are what it
    returns."""
    import torch

    args = [a if isinstance(a, torch.Tensor) else torch.zeros(a[0], dtype=a[1])
            for a in arg_specs]
    pa, oa = _record_fn(fn_a, args, kw.get("label_a", "A"))
    pb, ob = _record_fn(fn_b, args, kw.get("label_b", "B"))
    labels = {}
    for prog in (pa, pb):
        for i, t in enumerate(args):
            vid = prog.value_of(t)
            if vid is not None:
                labels.setdefault(id(prog), {})[vid] = f"arg{i}"
    return prove_equivalent(pa, pb, outputs_a=oa, outputs_b=ob,
                            labels_a=labels.get(id(pa)), labels_b=labels.get(id(pb)), **kw)


def program_diff(a, b, label_a: str = "A", label_b: str = "B", extra_outputs_a: int = 0,
                 extra_outputs_b: int = 0) -> Tuple[EquivalenceCertificate, List[str]]:
    """(certificate, printable diff lines) between two recorded programs:
    the op-histogram delta and the first divergence when the proof fails.
    (The collective schedule of the JAX diff waits for item 13c.)"""
    A, B = canonicalize(a), canonicalize(b)
    cert = prove_equivalent(A, B, label_a=label_a, label_b=label_b,
                            extra_outputs_a=extra_outputs_a,
                            extra_outputs_b=extra_outputs_b, source="graph_lint --diff")
    lines = [cert.summary()]
    ha = Counter(op.name for op in A.ops)
    hb = Counter(op.name for op in B.ops)
    delta = {n: (ha.get(n, 0), hb.get(n, 0)) for n in sorted(set(ha) | set(hb))
             if ha.get(n, 0) != hb.get(n, 0)}
    if delta:
        lines.append(f"op histogram deltas ({label_a} vs {label_b}):")
        lines += [f"  {n}: {x} vs {y}" for n, (x, y) in delta.items()]
    else:
        lines.append("op histograms identical")
    lines.append("no collectives on either side")
    if cert.divergence is not None:
        lines.append(str(cert.divergence))
    return cert, lines


@register_pass("equivalence")
def _equivalence_pass(ctx: Context) -> List[Diagnostic]:
    """Silent unless a reference program is attached (``ctx.reference``)."""
    ref = getattr(ctx, "reference", None)
    if ref is None or ctx.program is None:
        return []
    try:
        cert = prove_equivalent(ctx.program, ref, label_a=ctx.source or "program",
                                label_b="reference", source=ctx.source)
    except Exception as e:  # unprovable is not divergent: report, do not crash
        return [Diagnostic(Severity.WARNING, "equivalence", "program",
                           f"equivalence unprovable: {type(e).__name__}: {e}",
                           source=ctx.source)]
    return [] if cert.equivalent else [cert.divergence]
