"""Post-partitioning HLO analysis for the roofline.

The port's copy of the JAX package's ``launch/hlo.py`` (pure Python, ``re``
only), under the same names: it reads the HLO text of a compiled XLA
module.  The port's own dry run (``launch/dryrun.py``) counts the same
quantities on its DTensor trace instead.

``compiled.as_text()`` exposes the optimized module after SPMD
partitioning — the only place the real collective schedule is visible.
XLA's ``cost_analysis()`` on this backend does NOT multiply while-loop
bodies by their trip counts (verified empirically: a 2-layer and a
4-layer scanned model report identical flops), so scanned-layer models
would be undercounted by ~n_layers×.  This module therefore builds its own
call-graph cost model over the HLO text:

  * computations are parsed into blocks; ``fusion`` ops charge their
    called computation's *flops* but only the fusion's operand/output
    bytes (fusion internals live in registers/VMEM — this is the honest
    HBM-traffic proxy for the memory term);
  * ``while`` ops resolve their trip count from the loop condition's
    ``compare(%iv, %constant)`` against the parsed constant literal and
    multiply body+condition costs;
  * ``dot`` flops = 2 · prod(output dims) · prod(lhs contracting dims),
    with operand shapes resolved through the definition table;
  * collective bytes (all-gather / all-reduce / reduce-scatter /
    all-to-all / collective-permute) use the op's per-device output bytes,
    multiplied through loop nests like everything else.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["HloCost", "analyze_hlo", "parse_shape_bytes", "collective_bytes"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "token": 0, "u1": 1,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# standalone ops charged to the HBM-traffic proxy (everything else is
# assumed fused on TPU; fusions charge their operands/outputs explicitly)
_BYTES_OPS = frozenset({
    "copy", "gather", "scatter", "dynamic-slice", "dynamic-update-slice",
    "reduce", "sort", "pad", "concatenate", "rng", "rng-bit-generator",
    "cholesky", "triangular-solve", "fft",
})


def parse_shape_bytes(shape_str: str) -> int:
    """'bf16[16,4096,512]{...}' → bytes; tuples sum their members."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(shape_str: str) -> List[int]:
    m = _SHAPE_RE.search(shape_str)
    if not m:
        return []
    dims = m.group(2)
    return [int(d) for d in dims.split(",") if d] if dims else []


@dataclass
class _Op:
    name: str
    shape: str
    opcode: str
    operands: List[str]
    attrs: str


@dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0                       # HBM-traffic proxy
    collectives: Dict[str, float] = field(default_factory=dict)

    def scaled(self, k: float) -> "HloCost":
        return HloCost(
            self.flops * k,
            self.bytes * k,
            {c: v * k for c, v in self.collectives.items()},
        )

    def add(self, other: "HloCost") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        for c, v in other.collectives.items():
            self.collectives[c] = self.collectives.get(c, 0.0) + v

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())


_DEF_RE = re.compile(
    r"^\s*(ROOT\s+)?%?([\w.\-]+)\s*=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s*"
    r"([\w\-]+)\((.*?)\)(.*)$"
)
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_COMP_HDR = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\((.*?)\)\s*->.*\{\s*$")
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_COND_BODY_RE = re.compile(r"condition=%?([\w.\-]+).*body=%?([\w.\-]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")


def _parse_computations(text: str) -> Tuple[Dict[str, List[_Op]], Dict[str, _Op], Optional[str]]:
    comps: Dict[str, List[_Op]] = {}
    defs: Dict[str, _Op] = {}
    entry: Optional[str] = None
    current: Optional[str] = None
    for raw in text.splitlines():
        line = raw.rstrip()
        hdr = _COMP_HDR.match(line)
        if hdr:
            current = hdr.group(2)
            comps[current] = []
            if hdr.group(1):
                entry = current
            # header params are definitions too (for shape lookups)
            continue
        if line.strip() == "}":
            current = None
            continue
        m = _DEF_RE.match(line)
        if not m or current is None:
            continue
        _, name, shape, opcode, operand_str, attrs = m.groups()
        operands = [
            o.strip().lstrip("%")
            for o in re.findall(r"%[\w.\-]+", operand_str)
        ]
        op = _Op(name, shape, opcode, operands, attrs)
        comps[current].append(op)
        defs[name] = op
    return comps, defs, entry


def _param_shapes(text: str) -> Dict[str, str]:
    """computation parameter name -> shape (from headers)."""
    shapes: Dict[str, str] = {}
    for line in text.splitlines():
        hdr = _COMP_HDR.match(line.rstrip())
        if not hdr:
            continue
        params = hdr.group(3)
        for pm in re.finditer(r"([\w.\-]+):\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)", params):
            shapes[pm.group(1)] = pm.group(2)
    return shapes


def analyze_hlo(text: str) -> HloCost:
    """Full-module cost with loop-trip multiplication, from the ENTRY."""
    comps, defs, entry = _parse_computations(text)
    pshapes = _param_shapes(text)

    def shape_of(name: str) -> str:
        if name in defs:
            return defs[name].shape
        return pshapes.get(name, "")

    def const_value(name: str) -> Optional[int]:
        op = defs.get(name)
        if op is None:
            return None
        if op.opcode == "constant":
            m = _CONST_RE.search(op.shape + op.attrs)
            if m:
                return int(m.group(1))
        m = _CONST_RE.search((op.attrs or ""))
        return int(m.group(1)) if m else None

    def trip_count(cond_comp: str) -> int:
        """Find compare(%iv, %const) in the condition (possibly behind a
        fusion) and return the constant — jax scan/fori loops compare LT."""
        for op in comps.get(cond_comp, []):
            if op.opcode == "fusion":
                m = _CALLS_RE.search(op.attrs)
                inner = m.group(1) if m else None
                # constant may be an operand of the fusion
                for o in op.operands:
                    v = const_value(o)
                    if v is not None:
                        return v
                if inner:
                    t = trip_count(inner)
                    if t != 1:
                        return t
            if op.opcode == "compare":
                for o in op.operands:
                    v = const_value(o)
                    if v is not None:
                        return v
            if op.opcode == "constant":
                v = const_value(op.name)
                if v is not None and v > 1:
                    return v
        return 1

    memo: Dict[str, HloCost] = {}

    def comp_cost(comp: str) -> HloCost:
        if comp in memo:
            return memo[comp]
        total = HloCost()
        memo[comp] = total  # break accidental cycles
        for op in comps.get(comp, []):
            oc = op.opcode
            out_bytes = parse_shape_bytes(op.shape)
            if oc == "fusion":
                m = _CALLS_RE.search(op.attrs)
                if m:
                    inner = comp_cost(m.group(1))
                    total.flops += inner.flops
                    for c, v in inner.collectives.items():
                        total.collectives[c] = total.collectives.get(c, 0.0) + v
                # HBM proxy: fusion operands + output only
                total.bytes += out_bytes + sum(
                    parse_shape_bytes(shape_of(o)) for o in op.operands
                )
                continue
            if oc == "while":
                m = _COND_BODY_RE.search(op.attrs)
                if m:
                    cond, body = m.group(1), m.group(2)
                    tm = _TRIP_RE.search(op.attrs)
                    trips = int(tm.group(1)) if tm else trip_count(cond)
                    total.add(comp_cost(body).scaled(trips))
                    total.add(comp_cost(cond).scaled(trips))
                continue
            if oc in ("call", "conditional", "async-start"):
                for m in _CALLS_RE.finditer(op.attrs):
                    total.add(comp_cost(m.group(1)))
                continue
            is_coll = None
            for c in _COLLECTIVES:
                if oc == c or oc.startswith(c + "-start") or oc.startswith(c + "."):
                    is_coll = c
                    break
            if is_coll:
                total.collectives[is_coll] = (
                    total.collectives.get(is_coll, 0.0) + out_bytes
                )
                total.bytes += out_bytes
                continue
            if oc == "dot":
                out_dims = _shape_dims(op.shape)
                lhs_shape = shape_of(op.operands[0]) if op.operands else ""
                lhs_dims = _shape_dims(lhs_shape)
                m = _CONTRACT_RE.search(op.attrs)
                k = 1
                if m and lhs_dims:
                    for d in m.group(1).split(","):
                        if d and int(d) < len(lhs_dims):
                            k *= lhs_dims[int(d)]
                flops = 2.0 * k
                for d in out_dims:
                    flops *= d
                total.flops += flops
                total.bytes += out_bytes + sum(
                    parse_shape_bytes(shape_of(o)) for o in op.operands
                )
                continue
            if oc == "convolution":
                # rough: 2 * output elems * kernel elems (per output channel)
                out_dims = _shape_dims(op.shape)
                rhs = _shape_dims(shape_of(op.operands[1])) if len(op.operands) > 1 else []
                k = 1
                for d in rhs[:-1]:
                    k *= d
                flops = 2.0 * k
                for d in out_dims:
                    flops *= d
                total.flops += flops
                total.bytes += out_bytes + sum(
                    parse_shape_bytes(shape_of(o)) for o in op.operands
                )
                continue
            if oc in _BYTES_OPS:
                # ops that genuinely move HBM bytes even on TPU
                total.bytes += out_bytes + sum(
                    parse_shape_bytes(shape_of(o)) for o in op.operands
                )
            # every other standalone primitive (elementwise, reshape,
            # transpose, broadcast, compare, ...) would be fused into a
            # neighbouring kernel by XLA:TPU — charging its operands would
            # systematically overstate the memory term (CPU dumps fuse less)
        memo[comp] = total
        return total

    if entry is None:
        return HloCost()
    return comp_cost(entry)


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Loop-aware collective bytes per kind (convenience wrapper)."""
    return {k: int(v) for k, v in analyze_hlo(hlo_text).collectives.items()}


def top_collectives(text: str, n: int = 12):
    """Debug view: largest collective contributors as
    (kind, shape, per_op_bytes, trips, total_bytes, metadata_op_name)."""
    comps, defs, entry = _parse_computations(text)

    # effective trip multiplier per computation, propagated from entry
    mult: Dict[str, float] = {}

    def visit(comp: str, k: float) -> None:
        mult[comp] = mult.get(comp, 0.0) + k
        for op in comps.get(comp, []):
            if op.opcode == "while":
                m = _COND_BODY_RE.search(op.attrs)
                if m:
                    tm = _TRIP_RE.search(op.attrs)
                    trips = int(tm.group(1)) if tm else 1
                    visit(m.group(2), k * trips)
                    visit(m.group(1), k * trips)
            elif op.opcode in ("fusion", "call", "conditional"):
                for mm in _CALLS_RE.finditer(op.attrs):
                    visit(mm.group(1), k)

    if entry is None:
        return []
    visit(entry, 1.0)
    rows = []
    meta_re = re.compile(r'op_name="([^"]*)"')
    for comp, k in mult.items():
        for op in comps.get(comp, []):
            for c in _COLLECTIVES:
                if op.opcode == c or op.opcode.startswith(c + "-start"):
                    b = parse_shape_bytes(op.shape)
                    m = meta_re.search(op.attrs)
                    rows.append((c, op.shape.split("{")[0], b, k, b * k,
                                 (m.group(1) if m else "")[:90]))
    rows.sort(key=lambda r: -r[4])
    return rows[:n]
