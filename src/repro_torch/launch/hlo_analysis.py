"""Post-partitioning HLO text analysis: loop-aware FLOP / HBM / collective
accounting.

Why not ``compiled.cost_analysis()``?  XLA's HloCostAnalysis visits every
computation ONCE — a 40-layer ``lax.scan`` body is counted a single time,
under-reporting FLOPs and bytes by ~n_layers.  This analyzer parses
``compiled.as_text()`` (the per-device partitioned module) and multiplies
each op by the trip count of its enclosing while loops (recovered from the
loop-condition constants).

Accounting model:
  * flops        — dot/convolution ops: 2 * prod(result dims) *
                   prod(lhs contracting dims).  Elementwise flops ignored
                   (the MXU roofline term is dot-dominated).
  * hbm_bytes    — for every top-level op with real traffic (post-fusion
                   HLO: fusions, dots, collectives, copies, slices...),
                   result bytes + operand bytes, operands resolved through
                   a per-computation symbol table.  In optimized HLO each
                   such op is one kernel, so operands+results approximate
                   its HBM traffic.
  * collectives  — result-shape bytes per op type with loop multiplicity.
                   The link-time model (2x ring all-reduce etc.) is applied
                   by the roofline layer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from collections import defaultdict

__all__ = ["HloAccounting", "analyze_hlo", "analyze_collectives"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_OP_RE = re.compile(
    r"^\s+(?:ROOT\s+)?%?([\w.\-_]+)\s*=\s*"
    r"((?:\([^)]*\))|(?:\w+\[[\d,]*\](?:\{[^}]*\})?)|(?:\w+\[\]))\s+"
    r"([\w\-]+)\(")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OPERAND_NAME_RE = re.compile(r"%([\w.\-_]+)")
_BODY_RE = re.compile(r"body=%?([\w.\-_]+)")
_COND_RE = re.compile(r"condition=%?([\w.\-_]+)")
_CALL_RE = re.compile(r"(?:to_apply|calls)=%?([\w.\-_]+)")
_BRANCH_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_TF_RE = re.compile(r"(?:true_computation|false_computation)=%?([\w.\-_]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-_]+)\s*(?:\([^)]*\))?.*\{")

_COLLECTIVE_OPS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                   "collective-permute", "all-reduce-start",
                   "all-gather-start", "collective-permute-start",
                   "reduce-scatter-start", "all-to-all-start"}
_NO_TRAFFIC_OPS = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "iota", "partition-id", "replica-id", "copy-start",
    "copy-done", "while", "conditional", "call", "all-reduce-done",
    "all-gather-done", "collective-permute-done", "reduce-scatter-done",
    "all-to-all-done", "opt-barrier",
    # loop-carry copies: XLA:CPU materializes full-buffer copies for
    # read+update-in-iteration carries (e.g. the KV cache); TPU aliases
    # donated buffers in place, so copies are excluded from HBM traffic.
    "copy",
}


def _prod(dims_txt: str) -> int:
    p = 1
    for d in dims_txt.split(","):
        if d:
            p *= int(d)
    return p


def _shape_bytes(shape_txt: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_txt):
        size = _DTYPE_BYTES.get(m.group(1))
        if size is None:
            continue
        total += size * _prod(m.group(2))
    return total


def _first_shape(shape_txt: str):
    m = _SHAPE_RE.search(shape_txt)
    if not m:
        return None, []
    return m.group(1), [int(d) for d in m.group(2).split(",") if d]


@dataclasses.dataclass
class HloAccounting:
    flops: float
    hbm_bytes: float
    coll_bytes_by_type: dict
    coll_count_by_type: dict

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll_bytes_by_type.values()))

    def to_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "bytes_by_type": dict(self.coll_bytes_by_type),
                "count_by_type": dict(self.coll_count_by_type),
                "total_bytes": self.collective_bytes}


def _split_computations(text: str):
    comps: dict[str, list[str]] = {}
    cur = None
    entry = None
    for line in text.splitlines():
        if not line.startswith(" ") and "{" in line:
            m = _COMP_HDR.match(line.strip())
            if m:
                cur = m.group(1)
                comps[cur] = []
                if line.strip().startswith("ENTRY"):
                    entry = cur
                continue
        if cur is not None and line.strip() == "}":
            cur = None
            continue
        if cur is not None:
            comps[cur].append(line)
    return comps, entry


def _trip_count(cond_lines: list[str]) -> int:
    best = 1
    for line in cond_lines:
        for m in _CONST_RE.finditer(line):
            best = max(best, int(m.group(1)))
    return best


def _symbols(lines: list[str]) -> dict[str, str]:
    """name -> result-shape text for one computation."""
    table = {}
    for line in lines:
        m = _OP_RE.match(line)
        if m:
            table[m.group(1)] = m.group(2)
    return table


# cast-like ops: XLA:CPU legalizes bf16 dots by upcasting operands to f32
# (and hoists weight-stack converts out of scan loops).  A TPU Mosaic
# pipeline fuses these casts into the consumer, so HBM sees the STORAGE
# dtype.  We resolve an operand's dtype through chains of such ops.
_CAST_OPS = {"convert", "bitcast", "copy"}

# ops that make a fusion "cast/layout-only" (no real compute): such fusion
# kernels exist on CPU but fuse into their consumer on TPU
_CAST_FUSION_OPS = _CAST_OPS | {"reshape", "transpose", "broadcast",
                                "parameter", "tuple", "get-tuple-element",
                                "slice"}


def _is_cast_fusion(body_lines: list[str]) -> bool:
    for line in body_lines:
        m = _OP_RE.match(line)
        if m and m.group(3) not in _CAST_FUSION_OPS:
            return False
    return True


def _defs(lines: list[str]) -> dict[str, tuple[str, str | None, str | None]]:
    """name -> (opcode, first operand name, called computation if fusion)."""
    table: dict[str, tuple[str, str | None, str | None]] = {}
    for line in lines:
        m = _OP_RE.match(line)
        if m:
            ops = _OPERAND_NAME_RE.findall(
                line[m.end(3):line.find(")", m.end(3)) + 1])
            call = _CALL_RE.search(line)
            table[m.group(1)] = (m.group(3), ops[0] if ops else None,
                                 call.group(1) if call else None)
    return table


def _resolved_bytes(name: str, sym: dict, defs: dict,
                    cast_fusions: set | None = None) -> int:
    """Bytes of value `name`: its own element count, dtype resolved through
    cast chains (storage dtype, as a fused TPU pipeline would see)."""
    shape_txt = sym.get(name, "")
    dt, dims = _first_shape(shape_txt)
    if dt is None:
        return 0
    elems = 1
    for d in dims:
        elems *= d
    cur = name
    for _ in range(6):
        entry = defs.get(cur)
        if not entry or not entry[1]:
            break
        opcode, first_op, called = entry
        chase = (opcode in _CAST_OPS
                 or (opcode == "fusion" and cast_fusions
                     and called in cast_fusions))
        if not chase:
            break
        cur = first_op
        src_dt, _ = _first_shape(sym.get(cur, ""))
        if src_dt is not None:
            dt = src_dt
    return _DTYPE_BYTES.get(dt, 4) * elems


def _operands(line: str, op_end: int) -> list[str]:
    """Operand names inside opcode( ... ) — up to the closing paren before
    any `, attr=` section."""
    start = line.index("(", op_end)
    depth = 0
    end = start
    for i in range(start, len(line)):
        if line[i] == "(":
            depth += 1
        elif line[i] == ")":
            depth -= 1
            if depth == 0:
                end = i
                break
    return _OPERAND_NAME_RE.findall(line[start:end + 1])


_PARAM_RE = re.compile(
    r"^\s+%?([\w.\-_]+)\s*=\s*((?:\([^)]*\))|(?:\w+\[[\d,]*\](?:\{[^}]*\})?))"
    r"\s+parameter\((\d+)\)")


def _fusion_touched(body_lines: list[str], body_sym: dict) -> dict[int, int]:
    """For each fusion parameter index: bytes actually touched.  A parameter
    consumed ONLY by dynamic-slice ops contributes its slice results (the
    kernel gathers a window of a big buffer, e.g. one scan step's saved
    activations), not the whole buffer."""
    params: dict[str, tuple[int, int]] = {}   # name -> (idx, full_bytes)
    for line in body_lines:
        pm = _PARAM_RE.match(line)
        if pm:
            params[pm.group(1)] = (int(pm.group(3)), _shape_bytes(pm.group(2)))
    touched: dict[int, int] = {}
    for name, (idx, full) in params.items():
        ds_bytes = 0
        other_use = False
        ref = "%" + name
        for line in body_lines:
            if ref not in line:
                continue
            om = _OP_RE.match(line)
            if om and om.group(1) == name:
                continue  # the definition line
            if om and om.group(3) == "dynamic-slice":
                ds_bytes += _shape_bytes(om.group(2))
            else:
                other_use = True
        if not other_use and ds_bytes:
            touched[idx] = min(full, ds_bytes)
        else:
            touched[idx] = full
    return touched


def analyze_hlo(hlo_text: str) -> HloAccounting:
    comps, entry = _split_computations(hlo_text)
    entry_lines = comps.get(entry, []) if entry else (
        max(comps.values(), key=len) if comps else [])
    symtabs = {name: _symbols(lines) for name, lines in comps.items()}
    deftabs = {name: _defs(lines) for name, lines in comps.items()}
    touched_cache: dict[str, dict[int, int]] = {}
    cast_fusions = {name for name, lines in comps.items()
                    if _is_cast_fusion(lines)}
    if entry:
        sym_entry = symtabs[entry]
    else:
        sym_entry = {}

    flops = 0.0
    hbm = 0.0
    coll_b = defaultdict(float)
    coll_n = defaultdict(float)
    stack: set[str] = set()
    _use_cache: dict[str, dict] = {}

    def use_index(comp_name: str) -> dict:
        """name -> [(consumer opcode, consumer name)] for one computation."""
        if comp_name in _use_cache:
            return _use_cache[comp_name]
        idx: dict[str, list] = {}
        for line2 in comps.get(comp_name, []):
            m2 = _OP_RE.match(line2)
            if not m2:
                continue
            for o in _operands(line2, m2.end(3)):
                idx.setdefault(o, []).append((m2.group(3), m2.group(1)))
        _use_cache[comp_name] = idx
        return idx

    def walk(comp_name: str, lines: list[str], mult: float,
             count_bytes: bool) -> None:
        nonlocal flops, hbm
        sym = symtabs.get(comp_name, sym_entry)
        dfs = deftabs.get(comp_name, {})
        for line in lines:
            om = _OP_RE.match(line)
            if not om:
                continue
            opcode = om.group(3)
            result_txt = om.group(2)

            if opcode in ("dot", "convolution"):
                _, rdims = _first_shape(result_txt)
                r_elems = 1
                for d in rdims:
                    r_elems *= d
                k = 1
                cm = _CONTRACT_RE.search(line)
                ops = _operands(line, om.end(3))
                if cm and ops:
                    lhs_shape = sym.get(ops[0], "")
                    _, ldims = _first_shape(lhs_shape)
                    for ci in cm.group(1).split(","):
                        if ci and int(ci) < len(ldims):
                            k *= ldims[int(ci)]
                flops += 2.0 * r_elems * k * mult

            base_op = opcode.replace("-start", "")
            if opcode in _COLLECTIVE_OPS:
                dt, dims = _first_shape(result_txt)
                elems = 1
                for dd in dims:
                    elems *= dd
                # XLA:CPU legalizes bf16 dots to f32, so reduces of dot
                # partials appear in f32; a TPU program reduces in the
                # compute dtype.  If every consumer of this collective is a
                # down-cast, count at the consumer dtype.
                name = om.group(1)
                uses = use_index(comp_name)
                consumers = uses.get(name, [])
                if consumers and all(c[0] == "convert" for c in consumers):
                    cdts = [_first_shape(sym.get(c[1], ""))[0]
                            for c in consumers]
                    sizes = [_DTYPE_BYTES.get(c, 4) for c in cdts if c]
                    if sizes:
                        dt_size = min(min(sizes), _DTYPE_BYTES.get(dt, 4))
                    else:
                        dt_size = _DTYPE_BYTES.get(dt, 4)
                else:
                    dt_size = _DTYPE_BYTES.get(dt, 4)
                coll_b[base_op] += dt_size * elems * mult
                coll_n[base_op] += mult

            is_cast_fus = False
            if opcode == "fusion":
                cm0 = _CALL_RE.search(line)
                is_cast_fus = bool(cm0 and cm0.group(1) in cast_fusions)
            if (count_bytes and opcode not in _NO_TRAFFIC_OPS
                    and opcode not in _CAST_OPS and not is_cast_fus):
                op_names = _operands(line, om.end(3))
                ops_b = [_resolved_bytes(o, sym, dfs, cast_fusions)
                         for o in op_names]
                # match both HLO opcode (dash) and jax metadata (underscore)
                if ("dynamic-update-slice" in line
                        or "dynamic_update_slice" in line):
                    # in-place update: traffic = 2x the written slice, not
                    # the whole (possibly multi-GB cache/carry) buffer
                    traffic = 2.0 * (sum(ops_b) - max(ops_b, default=0))
                elif "dynamic-slice" in line and opcode != "fusion":
                    traffic = 2.0 * _shape_bytes(result_txt)
                else:
                    if opcode == "fusion":
                        cm4 = _CALL_RE.search(line)
                        if cm4 and cm4.group(1) in comps:
                            body = cm4.group(1)
                            if body not in touched_cache:
                                touched_cache[body] = _fusion_touched(
                                    comps[body], symtabs.get(body, {}))
                            tmap = touched_cache[body]
                            ops_b = [min(b, tmap.get(i, b))
                                     for i, b in enumerate(ops_b)]
                    traffic = _shape_bytes(result_txt) + sum(ops_b)
                hbm += traffic * mult

            if opcode == "while":
                bm = _BODY_RE.search(line)
                cm2 = _COND_RE.search(line)
                if bm and bm.group(1) in comps and bm.group(1) not in stack:
                    trips = (_trip_count(comps[cm2.group(1)])
                             if cm2 and cm2.group(1) in comps else 1)
                    stack.add(bm.group(1))
                    walk(bm.group(1), comps[bm.group(1)], mult * trips,
                         count_bytes)
                    stack.discard(bm.group(1))
            elif opcode == "conditional":
                names = []
                m3 = _BRANCH_RE.search(line)
                if m3:
                    names += [n.strip().lstrip("%")
                              for n in m3.group(1).split(",")]
                names += _TF_RE.findall(line)
                for name in names:
                    if name in comps and name not in stack:
                        stack.add(name)
                        walk(name, comps[name], mult, count_bytes)
                        stack.discard(name)
            else:
                # fusions / reducers / calls: count dot flops inside, but
                # traffic is already accounted at this (kernel) level.
                for m4 in _CALL_RE.finditer(line):
                    name = m4.group(1)
                    if name in comps and name not in stack:
                        stack.add(name)
                        walk(name, comps[name], mult, False)
                        stack.discard(name)

    walk(entry or "", entry_lines, 1.0, True)
    return HloAccounting(flops, hbm, dict(coll_b), dict(coll_n))


def analyze_collectives(hlo_text: str):
    """Back-compat wrapper returning the full accounting."""
    return analyze_hlo(hlo_text)


# ---------------------------------------------------------------------------
# Everything above is ``repro``'s module as it is.  Below: the same
# accounting for a step that has no HLO, from the ops it dispatches.
# ---------------------------------------------------------------------------

import weakref  # noqa: E402
from collections import Counter  # noqa: E402

import torch  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.utils import _pytree  # noqa: E402
from torch.utils._python_dispatch import (  # noqa: E402
    TorchDispatchMode, _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry  # noqa: E402

__all__ += ["StepAccounting", "analyze_step", "step_phase", "PHASES"]

#: collectives by ``repro``'s HLO type names.  A point-to-point send is a
#: ``collective-permute`` at the bytes it sends; a receive is the sending
#: rank's permute and is not counted again.
_STEP_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
}
#: collectives whose result is written into buffers passed in: their
#: result-shape bytes are those of the first argument (the outputs); an
#: in-place all-reduce's and a send's are its tensors'
_STEP_OUT_ARG = {"c10d.allgather_", "c10d._allgather_base_",
                 "c10d.allgather_into_tensor_coalesced_",
                 "c10d.reduce_scatter_", "c10d._reduce_scatter_base_",
                 "c10d.reduce_scatter_tensor_coalesced_", "c10d.alltoall_",
                 "c10d.alltoall_base_", "c10d.allreduce_",
                 "c10d.allreduce_coalesced_", "c10d.send"}
#: ops that move no data: allocation, metadata, the completion of a
#: collective, and ``repro``'s casts and copies (a cast is read at its
#: source dtype by its consumer; copies are excluded as ``copy`` is above)
_STEP_NO_TRAFFIC = {
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.detach", "aten.alias", "aten.lift_fresh",
    "aten.lift_fresh_copy", "aten._local_scalar_dense", "aten.set_",
    "aten._to_copy", "aten.copy_", "aten.clone", "aten.copy",
    "_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd",
    "c10d.recv_", "c10d.barrier"}


#: the phases of a train step a storage is made in: the forward (and
#: whatever runs outside the other two), the backward (an autograd node is
#: running: the VJPs, and the recomputation of rematerialized blocks) and
#: the optimizer (the span :func:`step_phase` marks)
PHASES = ("forward", "backward", "optimizer")
#: the largest groups of live storages that ``peak_by_origin`` names
TOP_ORIGINS = 10
#: collectives whose results are new storages (written into buffers made
#: for them): they become those storages' origin
_RESULT_COLLECTIVES = ("all-gather", "reduce-scatter", "all-to-all")


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@contextlib.contextmanager
def step_phase(name: str):
    """Mark the body as the step's ``name`` phase (one of
    :data:`PHASES`) for a step traced by :func:`analyze_step`: the
    storages made in it are booked to that phase.  Outside a trace it
    does nothing; inside an autograd node the phase is the backward."""
    modes = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, _StepTracer)]
    before = [m.phase for m in modes]
    for m in modes:
        m.phase = name
    try:
        yield
    finally:
        for m, phase in zip(modes, before):
            m.phase = phase


@dataclasses.dataclass
class StepAccounting(HloAccounting):
    """:class:`HloAccounting` of a traced step (the same ``to_dict()``),
    plus what the trace sees of memory and of the kernels: ``peak_bytes``,
    the most bytes of storages made by the step alive at once;
    ``output_bytes`` and ``alias_bytes``, the step's results in storages
    it made and in storages it was given; ``kernels``, calls per kernel
    (the wrappers' ``meta`` routes report them), ``kernel_flops`` the
    flops they report; ``kernel_paths``, the calls by kernel path where
    the kernel has several."""

    peak_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    kernel_paths: dict = dataclasses.field(default_factory=dict)
    kernel_flops: dict = dataclasses.field(default_factory=dict)
    peak_phase: str | None = None
    peak_by_origin: list = dataclasses.field(default_factory=list)
    phase_peaks: dict = dataclasses.field(default_factory=dict)


class _StepTracer(TorchDispatchMode):
    """The dispatch mode :func:`analyze_step` runs a step under.  Two
    attributes are read from outside through the dispatch-mode stack,
    which autograd carries into the backward: ``stands_for``, the device
    type that a ``meta`` GEMM's engines rank for
    (:func:`repro_torch.device.ranked_device`), and ``kernel_call``, which
    the kernels' ``meta`` routes report to
    (:func:`repro_torch.kernels.common.gemm.report_meta_call`)."""

    #: the device type the traced step will run on
    stands_for = "cuda"

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm = 0.0
        self.coll_b: dict = defaultdict(float)
        self.coll_n: dict = defaultdict(float)
        self.kernels: Counter = Counter()
        self.kernel_flops: Counter = Counter()
        self.kernel_paths: dict = {}
        self.live = 0
        self.peak = 0
        self.made: dict[int, int] = {}        # storage -> bytes, made here
        self.cast_from: dict[int, int] = {}   # storage -> source itemsize
        self.phase = "forward"                # outside an autograd node
        self.group_of: dict[int, tuple] = {}  # storage -> its group
        self.groups: Counter = Counter()      # live bytes a group
        self.members: Counter = Counter()     # live storages a group
        self.phase_peaks: dict = {}
        self.peak_phase = None
        self.peak_groups: dict = {}           # group -> (storages, bytes)
        self.at_peak = False                  # no storage died since

    def kernel_call(self, name: str, flops: float, nbytes: float,
                    path: str | None = None) -> None:
        self.kernels[name] += 1
        self.kernel_flops[name] += flops
        if path is not None:
            paths = self.kernel_paths.setdefault(name, Counter())
            paths[path] += 1
        self.flops += flops
        self.hbm += nbytes

    def _bytes(self, t: torch.Tensor) -> int:
        """``t``'s bytes at its storage dtype: a cast's result counts at
        its source's itemsize, as ``_resolved_bytes`` chases converts."""
        size = self.cast_from.get(_storage_key(t), t.element_size())
        return t.numel() * size

    def _phase(self) -> str:
        return ("backward" if torch._C._current_autograd_node() is not None
                else self.phase)

    def _made(self, key: int, nbytes: int, storage, group: tuple) -> None:
        self.made[key] = nbytes
        self.group_of[key] = group
        self.groups[group] += nbytes
        self.members[group] += 1
        self.live += nbytes
        phase = group[0]
        self.phase_peaks[phase] = max(self.phase_peaks.get(phase, 0),
                                      self.live)
        if self.live > self.peak:
            self.peak, self.peak_phase, self.at_peak = self.live, phase, True
        weakref.finalize(storage, self._freed, key)

    def _snapshot(self) -> None:
        """Keep what is live at the peak just reached (taken when the
        first storage dies after it, or at the end)."""
        if self.at_peak:
            self.peak_groups = {g: (self.members[g], b)
                                for g, b in self.groups.items() if b}
            self.at_peak = False

    def _regroup(self, key: int, group: tuple) -> None:
        old = self.group_of[key]
        nbytes = self.made[key]
        self.groups[old] -= nbytes
        self.members[old] -= 1
        self.groups[group] += nbytes
        self.members[group] += 1
        self.group_of[key] = group

    def _freed(self, key: int) -> None:
        if key not in self.made:
            return
        self._snapshot()
        nbytes = self.made.pop(key)
        group = self.group_of.pop(key)
        self.groups[group] -= nbytes
        self.members[group] -= 1
        if not self.members[group]:
            del self.groups[group], self.members[group]
        self.live -= nbytes
        self.cast_from.pop(key, None)

    def peak_by_origin(self) -> list:
        """``peak_groups`` as records, the largest first, the rest as
        one ``"other"`` group; their bytes sum to the peak."""
        self._snapshot()
        rows = sorted(((b, n, g) for g, (n, b) in self.peak_groups.items()),
                      key=lambda r: (-r[0], r[2][:2]))
        out = [{"phase": g[0], "origin": g[1], "shape": list(g[2]),
                "dtype": str(g[3]).removeprefix("torch."), "count": n,
                "bytes": b} for b, n, g in rows[:TOP_ORIGINS]]
        rest = rows[TOP_ORIGINS:]
        if rest:
            out.append({"phase": None, "origin": "other", "shape": None,
                        "dtype": None, "count": sum(r[1] for r in rest),
                        "bytes": sum(r[0] for r in rest)})
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let a DTensor lower to ops on its local tensors first
            return NotImplemented
        if any(t is not torch.Tensor and issubclass(t, torch.Tensor)
               for t in types):
            # shape inference on fake tensors (DTensor's sharding
            # propagation): no work of the step
            return func(*args, **kwargs)
        name = str(func._overloadpacket)
        if (func._overloadpacket not in flop_registry
                and name not in _STEP_COLLECTIVES):
            # a composite op (``einsum`` under inference mode) is seen as
            # the ops it lowers to, as autograd would have dispatched them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = [t for t in _pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if any(type(t) is not torch.Tensor for t in outs):
            # a factory op made a fake tensor for DTensor's shape inference
            return out
        ins = [t for t in _pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        kind = _STEP_COLLECTIVES.get(name)
        phase = self._phase()
        if kind is not None:
            result = (_pytree.tree_leaves(args[0]) if name in _STEP_OUT_ARG
                      else outs)
            self.coll_b[kind] += sum(t.numel() * t.element_size()
                                     for t in result
                                     if isinstance(t, torch.Tensor))
            self.coll_n[kind] += 1
            if name in _STEP_OUT_ARG and kind in _RESULT_COLLECTIVES:
                for t in result:      # buffers made for the result
                    if (isinstance(t, torch.Tensor)
                            and _storage_key(t) in self.made):
                        self._regroup(_storage_key(t), (
                            phase, kind, tuple(t.shape), t.dtype))
        if not (func.is_view or name in _STEP_NO_TRAFFIC):
            self.hbm += (sum(self._bytes(t) for t in ins)
                         + sum(t.numel() * t.element_size() for t in outs))
        if func.is_view:
            return out
        given = {_storage_key(t) for t in ins}
        origin = kind or name
        if name == "aten.cat" and ins:
            # a concatenation of one collective's results is its result
            made_by = {self.group_of.get(_storage_key(t), (0, None))[1]
                       for t in ins}
            if len(made_by) == 1 and made_by <= set(_RESULT_COLLECTIVES):
                origin = made_by.pop()
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in given or key in self.made:
                continue
            self._made(key, storage.nbytes(), storage,
                       (phase, origin, tuple(t.shape), t.dtype))
            if name == "aten._to_copy" and ins:
                self.cast_from[key] = self.cast_from.get(
                    _storage_key(ins[0]), ins[0].element_size())
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def analyze_step(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), StepAccounting)``: the step run once on
    ``meta`` tensors (and DTensors of them) under a dispatch mode that
    keeps ``analyze_hlo``'s accounting from the ops it dispatches:

    * ``flops``: matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
      convolutions: what ``einsum`` and ``matmul`` lower to) count
      2·∏(result dims)·k, by ``torch.utils.flop_counter``'s formulas;
      elementwise ops are ignored.  A kernel counts what its ``meta``
      route reports: its plain formulation's flops.
    * ``hbm_bytes``: operand bytes plus result bytes of every op that
      moves data; views, allocation, metadata ops, casts and copies are
      left out (``_NO_TRAFFIC_OPS``), and an operand that is a cast's
      result counts at the cast's source dtype (``_resolved_bytes``).
    * collectives: result-shape bytes and counts per type, under the HLO
      type names (``_STEP_COLLECTIVES``), from ``c10d`` and
      ``c10d_functional`` ops alike (DTensor issues the latter).
    * memory: every storage an op makes, live until it dies (views share
      their base's storage; an in-place write makes none), booked to the
      phase and the op that made it: what is live at the peak, by origin
      (``StepAccounting``).

    A Python layer loop replaces the trip-count multiplier: each layer's
    ops are simply seen each time.  The traced GEMMs rank their engines
    for the card, where the step will run, not for ``meta``.  Nothing is
    allocated on any device and nothing is launched."""
    tracer = _StepTracer()
    with tracer:
        result = fn(*args, **kwargs)
    output = alias = 0
    seen: set[int] = set()
    for t in _pytree.tree_leaves(result):
        if not isinstance(t, torch.Tensor):
            continue
        t = _local(t)
        key = _storage_key(t)
        if key in seen:
            continue
        seen.add(key)
        if key in tracer.made:
            output += tracer.made[key]
        else:
            alias += t.untyped_storage().nbytes()
    acct = StepAccounting(
        tracer.flops, tracer.hbm, dict(tracer.coll_b), dict(tracer.coll_n),
        peak_bytes=tracer.peak, output_bytes=output, alias_bytes=alias,
        kernels=dict(tracer.kernels), kernel_flops=dict(tracer.kernel_flops),
        kernel_paths={k: dict(v) for k, v in tracer.kernel_paths.items()},
        peak_phase=tracer.peak_phase,
        peak_by_origin=tracer.peak_by_origin(),
        phase_peaks=dict(tracer.phase_peaks))
    return result, acct
