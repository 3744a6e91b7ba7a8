"""Compile microarchitecture behavior tables into dense arrays.

The scalar :class:`~repro_torch.core.simulator.SimMachine` walks the
:class:`~repro_torch.core.uarch.UArch` dataclass tables (frozensets, tuples of
operand names) for every μop it dispatches.  The batched backend in
``batch_sim.py`` cannot afford that: it wants the whole behavior table
*lowered once* into flat integer arrays so that turning an instruction
sequence into tensors is table lookups, not dataclass traversal.

Two artifacts live here:

* :class:`UopTableIndex` — a stable instruction/operand indexing derived
  from an :class:`~repro_torch.core.isa.ISA`.  All uarches compiled against the
  same index share instruction numbering and operand-slot codes, so a
  campaign over several uarches can reuse one index (and, downstream, one
  set of lowered experiment tensors) across machines.

* :class:`CompiledUArch` — one uarch's behavior tables as dense arrays:
  per-μop port bitmasks (over the *sorted* port axis, which is also the
  scalar simulator's tie-break order), latencies, occupancies and
  slot-coded read/write operand lists, plus per-instruction flags
  (elimination period, divider extra, same-register variants, zero-idiom
  handling) and the machine parameters (issue width, harness overhead,
  partial-register stall penalty, store-forward latency).

Slot coding (per instruction): ``0..TEMP_BASE-1`` are operand positions in
``spec.operands`` order; ``TEMP_BASE..EXTRA_BASE-1`` index the
instruction's intra-μop temporaries (``%0``, ``%a``, ...); ``EXTRA_BASE+``
index raw names that are neither (read straight as register names, the
scalar simulator's fallback); ``-1`` is padding.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.isa import FLAGS, GPR, IMM, ISA, MEM
from repro_torch.core.uarch import InstrBehavior, UArch

TEMP_BASE = 32     # slots below this are operand positions
EXTRA_BASE = 64    # slots from here are per-instruction raw names
PAD = -1


@dataclass(frozen=True)
class SpecInfo:
    """Operand-level metadata for one instruction variant (ISA-derived)."""
    name: str
    op_names: tuple            # operand names, spec order
    op_otype: tuple
    op_read: tuple             # bool per operand
    op_written: tuple
    op_width: tuple
    zero_idiom: bool
    may_eliminate: bool
    # derived, in spec-operand order
    same_reg_ops: tuple        # explicit non-IMM/MEM/FLAGS operand names
    dest_names: tuple          # written operand names
    mem_read: dict             # mem operand name -> bool(read)
    elim_src: str | None       # first non-IMM source operand name
    snapshot: tuple            # (op name, gpr_read_check, width) non-MEM ops

    @classmethod
    def of(cls, spec) -> "SpecInfo":
        ex = tuple(o.name for o in spec.explicit_operands
                   if o.otype not in (IMM, MEM, FLAGS))
        mem = {o.name: o.read for o in spec.operands if o.otype == MEM}
        src = next((o.name for o in spec.sources if o.otype != IMM), None)
        snap = tuple((o.name, bool(o.read and o.otype == GPR), o.width)
                     for o in spec.operands if o.otype != MEM)
        return cls(spec.name,
                   tuple(o.name for o in spec.operands),
                   tuple(o.otype for o in spec.operands),
                   tuple(o.read for o in spec.operands),
                   tuple(o.written for o in spec.operands),
                   tuple(o.width for o in spec.operands),
                   spec.zero_idiom, spec.may_eliminate,
                   ex, tuple(o.name for o in spec.dests), mem, src, snap)


class UopTableIndex:
    """Stable instruction + operand-slot numbering for a μISA.

    Built once per ISA and shared by every :class:`CompiledUArch` of a
    campaign, so μop-table row spaces line up across uarches."""

    def __init__(self, specs):
        self.specs: list[SpecInfo] = [SpecInfo.of(s) for s in specs]
        self.names: tuple = tuple(s.name for s in self.specs)
        self.idx: dict = {n: i for i, n in enumerate(self.names)}

    _cache: dict = {}
    _CACHE_MAX = 64   # bounded: a hot-reloading service makes fresh ISAs

    @classmethod
    def for_isa(cls, isa: ISA) -> "UopTableIndex":
        key = id(isa)
        hit = cls._cache.get(key)
        if hit is None or hit[0] is not isa:
            hit = (isa, cls(list(isa)))
            while len(cls._cache) >= cls._CACHE_MAX:
                cls._cache.pop(next(iter(cls._cache)))
            cls._cache[key] = hit
        return hit[1]


# per-instruction flag bits
F_PRESENT = 1        # uarch has a behavior for this instruction
F_HAS_SR = 2         # same-register behavior variant exists
F_DEP_BREAK = 4      # dep_breaking_same_reg
F_ZERO_NOUOP = 8     # zero_uop_same_reg


@dataclass
class CompiledUArch:
    """One uarch's behavior tables lowered to dense arrays."""
    uarch: UArch
    index: UopTableIndex
    ports: tuple               # sorted port names == kernel axis == scalar
    port_pos: dict             # port name -> axis   tie-break order
    issue_width: int
    overhead_cycles: int
    partial_stall_penalty: int
    store_forward_latency: int
    # per-instruction (index order)
    uop_off: np.ndarray        # int32[n_instr]  row offset, primary variant
    n_uops: np.ndarray         # int32[n_instr]  (-1 when not present)
    sr_off: np.ndarray         # int32[n_instr]  same-reg variant rows
    sr_n: np.ndarray           # int32[n_instr]  (-1 when no variant)
    elim_period: np.ndarray    # int32[n_instr]  (per selected variant:
    divider_extra: np.ndarray  # int32[n_instr]   the scalar oracle reads
    zero_nouop: np.ndarray     # bool[n_instr]    these off the behavior
    sr_elim_period: np.ndarray   # int32[n_instr] *after* the same-register
    sr_divider_extra: np.ndarray  # int32[n_instr] switch, so both variants
    sr_zero_nouop: np.ndarray  # bool[n_instr]    are compiled)
    flags: np.ndarray          # uint8[n_instr]  F_* bits
    syms: list = field(default_factory=list)  # per instr: temp+extra names
    # per-μop-row
    port_mask: np.ndarray = None   # uint32[n_rows] bit i = self.ports[i]
    mask_id: np.ndarray = None     # int16[n_rows] compact mask id
    latency: np.ndarray = None     # int32[n_rows]
    occupancy: np.ndarray = None   # int32[n_rows]
    reads: np.ndarray = None       # int16[n_rows, max_reads] slot-coded
    writes: np.ndarray = None      # int16[n_rows, max_writes]
    mask_table: np.ndarray = None  # bool[n_masks, n_ports]
    _dev_luts: dict = field(default_factory=dict, repr=False, compare=False)

    # ------------------------------------------------------------------
    def device_mask_table(self, device):
        """The μop port-mask LUT as a ``torch.bool`` tensor on ``device``
        (memoized per device).

        The wave-dispatch kernel indexes this table every step; keeping it
        resident means it crosses host→device once per compiled uarch and
        device, not once per executed wave."""
        import torch  # noqa: PLC0415 - device path only

        device = torch.device(device)
        lut = self._dev_luts.get(device)
        if lut is None:
            lut = self._dev_luts[device] = torch.from_numpy(
                np.ascontiguousarray(self.mask_table, dtype=np.bool_)
            ).to(device)
        return lut

    def decode_slot(self, instr_i: int, slot: int) -> str:
        """Slot code -> name (operand / temp / raw register)."""
        if slot < TEMP_BASE:
            return self.index.specs[instr_i].op_names[slot]
        return self.syms[instr_i][slot - TEMP_BASE]

    def behavior_rows(self, instr_i: int, same_reg: bool):
        """(offset, count) of the μop rows the scalar oracle would use."""
        if not self.flags[instr_i] & F_PRESENT:
            raise KeyError(self.index.names[instr_i])
        if same_reg and self.flags[instr_i] & F_HAS_SR:
            return int(self.sr_off[instr_i]), int(self.sr_n[instr_i])
        return int(self.uop_off[instr_i]), int(self.n_uops[instr_i])


def _slot(info: SpecInfo, syms: list, name: str) -> int:
    """Slot code for a μop read/write name, growing the symbol table."""
    try:
        return info.op_names.index(name)
    except ValueError:
        pass
    try:
        return TEMP_BASE + syms.index(name)
    except ValueError:
        syms.append(name)
        return TEMP_BASE + len(syms) - 1


def compile_uarch(ua: UArch, isa: ISA,
                  index: UopTableIndex | None = None) -> CompiledUArch:
    """Lower ``ua``'s behavior tables against ``index`` (default: the
    ISA's shared index). Memoized per (uarch, index) identity."""
    if index is None:
        index = UopTableIndex.for_isa(isa)
    key = (id(ua), id(index))
    hit = _COMPILE_CACHE.get(key)
    if hit is not None and hit.uarch is ua and hit.index is index:
        return hit

    ports = tuple(sorted(ua.ports))
    port_bit = {p: i for i, p in enumerate(ports)}
    n = len(index.names)
    uop_off = np.full(n, -1, np.int32)
    n_uops = np.full(n, -1, np.int32)
    sr_off = np.full(n, -1, np.int32)
    sr_n = np.full(n, -1, np.int32)
    elim_period = np.zeros(n, np.int32)
    divider_extra = np.zeros(n, np.int32)
    zero_nouop = np.zeros(n, bool)
    sr_elim_period = np.zeros(n, np.int32)
    sr_divider_extra = np.zeros(n, np.int32)
    sr_zero_nouop = np.zeros(n, bool)
    flags = np.zeros(n, np.uint8)
    syms: list = [() for _ in range(n)]

    rows_mask: list = []
    rows_lat: list = []
    rows_occ: list = []
    rows_reads: list = []
    rows_writes: list = []

    def emit(info: SpecInfo, sym_list: list, uops) -> tuple:
        off = len(rows_mask)
        for u in uops:
            m = 0
            for p in u.ports:
                m |= 1 << port_bit[p]
            rows_mask.append(m)
            rows_lat.append(u.latency)
            rows_occ.append(u.occupancy)
            rows_reads.append([_slot(info, sym_list, r) for r in u.reads])
            rows_writes.append([_slot(info, sym_list, w) for w in u.writes])
        return off, len(uops)

    for i, name in enumerate(index.names):
        b: InstrBehavior | None = ua.behaviors.get(name)
        if b is None:
            continue
        info = index.specs[i]
        sym_list: list = []
        flags[i] |= F_PRESENT
        uop_off[i], n_uops[i] = emit(info, sym_list, b.uops)
        if b.same_reg is not None:
            flags[i] |= F_HAS_SR
            sr_off[i], sr_n[i] = emit(info, sym_list, b.same_reg.uops)
            sr_elim_period[i] = b.same_reg.elim_period
            sr_divider_extra[i] = b.same_reg.divider_extra
            sr_zero_nouop[i] = b.same_reg.zero_uop_same_reg
        if b.dep_breaking_same_reg:
            flags[i] |= F_DEP_BREAK
        if b.zero_uop_same_reg:
            flags[i] |= F_ZERO_NOUOP
            zero_nouop[i] = True
        elim_period[i] = b.elim_period
        divider_extra[i] = b.divider_extra
        syms[i] = tuple(sym_list)

    n_rows = len(rows_mask)
    max_r = max((len(r) for r in rows_reads), default=0)
    max_w = max((len(w) for w in rows_writes), default=0)
    reads = np.full((n_rows, max(max_r, 1)), PAD, np.int16)
    writes = np.full((n_rows, max(max_w, 1)), PAD, np.int16)
    for j, r in enumerate(rows_reads):
        reads[j, :len(r)] = r
    for j, w in enumerate(rows_writes):
        writes[j, :len(w)] = w

    port_mask = np.array(rows_mask, np.uint32) if n_rows else \
        np.zeros(0, np.uint32)
    distinct = {}
    mask_id = np.zeros(n_rows, np.int16)
    for j, m in enumerate(rows_mask):
        mask_id[j] = distinct.setdefault(int(m), len(distinct))
    table = np.zeros((max(len(distinct), 1), len(ports)), bool)
    for m, mid in distinct.items():
        for b_ in range(len(ports)):
            table[mid, b_] = bool(m >> b_ & 1)

    out = CompiledUArch(
        ua, index, ports, port_bit, ua.issue_width, ua.overhead_cycles,
        ua.partial_stall_penalty, ua.store_forward_latency,
        uop_off, n_uops, sr_off, sr_n, elim_period, divider_extra,
        zero_nouop, sr_elim_period, sr_divider_extra, sr_zero_nouop, flags,
        syms, port_mask, mask_id,
        np.array(rows_lat, np.int32) if n_rows else np.zeros(0, np.int32),
        np.array(rows_occ, np.int32) if n_rows else np.zeros(0, np.int32),
        reads, writes, table)
    while len(_COMPILE_CACHE) >= _COMPILE_CACHE_MAX:
        _COMPILE_CACHE.pop(next(iter(_COMPILE_CACHE)))
    _COMPILE_CACHE[key] = out
    return out


# bounded (oldest-out): long-lived processes re-characterizing against
# fresh UArch/ISA objects must not pin every compiled table set forever
_COMPILE_CACHE: dict = {}
_COMPILE_CACHE_MAX = 64
