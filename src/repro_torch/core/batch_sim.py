"""Batched simulated machine: whole experiment waves as one array program.

The port of the reference package's ``repro.core.batch_sim`` to PyTorch and
CUDA.  The scalar :class:`~repro_torch.core.simulator.SimMachine` interprets
one μop per Python-loop iteration; this module executes a *wave* of
experiments at once: each instruction sequence is lowered to flat integer
tensors (issue cycles, port-mask ids, latencies, occupancies, dependency
producers), the wave is padded to ``(n_uops, n_experiments)``, and the
dispatch/dependency recurrence runs as one kernel call per chunk.  Two
backends share the lowering and packing layers:

* ``cuda`` (the default) — the hand-written CUDA kernel
  :func:`repro_torch.kernels.wave_dispatch.wave_dispatch` on a CUDA device.
  A build or launch failure raises out of :meth:`BatchSimMachine.run_batch`:
  there is no fallback to another backend.
* ``torch`` — the kernel's plain PyTorch version
  (:func:`~repro_torch.kernels.wave_dispatch.wave_dispatch_ref`) on any
  device; the CPU tests run this one.

Lowering, the lowering cache, period tiling, shape buckets, lane-major
packing into reused bucket buffers and Counters extraction are the
reference's, unchanged.  The packed ``(E, S)`` buffers cross to the device
once per chunk and are transposed there to the kernel's ``(S, E)`` layout,
in which a warp's loads and stores of one μop row are contiguous.

Bit-identity with the scalar oracle is by construction: every quantity in
the simulation (issue cycles, latencies, penalties, port-free times) is an
integer, so the kernels run in int32 arithmetic and convert to the same
float values the scalar machine produces.  ``tests/test_torch_batch_sim.py``
holds every wave against the reference package's backends.
"""
from __future__ import annotations

import threading
from collections import deque

import numpy as np
import torch

from repro_torch.core.device_mesh import device_key, dispatch_lock
from repro_torch.core.isa import IMM, ISA
from repro_torch.core.simulator import Counters, _implicit_reg
from repro_torch.core.uarch import UArch
from repro_torch.core.uarch_compile import (F_HAS_SR, F_PRESENT, TEMP_BASE,
                                            CompiledUArch, UopTableIndex,
                                            compile_uarch)
from repro_torch.faults import plan as faults
from repro_torch.kernels import wave_dispatch as wd
from repro_torch.obs import tracer as obs

# producer descriptor kinds (recipe-time)
_P_SNAP, _P_TMP, _P_MEM, _P_CUR = 0, 1, 2, 3
# write descriptor kinds
_W_TMP, _W_MEM, _W_CELL = 0, 1, 2
# recipe kinds
_K_NORMAL, _K_ZERO_NOUOP, _K_ELIM = 0, 1, 2

BACKENDS = ("cuda", "torch")

# thin-chunk scalar-oracle crossover (lanes): below this many parallel
# lanes a chunk runs on the scalar oracle instead of the kernel (the
# reference's routing by data; results are bit-identical either way)
DEFAULT_MIN_LANES = 4

# lowering-cache bound (distinct (body, unroll-count) programs).  A full
# characterization stays in the hundreds; the bound exists so service-backed
# machines fed unbounded query streams cannot grow without limit.
DEFAULT_LOWER_CACHE = 4096


def _fault_key(code) -> str:
    """Content key for ``wave.kernel`` fault rules: the sequence's spec
    string, so a seeded fault follows its poisoned sequence through every
    bisection sub-wave and every backend, and ``match=`` clauses can
    target instructions by name (see :mod:`repro_torch.faults.plan`)."""
    return ";".join(ins.spec for ins in code)


class _Plan:
    """One executable μop of a lowered instruction recipe."""
    __slots__ = ("mask_id", "lat", "blk", "vis", "prods", "sf", "sf_cell",
                 "writes", "issue_off")

    def __init__(self, mask_id, lat, blk, vis, prods, sf, sf_cell, writes,
                 issue_off):
        self.mask_id = mask_id
        self.lat = lat
        self.blk = blk
        self.vis = vis
        self.prods = prods
        self.sf = sf
        self.sf_cell = sf_cell
        self.writes = writes
        self.issue_off = issue_off


class _Recipe:
    """Lowering recipe for one concrete instruction instance."""
    __slots__ = ("kind", "dest_cells", "period", "ekey", "src_cell",
                 "dst_cell", "advance", "snapshot", "plans", "ckey")

    def __init__(self, kind, advance, snapshot=(), plans=(), dest_cells=(),
                 period=0, ekey=None, src_cell=-1, dst_cell=-1, ckey=None):
        self.kind = kind
        self.advance = advance
        self.snapshot = snapshot
        self.plans = plans
        self.dest_cells = dest_cells
        self.period = period
        self.ekey = ekey
        self.src_cell = src_cell
        self.dst_cell = dst_cell
        self.ckey = ckey           # content key (spec, regs, value_hint)


class _Prog:
    """One experiment lowered to flat int32 tensors."""
    __slots__ = ("n_rows", "issue", "mask", "lat", "blk", "vis", "prod",
                 "delta", "finals", "max_r")

    def __init__(self, n_rows, issue, mask, lat, blk, vis, prod, delta,
                 finals, max_r):
        self.n_rows = n_rows
        self.issue = issue
        self.mask = mask
        self.lat = lat
        self.blk = blk
        self.vis = vis
        self.prod = prod
        self.delta = delta
        self.finals = finals
        self.max_r = max_r


def _body_period(ids) -> int:
    """Smallest p with ``ids == ids[:p] * k`` (object identities — the
    engine's ``body * n`` unrollings share instruction objects)."""
    n = len(ids)
    if n < 2:
        return n
    first = ids[0]
    for p in range(1, n // 2 + 1):
        if ids[p] == first and n % p == 0 and ids[p:] == ids[:-p]:
            return p
    return n


def _code_period(code) -> int:
    """:func:`_body_period` directly over the instruction list: the slice
    compare runs at C speed with CPython's identity short-circuit (the
    engine's ``body * n`` unrollings share objects), and a content-equal
    fallback is harmless — recipes key on content.  This runs per sequence
    on the wave hot path, ahead of every lowering-cache probe."""
    n = len(code)
    if n < 2:
        return n
    first = code[0]
    for p in range(1, n // 2 + 1):
        if code[p] is first and n % p == 0 and code[p:] == code[:-p]:
            return p
    return n


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def _bucket(n: int, lo: int) -> int:
    """Smallest value >= n of the form ``lo * 2**k`` or ``1.5 * lo * 2**k``
    (quarter-octave shape buckets: at most ~33% padding, O(log n) distinct
    buckets, so the reused packing buffers come in few shapes)."""
    b = lo
    while b < n:
        h = b + b // 2
        if h >= n:
            return h
        b *= 2
    return b


class _ChunkPack:
    """One packed chunk: bucket-shaped input tensors + extraction metadata.

    ``vis``/``valid`` live alongside the kernel inputs; only they (and the
    scatter targets) are re-zeroed when a device buffer set is reused —
    every other cell of a reused buffer is gated off by ``valid`` in the
    kernels, so stale data cannot perturb results."""
    __slots__ = ("chunk", "lane_progs", "S", "E", "R", "issue", "mask",
                 "lat", "blk", "valid", "prod", "delta", "vis")

    def __init__(self, chunk, lane_progs, S, E, R, issue, mask, lat, blk,
                 valid, prod, delta, vis):
        self.chunk = chunk
        self.lane_progs = lane_progs
        self.S = S
        self.E = E
        self.R = R
        self.issue = issue
        self.mask = mask
        self.lat = lat
        self.blk = blk
        self.valid = valid
        self.prod = prod
        self.delta = delta
        self.vis = vis


class BatchSimMachine:
    """Measurable black box executing waves of sequences as array programs.

    Same observable contract as :class:`~repro_torch.core.simulator.SimMachine`
    (cycles + per-port μop counts, including harness overhead), plus
    :meth:`run_batch` — and bit-identical results to the scalar oracle on
    both backends.  ``backend="cuda"`` needs a CUDA ``device`` and a card;
    asking for it without one raises.  ``backend="torch"`` runs on any
    ``device``."""

    counters_available = True

    def __init__(self, uarch: UArch, isa: ISA, backend: str = "cuda",
                 device="cuda", table_index: UopTableIndex | None = None,
                 min_lanes: int = DEFAULT_MIN_LANES,
                 lower_cache_entries: int | None = DEFAULT_LOWER_CACHE):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        device = torch.device(device)
        if backend == "cuda":
            if device.type != "cuda":
                raise ValueError(f"the cuda backend runs on a CUDA device, "
                                 f"not {device}")
            if not torch.cuda.is_available():
                raise RuntimeError("cuda backend requested but no CUDA "
                                   "device is available")
        self.uarch = uarch
        self.isa = isa
        self.name = uarch.name
        self.ports = uarch.ports
        self.backend = backend
        self.device = device
        # a padded chunk with fewer lanes than this runs on the scalar
        # oracle instead (results are bit-identical either way; set 1 to
        # force the kernel)
        self.min_lanes = min_lanes
        self._comp: CompiledUArch = compile_uarch(uarch, isa, table_index)
        self._cells: dict = {}          # register name -> cell id
        self._recipes_by_key: dict = {}
        self._scalar = None             # lazy scalar oracle for thin chunks
        # lowering cache: (body content key, unroll count) -> _Prog (LRU)
        self._lower_cache: dict = {}
        self._lower_max = lower_cache_entries
        self.lowering_stats = {"hits": 0, "misses": 0, "evictions": 0}
        self._device = None             # lazy _DeviceExec
        # a list to append every launch's device inputs to (the argument
        # tuple of each kernel call, as launched), or None to keep nothing
        self.launched_args: list | None = None
        # guards the machine's shared mutable host state (lowering-cache
        # LRU, recipe memo, lazy device/scalar init) across concurrent
        # run_batch callers; slot leasing has its own lock in _DeviceExec
        self._host_lock = threading.Lock()

    # ------------------------------------------------------------------
    def run(self, code) -> Counters:
        return self.run_batch([code])[0]

    def set_devices(self, devices) -> None:
        """Adopt a campaign placement (a sequence of devices, see
        :func:`repro_torch.core.device_mesh.partition`).  One device per
        machine: the machine moves to the group's first device when it is
        of the machine's own device type, so a machine built for the CPU
        stays on the CPU.  Results are bit-identical for every placement."""
        devs = tuple(torch.device(d) for d in devices or ())
        if not devs or devs[0].type != self.device.type:
            return
        with self._host_lock:
            if devs[0] != self.device:
                self.device = devs[0]
                self._device = None

    def device_stats(self) -> dict:
        """Device-kernel telemetry: kernel library loads (``compiles``),
        kernel calls, the shape buckets seen so far, the device, and the
        same counters per device (``per_device``, keyed by device name).
        Empty until the first chunk reaches the device."""
        if self._device is None:
            return {}
        return self._device.stats()

    def degraded_stats(self) -> dict:
        """Per-transition backend degradation counters, for the engine's
        stats protocol.  Always empty: the port has no degradation chain,
        a failing kernel raises."""
        return {}

    def run_batch(self, codes, kernel_lock=None) -> list:
        """Execute each sequence once; one :class:`Counters` per sequence,
        in submission order.

        ``kernel_lock`` (optional ``threading.Lock``) serializes the
        scalar-oracle path for thin chunks, which is GIL-bound; host
        lowering and packing always run outside it, and device dispatch
        serializes on the executor's per-device lock
        (:func:`repro_torch.core.device_mesh.dispatch_lock`) instead.

        Concurrent ``run_batch`` calls on one machine instance are safe —
        the lowering cache/recipe memo and the device buffer-slot leasing
        are mutex-guarded.

        With tracing on (``REPRO_TRACE=1``, see :mod:`repro_torch.obs`)
        each wave emits a ``wave.run_batch`` span with per-phase children
        (``wave.lower`` / ``wave.pack`` / ``wave.dispatch`` /
        ``wave.kernel`` / ``wave.result_wait`` / ``wave.extract``)."""
        with obs.span("wave.run_batch", lanes=len(codes),
                      backend=self.backend):
            return self._run_batch(codes, kernel_lock)

    def _run_batch(self, codes, kernel_lock=None) -> list:
        codes = [list(c) for c in codes]
        out: list = [None] * len(codes)
        batched, thin = self._chunks(codes)
        if thin:
            self._chunk_scalar(thin, codes, out, kernel_lock)
        if batched:
            progs = self._lower_wave(codes, batched)
            self._run_device(batched, codes, progs, out)
        return out

    def _chunks(self, codes) -> tuple:
        """``(batched chunks, thin lane indices)`` of a wave: chunk by
        similar length so short sequences don't pay for the longest
        experiment's padded steps; chunks thinner than ``min_lanes`` go to
        the scalar oracle."""
        order = sorted(range(len(codes)), key=lambda i: -len(codes[i]))
        chunks: list = []
        chunk: list = []
        chunk_max = 0
        for i in order:
            if chunk and len(codes[i]) * 4 < chunk_max:
                chunks.append(chunk)
                chunk, chunk_max = [], 0
            if not chunk:
                chunk_max = max(len(codes[i]), 1)
            chunk.append(i)
        if chunk:
            chunks.append(chunk)
        batched = [c for c in chunks if len(c) >= self.min_lanes]
        thin = [i for c in chunks if len(c) < self.min_lanes for i in c]
        return batched, thin

    def _ensure_scalar(self):
        with self._host_lock:
            if self._scalar is None:
                from repro_torch.core.simulator import (  # noqa: PLC0415
                    SimMachine)
                self._scalar = SimMachine(self.uarch, self.isa)
            return self._scalar

    def _chunk_scalar(self, idxs, codes, out, kernel_lock) -> None:
        """Run ``idxs`` on the scalar oracle — the thin-chunk path."""
        sim = self._ensure_scalar()
        # wait_lock(None) degrades to a no-op, so both lock topologies
        # share one code path; acquisition wait is traced separately
        with obs.span("wave.scalar", thin=len(idxs)), \
                obs.wait_lock(kernel_lock, "wave.lock_wait"):
            if faults.active():
                faults.check_wave("wave.kernel",
                                  [_fault_key(codes[i]) for i in idxs],
                                  backend="scalar")
            for i in idxs:
                out[i] = sim.run(codes[i])

    # ------------------------------------------------------------------
    # lowering cache: content-addressed _Prog tensors
    # ------------------------------------------------------------------
    def _lower_wave(self, codes, batched) -> dict:
        """Lower every batched sequence, serving repeat bodies from the
        content-addressed lowering cache.  Sequences sharing one body
        (Algorithm 2 submits the same body at two unroll counts) lower the
        longest *missing* count once; shorter unrollings are prefix views
        of the same tensors (causality).  Holds the machine's host lock:
        the cache LRU (pop/reinsert/evict) and the recipe memo are shared
        mutable state across concurrent ``run_batch`` callers.  Traced as
        a ``wave.lower`` span carrying this wave's cache hit/miss delta."""
        stats = self.lowering_stats
        h0, m0 = stats["hits"], stats["misses"]
        with obs.span("wave.lower",
                      lanes=sum(len(c) for c in batched)) as sp, \
                self._host_lock:
            progs = self._lower_wave_locked(codes, batched)
            sp.set(hits=stats["hits"] - h0, misses=stats["misses"] - m0)
        return progs

    def _lower_wave_locked(self, codes, batched) -> dict:
        by_id: dict = {}
        groups: dict = {}
        for c in batched:
            for i in c:
                code = codes[i]
                if code:
                    p = _code_period(code)
                    body_ck = tuple(self._recipe(ins, by_id).ckey
                                    for ins in code[:p])
                    key = (p, body_ck)
                    nc = len(code) // p
                else:
                    key, nc = (0, ()), 0
                groups.setdefault(key, []).append((i, nc))
        progs: dict = {}
        cache = self._lower_cache
        stats = self.lowering_stats
        for (p, body_ck), members in groups.items():
            cuts = sorted({nc for _, nc in members})
            have: dict = {}
            missing: list = []
            for nc in cuts:
                hit = cache.pop((body_ck, nc), None)   # pop: LRU touch
                if hit is None:
                    missing.append(nc)
                else:
                    have[nc] = hit
            stats["hits"] += len(have)
            if missing:
                stats["misses"] += len(missing)
                rep_i = max(members, key=lambda t: t[1])[0]
                rep_code = codes[rep_i][:p * missing[-1]]
                made = self._lower(rep_code, by_id, missing, p)
                for nc in missing:
                    have[nc] = made[nc]
            for nc in cuts:                            # reinsert as newest
                cache[(body_ck, nc)] = have[nc]
            if self._lower_max is not None:
                while len(cache) > self._lower_max:
                    cache.pop(next(iter(cache)))       # oldest entry
                    stats["evictions"] += 1
            for i, nc in members:
                progs[i] = have[nc]
        return progs

    # ------------------------------------------------------------------
    # recipes: per concrete instruction instance, content-memoized
    # ------------------------------------------------------------------
    def _cell(self, name: str) -> int:
        c = self._cells.get(name)
        if c is None:
            c = self._cells[name] = len(self._cells)
        return c

    def _recipe(self, ins, by_id: dict) -> _Recipe:
        r = by_id.get(id(ins))
        if r is None:
            key = (ins.spec, tuple(sorted(ins.regs.items())), ins.value_hint)
            r = self._recipes_by_key.get(key)
            if r is None:
                r = self._build_recipe(ins)
                r.ckey = key
                self._recipes_by_key[key] = r
            by_id[id(ins)] = r
        return r

    def _build_recipe(self, ins) -> _Recipe:
        comp = self._comp
        idx = comp.index.idx[ins.spec]       # KeyError like isa[...]
        info = comp.index.specs[idx]
        if not comp.flags[idx] & F_PRESENT:  # KeyError like ua.behaviors[..]
            raise KeyError(ins.spec)
        regs = dict(ins.regs)
        for nm, ot in zip(info.op_names, info.op_otype):
            if nm not in regs and ot != IMM:
                regs[nm] = _implicit_reg(nm, ot)
        same = (len(info.same_reg_ops) >= 2
                and len({regs[n] for n in info.same_reg_ops}) == 1)
        use_sr = same and bool(comp.flags[idx] & F_HAS_SR)
        zero_nouop = bool(comp.sr_zero_nouop[idx] if use_sr
                          else comp.zero_nouop[idx])
        elim_period = int(comp.sr_elim_period[idx] if use_sr
                          else comp.elim_period[idx])
        div_extra = int(comp.sr_divider_extra[idx] if use_sr
                        else comp.divider_extra[idx])
        zero = info.zero_idiom and same
        if zero and zero_nouop:
            return _Recipe(_K_ZERO_NOUOP, 0, dest_cells=tuple(
                self._cell(regs[d]) for d in info.dest_names))
        off, cnt = comp.behavior_rows(idx, same)
        extra = div_extra if (ins.value_hint == "high" and not zero) else 0
        vis = 0 if zero else 1
        ignore_reads = zero
        snapshot = tuple((self._cell(regs.get(nm, nm)), chk, w)
                         for nm, chk, w in info.snapshot)
        snap_pos = {nm: i for i, (nm, _, _) in enumerate(info.snapshot)}
        syms = comp.syms[idx]
        plans = []
        issue_off = 0
        for j in range(cnt):
            row = off + j
            if comp.port_mask[row] == 0:   # 0-port μop: scalar skips it
                continue
            names = []
            for slot in comp.reads[row]:
                if slot < 0:
                    break
                names.append(info.op_names[slot] if slot < TEMP_BASE
                             else syms[slot - TEMP_BASE])
            prods = []
            if not ignore_reads:
                for nm in names:
                    if nm.startswith("%"):
                        prods.append((_P_TMP, nm))
                    elif nm in info.mem_read and info.mem_read[nm]:
                        prods.append((_P_MEM, self._cell(regs[nm])))
                    elif nm in snap_pos:
                        prods.append((_P_SNAP, snap_pos[nm]))
                    else:
                        prods.append((_P_CUR,
                                      self._cell(regs.get(nm, nm))))
            sf = any(nm in info.mem_read and info.mem_read[nm]
                     for nm in names)
            sf_cell = next((self._cell(regs[nm]) for nm in names
                            if nm in info.mem_read), -1)
            writes = []
            for slot in comp.writes[row]:
                if slot < 0:
                    break
                nm = (info.op_names[slot] if slot < TEMP_BASE
                      else syms[slot - TEMP_BASE])
                if nm.startswith("%"):
                    writes.append((_W_TMP, nm, None))
                elif nm in info.mem_read:
                    writes.append((_W_MEM, self._cell(regs[nm]), None))
                else:
                    try:
                        w = info.op_width[info.op_names.index(nm)]
                    except ValueError:
                        w = None
                    writes.append((_W_CELL, self._cell(regs.get(nm, nm)), w))
            occ = int(comp.occupancy[row]) + extra
            plans.append(_Plan(int(comp.mask_id[row]),
                               int(comp.latency[row]) + extra,
                               occ if occ > 1 else 1, vis, tuple(prods),
                               sf, sf_cell, tuple(writes), issue_off))
            issue_off += 1
        if info.may_eliminate and elim_period and not zero:
            return _Recipe(_K_ELIM, cnt, snapshot, tuple(plans),
                           period=elim_period, ekey=ins.spec,
                           src_cell=self._cell(regs[info.elim_src]),
                           dst_cell=self._cell(regs[info.dest_names[0]]))
        return _Recipe(_K_NORMAL, cnt, snapshot, tuple(plans))

    # ------------------------------------------------------------------
    # lowering: sequence -> flat tensors (with periodic-steady-state tiling)
    # ------------------------------------------------------------------
    def _lower(self, code, by_id: dict, cuts=None, period=None) -> dict:
        """Lower ``code`` (= body * ncopies) and materialize one
        :class:`_Prog` per requested copy count in ``cuts`` — shorter
        counts are prefix views of the full tensors."""
        comp = self._comp
        width = comp.issue_width
        penalty = comp.partial_stall_penalty
        sfl = comp.store_forward_latency
        n = len(code)
        p = period if period is not None else (
            _body_period([id(x) for x in code]) if n else 0)
        ncopies = n // p if p else 0
        if cuts is None:
            cuts = [ncopies]
        body = [self._recipe(ins, by_id) for ins in code[:p]]

        lw: dict = {}       # cell -> producing row
        wd: dict = {}       # cell -> width of last write
        ml: dict = {}       # mem cell -> producing (store) row
        ms: set = set()     # mem cells with a store seen
        ec: dict = {}       # elim spec key -> instance count
        ecp: dict = {}      # elim spec key -> period
        issue_l: list = []
        mask_l: list = []
        lat_l: list = []
        blk_l: list = []
        vis_l: list = []
        prods_l: list = []
        uop_counter = 0

        sig_map: dict = {}
        snaps: list = []    # per copy boundary: (rows, uops, lw, ml)
        tile = None

        def signature():
            nr = len(issue_l)
            return (uop_counter % width,
                    tuple(sorted((c, nr - r) for c, r in lw.items())),
                    tuple(sorted(wd.items())),
                    tuple(sorted((c, nr - r) for c, r in ml.items())),
                    tuple(sorted(ms)),
                    tuple(sorted((k, c % ecp[k]) for k, c in ec.items())))

        for i in range(ncopies):
            if ncopies > 1:
                sig = signature()
                c0 = sig_map.get(sig)
                if c0 is not None:
                    tile = (c0, i)
                    snaps.append((len(issue_l), uop_counter, dict(lw),
                                  dict(ml)))
                    break
                sig_map[sig] = i
            snaps.append((len(issue_l), uop_counter, dict(lw), dict(ml)))
            for r in body:
                k = r.kind
                if k == _K_ZERO_NOUOP:
                    for c in r.dest_cells:
                        lw.pop(c, None)
                    continue
                if k == _K_ELIM:
                    c = ec.get(r.ekey, 0)
                    ec[r.ekey] = c + 1
                    ecp[r.ekey] = r.period
                    if c % r.period:
                        s = lw.get(r.src_cell, -1)
                        if s < 0:
                            lw.pop(r.dst_cell, None)
                        else:
                            lw[r.dst_cell] = s
                        continue
                svals = [(lw.get(cell, -1),
                          penalty if (chk and w > wd.get(cell, 64)) else 0)
                         for cell, chk, w in r.snapshot]
                tmp: dict = {}
                for pl in r.plans:
                    row = len(issue_l)
                    prow = []
                    for kind, a in pl.prods:
                        if kind == _P_SNAP:
                            prow.append(svals[a])
                        elif kind == _P_TMP:
                            prow.append((tmp.get(a, -1), 0))
                        elif kind == _P_CUR:
                            prow.append((lw.get(a, -1), 0))
                        else:   # _P_MEM: reg base + memory value
                            prow.append((lw.get(a, -1), 0))
                            prow.append((ml.get(a, -1), 0))
                    lat = pl.lat
                    if pl.sf and pl.sf_cell in ms:
                        lat = min(lat, sfl)
                    issue_l.append((uop_counter + pl.issue_off) // width)
                    mask_l.append(pl.mask_id)
                    lat_l.append(lat)
                    blk_l.append(pl.blk)
                    vis_l.append(pl.vis)
                    prods_l.append(prow)
                    for wk, a, b in pl.writes:
                        if wk == _W_TMP:
                            tmp[a] = row
                        elif wk == _W_MEM:
                            ml[a] = row
                            ms.add(a)
                        else:
                            lw[a] = row
                            if b is not None:
                                wd[a] = b
                uop_counter += r.advance
        else:
            snaps.append((len(issue_l), uop_counter, dict(lw), dict(ml)))

        # native part -> arrays
        n_nat = len(issue_l)
        max_r = max((len(pr) for pr in prods_l), default=0)
        max_r = max(max_r, 1)
        issue = np.array(issue_l, np.int64) if n_nat else np.zeros(0, np.int64)
        mask = np.array(mask_l, np.int64) if n_nat else np.zeros(0, np.int64)
        lat = np.array(lat_l, np.int64) if n_nat else np.zeros(0, np.int64)
        blk = np.array(blk_l, np.int64) if n_nat else np.zeros(0, np.int64)
        vis = np.array(vis_l, np.int64) if n_nat else np.zeros(0, np.int64)
        prod = np.full((n_nat, max_r), -1, np.int64)
        delta = np.zeros((n_nat, max_r), np.int64)
        for j, pr in enumerate(prods_l):
            for kk, (pp, dd) in enumerate(pr):
                prod[j, kk] = pp
                delta[j, kk] = dd

        if tile is None:
            parts = [(issue, mask, lat, blk, vis, prod, delta)]
        else:
            c0, c1 = tile
            s0, u0 = snaps[c0][0], snaps[c0][1]
            s1, u1 = n_nat, uop_counter
            d_rows, d_uops = s1 - s0, u1 - u0
            assert d_uops % width == 0
            d_issue = d_uops // width
            per = c1 - c0
            rem = ncopies - c1
            full, left = divmod(rem, per)
            parts = [(issue, mask, lat, blk, vis, prod, delta)]
            if full:
                # all full periods in one broadcast: segment + q * shift
                q = np.arange(1, full + 1, dtype=np.int64)
                sl = slice(s0, s1)
                seg_p = prod[sl]
                pt = np.where(seg_p[None] >= 0,
                              seg_p[None] + (q * d_rows)[:, None, None], -1)
                parts.append((
                    (issue[sl][None] + (q * d_issue)[:, None]).reshape(-1),
                    np.tile(mask[sl], full), np.tile(lat[sl], full),
                    np.tile(blk[sl], full), np.tile(vis[sl], full),
                    pt.reshape(-1, max_r),
                    np.tile(delta[sl], (full, 1))))
            if left:
                sl = slice(s0, snaps[c0 + left][0])
                pr = prod[sl]
                qq = full + 1
                parts.append((issue[sl] + qq * d_issue, mask[sl], lat[sl],
                              blk[sl], vis[sl],
                              np.where(pr >= 0, pr + qq * d_rows, -1),
                              delta[sl]))
        if len(parts) > 1:
            issue = np.concatenate([x[0] for x in parts])
            mask = np.concatenate([x[1] for x in parts])
            lat = np.concatenate([x[2] for x in parts])
            blk = np.concatenate([x[3] for x in parts])
            vis = np.concatenate([x[4] for x in parts])
            prod = np.concatenate([x[5] for x in parts])
            delta = np.concatenate([x[6] for x in parts])
        # cached tensors are int32: every simulated quantity fits (cycles,
        # rows, counts < 2^31 - 1 — the device kernels reserve INT32_MAX
        # as the disallowed-port dispatch sentinel) and run int32 natively
        issue = issue.astype(np.int32)
        mask = mask.astype(np.int32)
        lat = lat.astype(np.int32)
        blk = blk.astype(np.int32)
        vis = vis.astype(np.int32)
        prod = prod.astype(np.int32)
        delta = delta.astype(np.int32)

        def boundary(b):
            """(rows, row shift, reg cells, mem cells) after ``b`` copies."""
            if tile is None or b <= tile[1]:
                rows_b, _, lwb, mlb = snaps[b]
                return rows_b, 0, lwb, mlb
            qb, rb = divmod(b - c0, per)
            rows_b = s0 + qb * d_rows + (snaps[c0 + rb][0] - s0)
            return rows_b, qb * d_rows, snaps[c0 + rb][2], snaps[c0 + rb][3]

        made: dict = {}
        for b in cuts:
            rows_b, sh, lwb, mlb = boundary(b)
            fin = sorted({r + sh for r in lwb.values()}
                         | {r + sh for r in mlb.values()})
            made[b] = _Prog(rows_b, issue[:rows_b], mask[:rows_b],
                            lat[:rows_b], blk[:rows_b], vis[:rows_b],
                            prod[:rows_b], delta[:rows_b],
                            np.array(fin, np.int64), max_r)
        return made

    # ------------------------------------------------------------------
    # packing: chunk -> bucket tensors
    # ------------------------------------------------------------------
    def _pack_chunk(self, chunk, progs, bufs) -> _ChunkPack:
        """Pack a chunk's lowered programs into a reused bucket buffer set
        in *lane-major* ``(E, S)`` layout: one contiguous slice copy per
        lane per tensor, every write on consecutive addresses; the device
        transposes once.  Only ``valid`` and ``vis`` are re-zeroed on
        reuse; every other stale cell is gated off by ``valid`` in the
        kernels, except the producer columns past a lane's own read width,
        which are re-filled here."""
        E0 = len(chunk)
        gs = [progs[i] for i in chunk]
        S0 = max(g.n_rows for g in gs)
        R0 = max(g.max_r for g in gs)
        issue, mask, lat, blk, valid, prod, delta, vis = bufs
        R = prod.shape[2]
        valid[:] = False
        vis[:] = 0
        pk = _ChunkPack(chunk, gs, S0, E0, R0, issue, mask, lat, blk,
                        valid, prod, delta, vis)
        for e, g in enumerate(gs):
            m = g.n_rows
            if not m:
                continue
            issue[e, :m] = g.issue
            mask[e, :m] = g.mask
            lat[e, :m] = g.lat
            blk[e, :m] = g.blk
            valid[e, :m] = True
            vis[e, :m] = g.vis
            r = g.max_r
            prod[e, :m, :r] = g.prod
            delta[e, :m, :r] = g.delta
            if r < R:
                # the kernels read ALL R producer columns of a valid
                # row — stale values from a previous occupant of this
                # reused buffer are only row-gated, never column-gated
                prod[e, :m, r:] = -1
                delta[e, :m, r:] = 0
        return pk

    # ------------------------------------------------------------------
    # extraction: kernel outputs -> Counters (one gather per wave)
    # ------------------------------------------------------------------
    def _fill_empty(self, chunk, out) -> None:
        overhead = self._comp.overhead_cycles
        for i in chunk:
            out[i] = Counters(float(overhead),
                              {p: 0 for p in self.uarch.ports})

    def _extract(self, pk: _ChunkPack, done, counts, out) -> None:
        """Batched Counters extraction: per-lane end times via one masked
        max + one scatter-max over final-writer rows, port counts via one
        ``tolist`` gather.  ``done`` is lane-major ``(E, S)`` (the device
        path hands in a transposed view of the kernel's output)."""
        comp = self._comp
        E0, S0 = pk.E, pk.S
        core = (done[:E0, :S0] * pk.vis[:E0, :S0]).max(axis=1)
        fins = [(e, g.finals) for e, g in enumerate(pk.lane_progs)
                if g.finals.size]
        if fins:
            lanes = np.concatenate(
                [np.full(f.size, e, np.int64) for e, f in fins])
            rows = np.concatenate([f for _, f in fins])
            np.maximum.at(core, lanes, done[lanes, rows])
        overhead = comp.overhead_cycles
        ports = list(self.uarch.ports)
        perm = [comp.port_pos[p] for p in ports]
        cnt = counts[:E0][:, perm].tolist()
        for e, i in enumerate(pk.chunk):
            out[i] = Counters(float(int(core[e]) + overhead),
                              dict(zip(ports, cnt[e])))

    # ------------------------------------------------------------------
    # device execution
    # ------------------------------------------------------------------
    def _device_exec(self) -> "_DeviceExec":
        """Lazy device executor (``set_devices`` drops it for rebuild)."""
        with self._host_lock:
            if self._device is None:
                self._device = _DeviceExec(self._comp, self.backend,
                                           self.device)
            return self._device

    def _pack_leased(self, dev, c, progs) -> tuple:
        """Lease a bucket slot for chunk ``c`` and pack the chunk into it;
        returns ``(pack, slot)``.  The slot is released here only if
        packing fails."""
        S0 = max(progs[i].n_rows for i in c)
        R0 = max(max(progs[i].max_r for i in c), 1)
        slot = dev.acquire(S0, len(c), R0)
        try:
            return self._pack_chunk(c, progs, slot.bufs), slot
        except BaseException:
            slot.release()
            raise

    def _run_device(self, batched, codes, progs, out) -> None:
        """Pipelined device execution: chunk k's kernel is launched
        (asynchronously on a CUDA device) before chunk k+1 is packed on the
        host, and chunk k's results are copied back and extracted after
        that.  A bucket slot stays leased until its chunk's results have
        been *extracted*: extraction reads the slot's ``vis`` plane."""
        dev = self._device_exec()
        pending: deque = deque()        # (pack, slot, launched) in flight
        try:
            for c in batched:
                if max(progs[i].n_rows for i in c) == 0:
                    self._fill_empty(c, out)   # all-zero-μop programs
                    continue
                if faults.active():
                    faults.check_wave("wave.kernel",
                                      [_fault_key(codes[i]) for i in c],
                                      backend=self.backend)
                with obs.span("wave.pack", lanes=len(c)):
                    if faults.active():
                        faults.check("wave.pack", backend=self.backend)
                    pk, slot = self._pack_leased(dev, c, progs)
                try:
                    with obs.span("wave.dispatch", lanes=len(c)):
                        launched = dev.dispatch(pk, self.launched_args)
                except BaseException:
                    slot.release()
                    raise
                pending.append((pk, slot, launched))
                while len(pending) > 1:
                    self._finalize_device(*pending.popleft(), out)
            while pending:
                self._finalize_device(*pending.popleft(), out)
        except BaseException:
            # slots must not stay leased forever after a failure
            while pending:
                pending.popleft()[1].release()
            raise

    def _finalize_device(self, pk, slot, launched, out) -> None:
        try:
            # result_wait is kernel flight plus the copy back (device time
            # the host spends blocked on), extract is host gather work
            with obs.span("wave.result_wait", lanes=pk.E):
                done, counts = launched.result()
            with obs.span("wave.extract", lanes=pk.E):
                self._extract(pk, done.T, counts, out)
        finally:
            # only now is the slot reusable: _extract read pk.vis, which
            # aliases the slot's vis buffer
            slot.release()


class _DeviceExec:
    """Per-machine device execution state: the device-resident μop mask
    LUT, the per-device dispatch lock, telemetry, and recycled per-bucket
    packing-buffer slots whose lease lasts until their chunk's results are
    extracted."""

    _BUCKETS_MAX = 8     # bucket slot-ring pool bound (LRU)

    def __init__(self, comp: CompiledUArch, kind: str, device):
        self.comp = comp
        self.kind = kind
        self.device = torch.device(device)
        self.key = device_key(self.device)
        self.lut = comp.device_mask_table(self.device)
        self.dispatch_lock = dispatch_lock((self.device,))
        self.compiles = 0
        self.kernel_calls = 0
        self.buckets: set = set()
        self.lanes = 0
        self._lock = threading.Lock()   # guards slot leasing / ring LRU
        self._rings: dict = {}   # bucket -> slot list (LRU by bucket)

    def stats(self) -> dict:
        return {"backend": self.kind, "compiles": self.compiles,
                "kernel_calls": self.kernel_calls,
                "buckets": sorted(self.buckets),
                "mesh": False,
                "devices": [self.key],
                "per_device": {self.key: {
                    "compiles": self.compiles,
                    "kernel_calls": self.kernel_calls,
                    "lanes": self.lanes,
                    "buckets": sorted(self.buckets)}}}

    # -- buckets / buffer slots ----------------------------------------
    @staticmethod
    def bucket_shape(S0: int, E0: int, R0: int) -> tuple:
        return (_bucket(S0, 32), _bucket(E0, 8), _next_pow2(R0))

    def acquire(self, S0: int, E0: int, R0: int) -> "_BufSlot":
        """Lease a packing-buffer slot for one chunk.  A slot stays leased
        from here until :meth:`~_BufSlot.release` in ``_finalize_device``
        — through packing, kernel flight and extraction.  If every slot of
        the bucket is leased a new one is allocated: live slots are bounded
        by the pipeline depth.  Mutex-guarded so concurrent ``run_batch``
        callers can never double-lease a slot."""
        shape = self.bucket_shape(S0, E0, R0)
        with self._lock:
            ring = self._rings.get(shape)
            if ring is None:
                while len(self._rings) >= self._BUCKETS_MAX:
                    self._rings.pop(next(iter(self._rings)))
                ring = self._rings[shape] = []
            else:
                self._rings[shape] = self._rings.pop(shape)   # LRU touch
            for slot in ring:   # a released slot has been fully extracted
                if not slot.leased:
                    slot.leased = True
                    return slot
            slot = _BufSlot(self._alloc(*shape))
            ring.append(slot)
            slot.leased = True
            return slot

    @staticmethod
    def _alloc(S, E, R):
        return (np.zeros((E, S), np.int32), np.zeros((E, S), np.int32),
                np.zeros((E, S), np.int32), np.zeros((E, S), np.int32),
                np.zeros((E, S), bool), np.full((E, S, R), -1, np.int32),
                np.zeros((E, S, R), np.int32), np.zeros((E, S), np.int32))

    # -- dispatch -------------------------------------------------------
    def upload(self, pk: _ChunkPack) -> tuple:
        """The chunk's kernel inputs on the device, in the kernel's
        row-major ``(S, E)`` / ``(S, E, R)`` layout: one blocking copy per
        buffer (the host buffer is free for reuse once it returns), one
        transpose on the device into fresh tensors that no later chunk
        overwrites."""
        def up(a):
            t = torch.from_numpy(a).to(self.device)
            return t.transpose(0, 1).contiguous()
        return (up(pk.issue), up(pk.mask), up(pk.lat), up(pk.blk),
                up(pk.valid), up(pk.prod), up(pk.delta), self.lut)

    def dispatch(self, pk: _ChunkPack, record: list | None = None
                 ) -> "_Launched":
        """Upload one packed chunk and launch its kernel call; the returned
        :class:`_Launched` copies ``(done, counts)`` back to the host on
        ``result()``.  The launch's argument tuple is appended to
        ``record`` when one is given.  Holds the executor's per-device
        lock, so machines sharing the device serialize their launches and
        machines on other devices do not."""
        if faults.active():
            faults.check("device.dispatch", backend=self.kind)
        if self.kind == "cuda":
            _, loaded_now = wd.LIBRARY.load()
            if loaded_now:
                self.compiles += 1
            run = wd.wave_dispatch
        else:
            run = wd.wave_dispatch_ref
        E, S = pk.issue.shape
        R = pk.prod.shape[2]
        with obs.wait_lock(self.dispatch_lock, "wave.dispatch_lock_wait"):
            args = self.upload(pk)
            with obs.span("wave.kernel", track=f"device:{self.key}",
                          lanes=pk.E, steps=S):
                done, counts = run(*args)
        if record is not None:
            record.append(args)
        self.buckets.add((S, E, R))
        self.kernel_calls += 1
        self.lanes += pk.E
        return _Launched(done, counts)


class _Launched:
    """One launched chunk: its outputs on the device, copied to the host
    (blocking until the kernel has finished) by :meth:`result`."""
    __slots__ = ("done", "counts")

    def __init__(self, done, counts):
        self.done = done
        self.counts = counts

    def result(self):
        return self.done.cpu().numpy(), self.counts.cpu().numpy()


class _BufSlot:
    """One recycled packing-buffer set.  ``leased`` is True from
    ``_DeviceExec.acquire`` until :meth:`release` after the chunk's
    results are *extracted* — extraction reads the slot's ``vis`` plane
    through the :class:`_ChunkPack` views."""
    __slots__ = ("bufs", "leased")

    def __init__(self, bufs):
        self.bufs = bufs
        self.leased = False

    def release(self) -> None:
        self.leased = False
