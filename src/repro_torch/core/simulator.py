"""Cycle-level simulated core with per-port μop performance counters.

This plays the role the physical processors play in the paper: a black box
that executes instruction sequences and exposes exactly two observables —
elapsed core cycles and the number of μops executed on each port (§3.3).
The inference algorithms (blocking/port_usage/latency/throughput) only ever
call :meth:`SimMachine.run`; the ground-truth tables in ``uarch.py`` stay
hidden from them, and property tests check the algorithms recover them.

Machine model (§3.1): μops issue in program order at ``issue_width``/cycle
into a scheduler; each dispatches to one allowed port no earlier than (a) its
operands are ready, (b) its issue cycle, (c) the port has a free slot (ports
accept one μop per cycle; divider μops occupy their port for ``occupancy``
cycles — not fully pipelined). Port choice is earliest-available, tie-broken
by least cumulative load (this reproduces the uniform port distribution that
isolation measurements show, including the MOVQ2DQ fallacy of §7.3.3).
Register renaming is implicit (dependencies are tracked through architectural
names per the benchmark's operand assignment). The reorder buffer's special
handling is modeled: move elimination (periodically failing, as the paper
observed: ~1/3 of chained MOVs execute), zero idioms, NOPs.

The run includes a fixed measurement-harness overhead (serializing
instructions + counter reads, Algorithm 2), which the measurement protocol
in ``machine.py`` must cancel via the n=10/110 differencing — faithfully
reproducing why the paper needs that protocol at all.

``SimMachine`` is the *scalar reference oracle*: ``run`` interprets one μop
per Python iteration and is the semantics every backend must match.  The
hot path, however, is ``run_batch`` — the measurement engine submits whole
waves of experiments, and ``run_batch`` forwards them to the compiled
:class:`~repro_torch.core.batch_sim.BatchSimMachine`, which executes the wave as
one kernel call per chunk, bit-identical to this oracle (differential
tests in ``tests/test_torch_batch_sim.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.isa import FLAGS, GPR, IMM, ISA, MEM, InstrSpec
from repro_torch.core.uarch import InstrBehavior, UArch


@dataclass(frozen=True)
class Instr:
    """An instruction instance: spec name + concrete operand assignment.

    ``regs`` maps operand name -> architectural register name ("R0".."R31",
    "X0".."X31", "FLAGS", memory base register for mem operands).
    ``value_hint`` ("low"/"high") selects divider operand classes (§5.2.5) —
    the stand-in for actually loading those values into registers."""
    spec: str
    regs: dict
    value_hint: str = "low"

    def __repr__(self):  # compact debug form
        rs = ",".join(f"{k}={v}" for k, v in self.regs.items())
        return f"{self.spec}({rs})"


@dataclass
class Counters:
    cycles: float
    port_uops: dict = field(default_factory=dict)

    @property
    def total_uops(self) -> float:
        return sum(self.port_uops.values())


def _implicit_reg(opname: str, otype: str) -> str:
    if otype == FLAGS:
        return "FLAGS"
    return {"hi": "RDX", "op1": "RAX"}.get(opname, "R_IMPL_" + opname)


class SimMachine:
    """The measurable black box.

    ``backend`` selects the batched wave-execution kernel (``cuda`` or
    ``torch``; default: the ``REPRO_SIM_BACKEND`` environment variable,
    else ``cuda``).  ``device`` places it on one device; ``devices`` (an
    integer count, ``"all"``, device names or a sequence of devices; see
    :mod:`repro_torch.core.device_mesh`) on several, splitting every wide
    enough chunk into per-device lane blocks; with neither the placement
    is ``REPRO_SIM_DEVICES``, else every card.  Giving both raises.
    Results are bit-identical on every backend and placement.  A backend
    that cannot run (``cuda`` without a card) raises from
    :meth:`run_batch`; it is never replaced by another.  ``min_lanes`` is
    the thin-chunk scalar-oracle crossover forwarded to
    :class:`~repro_torch.core.batch_sim.BatchSimMachine`."""

    counters_available = True

    def __init__(self, uarch: UArch, isa: ISA, backend: str | None = None,
                 min_lanes: int | None = None, device=None, devices=None):
        if device is not None and devices is not None:
            raise ValueError("give device= or devices=, not both")
        self.uarch = uarch
        self.isa = isa
        self.name = uarch.name
        self.ports = uarch.ports
        self.backend = backend
        self.min_lanes = min_lanes
        self.device = device
        # the placement: devices=, then each set_devices'; the machine is
        # built on the constructor's, which fixes its device type
        self.devices = devices
        self._built_on = devices
        self._batch = None        # lazy BatchSimMachine
        self._table_index = None  # shared UopTableIndex (set by Campaign)
        # handed to the batched backend: a list that keeps every kernel
        # launch's device inputs, or None (see BatchSimMachine)
        self.launched_args: list | None = None

    # ------------------------------------------------------------------
    def set_table_index(self, index) -> None:
        """Adopt a campaign-wide :class:`~repro_torch.core.uarch_compile
        .UopTableIndex` so compiled tables share instruction numbering
        across the campaign's machines."""
        self._table_index = index
        self._batch = None

    def set_devices(self, devices) -> None:
        """Adopt a device placement for the batched backend (a count,
        ``"all"``, device names or a sequence of devices; see
        :meth:`~repro_torch.core.batch_sim.BatchSimMachine.set_devices`).
        ``Campaign.run`` uses this to place each machine on its own device
        subset; results are bit-identical for every placement."""
        self.devices = devices
        if self._batch:
            self._batch.set_devices(devices)

    @property
    def lowering_stats(self) -> dict:
        """The batched backend's lowering-cache counters (empty until the
        first wave builds the backend); surfaced through ``engine_stats``."""
        return self._batch.lowering_stats if self._batch else {}

    def device_stats(self) -> dict:
        """The batched backend's device-kernel telemetry (kernel library
        loads, kernel calls, shape buckets)."""
        return self._batch.device_stats() if self._batch else {}

    def degraded_stats(self) -> dict:
        """Per-transition backend degradation counters, surfaced through
        ``engine_stats``; always empty in the port, which has no
        degradation chain."""
        return self._batch.degraded_stats() if self._batch else {}

    def run_batch(self, codes, kernel_lock=None) -> list:
        """Execute a wave of sequences through the batched backend
        (bit-identical to per-sequence :meth:`run`).

        Degenerate waves (fewer than ``min(4, min_lanes)`` sequences) run
        the scalar loop directly without building the batched backend
        (bit-identical either way); the batched backend additionally routes
        thin padded chunks to the scalar oracle (see
        ``BatchSimMachine.min_lanes`` — ``min_lanes=1`` forces every wave
        through the kernel).  Building the backend raises when it cannot
        run; that error propagates.  ``kernel_lock`` serializes GIL-bound
        scalar execution across schedulers sharing the lock."""
        codes = list(codes)
        degenerate = 4 if self.min_lanes is None else \
            min(4, max(self.min_lanes, 1))
        if len(codes) < degenerate:
            if kernel_lock is not None:
                with kernel_lock:
                    return [self.run(list(c)) for c in codes]
            return [self.run(list(c)) for c in codes]
        if self._batch is None:
            import os  # noqa: PLC0415

            from repro_torch.core.batch_sim import (  # noqa: PLC0415
                DEFAULT_MIN_LANES, BatchSimMachine)
            from repro_torch.core.device_mesh import (  # noqa: PLC0415
                resolve_devices)
            backend = self.backend or os.environ.get(
                "REPRO_SIM_BACKEND", "cuda")
            min_lanes = (DEFAULT_MIN_LANES if self.min_lanes is None
                         else self.min_lanes)
            if self.device is not None:
                place = {"device": self.device}
            elif self._built_on is not None:
                place = {"devices": self._built_on}
            else:
                place = {"devices": resolve_devices()}
            batch = BatchSimMachine(
                self.uarch, self.isa, backend=backend,
                table_index=self._table_index, min_lanes=min_lanes,
                **place)
            if self.devices is not self._built_on:
                batch.set_devices(self.devices)
            batch.launched_args = self.launched_args
            self._batch = batch
        return self._batch.run_batch(codes, kernel_lock=kernel_lock)

    # ------------------------------------------------------------------
    def run(self, code: list[Instr]) -> Counters:
        """Execute ``code`` once, returning cycles + per-port μop counts
        (including the constant measurement-harness overhead)."""
        ua = self.uarch
        reg_ready: dict[str, float] = {}
        reg_width: dict[str, int] = {}  # width of the last write (partial-reg)
        mem_ready: dict[str, float] = {}
        mem_stored: dict[str, bool] = {}
        port_free: dict[str, float] = {p: 0.0 for p in ua.ports}
        port_count: dict[str, int] = {p: 0 for p in ua.ports}
        elim_counter: dict[str, int] = {}
        width = ua.issue_width
        uop_index = 0
        t_end = 0.0

        for ins in code:
            spec = self.isa[ins.spec]
            behavior: InstrBehavior = ua.behaviors[ins.spec]
            regs = dict(ins.regs)
            for o in spec.operands:
                if o.name not in regs and o.otype != IMM:
                    regs[o.name] = _implicit_reg(o.name, o.otype)

            same_reg = self._same_reg(spec, regs)
            if behavior.same_reg is not None and same_reg:
                behavior = behavior.same_reg

            # zero idiom: same register on both explicit operands
            if spec.zero_idiom and same_reg:
                ready = 0.0  # dependency broken: inputs ignored
                if behavior.zero_uop_same_reg:
                    for o in spec.dests:
                        reg_ready[regs[o.name]] = ready
                    continue
                self._exec_uops(behavior.uops, regs, spec, ins, reg_ready,
                                mem_ready, mem_stored, port_free, port_count,
                                uop_index, width, reg_width,
                                ignore_reads=True)
                uop_index += len(behavior.uops)
                continue

            # move elimination (reorder-buffer, no ports, zero latency)
            if spec.may_eliminate and behavior.elim_period:
                c = elim_counter.get(ins.spec, 0)
                elim_counter[ins.spec] = c + 1
                if c % behavior.elim_period != 0:
                    src = next(o for o in spec.sources if o.otype != IMM)
                    dst = spec.dests[0]
                    reg_ready[regs[dst.name]] = reg_ready.get(
                        regs[src.name], 0.0)
                    continue

            done = self._exec_uops(behavior.uops, regs, spec, ins, reg_ready,
                                   mem_ready, mem_stored, port_free,
                                   port_count, uop_index, width, reg_width,
                                   divider_extra=(behavior.divider_extra
                                                  if ins.value_hint == "high"
                                                  else 0))
            uop_index += len(behavior.uops)
            t_end = max(t_end, done)

        t_end = max([t_end] + list(reg_ready.values()) + list(mem_ready.values()))
        return Counters(t_end + ua.overhead_cycles, port_count)

    # ------------------------------------------------------------------
    def _exec_uops(self, uops, regs, spec: InstrSpec, ins: Instr, reg_ready,
                   mem_ready, mem_stored, port_free, port_count, uop_index,
                   width, reg_width=None, ignore_reads=False,
                   divider_extra=0):
        ua = self.uarch
        reg_width = reg_width if reg_width is not None else {}
        tmp_ready: dict[str, float] = {}
        done_max = 0.0
        mem_ops = {o.name: o for o in spec.operands if o.otype == MEM}
        # all μops read the *source* operand values: snapshot ready times
        # before any μop of this instruction writes its destinations.
        # Partial-register stall (§5.2.1): reading wider than the register's
        # last sub-64-bit write inserts a merge penalty — the reason the
        # paper's chains use width-matched MOVSX variants.
        src_snapshot = {}
        for o in spec.operands:
            if o.otype == MEM:
                continue
            r = regs.get(o.name, o.name)
            t = reg_ready.get(r, 0.0)
            if (o.read and o.otype == GPR
                    and o.width > reg_width.get(r, 64)):
                t += ua.partial_stall_penalty
            src_snapshot[o.name] = t
        for u in uops:
            ready = float(uop_index // width)  # front-end issue cycle
            if not ignore_reads:
                for r in u.reads:
                    if r.startswith("%"):
                        ready = max(ready, tmp_ready.get(r, 0.0))
                    elif r in mem_ops and mem_ops[r].read:
                        base = regs[r]
                        ready = max(ready, reg_ready.get(base, 0.0),
                                    mem_ready.get(base, 0.0))
                    elif r in src_snapshot:
                        ready = max(ready, src_snapshot[r])
                    else:
                        ready = max(ready, reg_ready.get(regs.get(r, r), 0.0))
            lat = u.latency + divider_extra
            occ = u.occupancy + divider_extra
            # load latency reduction via store-to-load forwarding
            if any(r in mem_ops and mem_ops[r].read for r in u.reads):
                base = next(regs[r] for r in u.reads if r in mem_ops)
                if mem_stored.get(base):
                    lat = min(lat, ua.store_forward_latency)
            # dispatch: earliest available allowed port
            best_port, best_t = None, None
            for p in sorted(u.ports):
                t = max(ready, port_free[p])
                if best_t is None or t < best_t or (
                        t == best_t and port_count[p] < port_count[best_port]):
                    best_port, best_t = p, t
            if best_port is None:  # 0-port uop (shouldn't happen)
                continue
            # a μop occupies its port for its *effective* occupancy —
            # including the value-dependent divider extra, so a high-value
            # divide blocks the divider even on a 1-occupancy μop
            port_free[best_port] = best_t + (occ if occ > 1 else 1)
            port_count[best_port] += 1
            done = best_t + lat
            done_max = max(done_max, done)
            for w in u.writes:
                if w.startswith("%"):
                    tmp_ready[w] = done
                elif w in mem_ops:
                    base = regs[w]
                    mem_ready[base] = done
                    mem_stored[base] = True
                else:
                    rw = regs.get(w, w)
                    reg_ready[rw] = done
                    wop = next((o for o in spec.operands if o.name == w),
                               None)
                    if wop is not None:
                        reg_width[rw] = wop.width
            uop_index += 1
        return done_max

    @staticmethod
    def _same_reg(spec: InstrSpec, regs) -> bool:
        ex = [o for o in spec.explicit_operands
              if o.otype not in (IMM, MEM, FLAGS)]
        if len(ex) < 2:
            return False
        names = {regs[o.name] for o in ex}
        return len(names) == 1
