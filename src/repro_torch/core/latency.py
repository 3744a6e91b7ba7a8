"""Per-operand-pair latency inference (§4.1 definition, §5.2 algorithms).

lat: S × D → ℕ maps every (source operand, destination operand) pair to its
own latency — the paper's central definitional contribution. Inference
builds cyclic dependency chains per pair:

  * gpr→gpr: MOVSX chain (avoids move elimination and partial-register
    stalls — the reasons the paper rejects MOV/MOVZX, §5.2.1),
  * vec→vec: both an integer (PSHUFD) and an fp (MOVSHDUP) non-destructive
    shuffle, to expose bypass-delay differences,
  * type-crossing pairs: compositions with every candidate chain instruction;
    min composite − 1 reported as an upper bound,
  * flags→reg: TEST R,R closes the loop (§5.2.3); reg→flags via SETC,
  * mem→reg: the double-XOR address trick (§5.2.2),
  * reg→mem: store→load round trip (store-to-load forwarding caveat, §5.2.4),
  * dividers: operand values pinned with AND/OR idempotent masking (§5.2.5).

Unwanted implicit dependencies (status flags, read-modify-write operands not
under test) are cut with dependency-breaking instructions: TEST on an
independent register for flags, a zero idiom for registers.

Each register→register pair with two explicit same-type operands is also
measured with *the same register* for both operands — the scenario that
explains the SHLD discrepancies between published numbers (§7.3.2).

The inference is expressed as :mod:`repro_torch.core.plan` measurement plans:
:class:`LatencyPlans` is the machine-free plan factory — its one-wave
``boot`` plan measures the chain-instruction latencies (§5.2: 'known or
easy to determine in isolation'), and ``analyze`` plans fork one sub-plan
per (source, dest) operand pair, so a :class:`~repro_torch.core.plan
.WaveScheduler` fuses chain benchmarks across pairs *and* across
instructions. :class:`LatencyAnalyzer` remains the run-to-completion
wrapper with the original eager-boot constructor.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.engine import Experiment, as_engine
from repro_torch.core.isa import FLAGS, GPR, IMM, ISA, MEM, VEC, InstrSpec
from repro_torch.core.plan import Fork, MeasurementPlan, run_plan
from repro_torch.core.simulator import Instr

# dedicated registers (never handed out by pools sized 16/16/8)
CHAIN_GPR = ("R24", "R25")
CHAIN_VEC = ("X24", "X25")
BREAK_GPR = "R26"
AUX_GPR = ("R27", "R28")
AUX_VEC = ("X27", "X28")
MEM_BASE = "R23"


@dataclass
class LatencyEntry:
    src: str
    dst: str
    value: float
    kind: str = "exact"  # exact | upper_bound | roundtrip
    chain: str = ""
    same_reg: float | None = None
    high_value: float | None = None  # divider high-latency operand class
    per_chain: dict = field(default_factory=dict)


@dataclass
class LatencyResult:
    instr: str
    entries: dict = field(default_factory=dict)  # (src,dst) -> LatencyEntry

    def get(self, src: str, dst: str) -> LatencyEntry | None:
        return self.entries.get((src, dst))

    def max_latency(self) -> int:
        vals = [e.value for e in self.entries.values()]
        vals += [e.high_value for e in self.entries.values()
                 if e.high_value is not None]
        # quarantined measurements surface as NaN sentinels: they carry no
        # latency information, and must not abort the campaign here
        vals = [v for v in vals if v == v]
        return max(1, round(max(vals))) if vals else 1


class LatencyPlans:
    """Machine-free plan factory for per-pair latency inference.

    One instance per characterization: ``boot_gen`` measures the chain
    instruments once (idempotent — concurrent analyze plans that race into
    it request identical experiments, which the engine dedups; they compute
    identical constants). All measurement happens through plan yields, so
    the same instance serves both the sequential wrapper and a scheduler
    interleaving many instructions."""

    def __init__(self, isa: ISA):
        self.isa = isa
        self._booted = False
        self.lat_test = 1.0
        self.lat_movsx = 0.0
        self.lat_xor = 1.0
        self.lat_setc = 1.0
        self.vec_chains: dict[str, float] = {}
        self.cross: dict[str, list] = {"to_gpr": [], "to_vec": []}

    # -- low-level plan fragments (composed with ``yield from``) ------------
    def _cycles(self, seq: list[Instr]):
        c = yield [Experiment.of(seq)]
        return c[0].cycles

    def _cycles_wave(self, seqs: list[list[Instr]]):
        """Batched request of independent chain benchmarks."""
        cs = yield [Experiment.of(s) for s in seqs]
        return [c.cycles for c in cs]

    def _flags_break(self) -> Instr:
        return Instr("TEST_R64_R64", {"op1": BREAK_GPR, "op2": BREAK_GPR})

    def _reg_break(self, reg: str, otype: str) -> Instr:
        """Overwrite ``reg`` without depending on it and — crucial for the
        flags→reg chains — without touching the status flags (a zero-idiom
        XOR would overwrite FLAGS and cut the dependency under test)."""
        if otype == GPR:
            return Instr("MOV_R64_R64", {"op1": reg, "op2": BREAK_GPR})
        return Instr("PCMPGTQ_X_X", {"op1": reg, "op2": reg})

    def _chain_instr(self, name: str, dst: str, src: str) -> Instr:
        return Instr(name, {"op1": dst, "op2": src})

    def boot_gen(self):
        """Chain-instruction latencies (§5.2), one wave. TEST's reg→flags
        latency is the single bootstrap assumption (= 1 cycle), as in the
        paper's methodology. Idempotent: a booted factory yields nothing."""
        if self._booted:
            return
        isa = self.isa
        a, b = CHAIN_GPR
        va, vb = CHAIN_VEC
        wave: list[tuple[str, list[Instr]]] = []
        # MOVSX self-chain: MOVSX a,b ; MOVSX b,a
        wave.append(("movsx", [self._chain_instr("MOVSX_R64_R32", a, b),
                               self._chain_instr("MOVSX_R64_R32", b, a)]))
        vec_names = [nm for nm in ("PSHUFD_X_X", "MOVSHDUP_X_X")
                     if nm in isa]
        for nm in vec_names:
            wave.append((nm, [self._chain_instr(nm, va, vb),
                              self._chain_instr(nm, vb, va)]))
        # XOR lat(op1,op1): XOR a, aux (RMW self-chain; flags written only)
        if "XOR_R64_R64" in isa:
            wave.append(("xor", [Instr("XOR_R64_R64",
                                       {"op1": a, "op2": AUX_GPR[0]})]))
        # SETC via TEST+SETC+MOVSX loop
        have_setc = "TEST_R64_R64" in isa and "SETC_R8" in isa
        if have_setc:
            mv = ("MOVSX_R64_R8" if "MOVSX_R64_R8" in isa
                  else "MOVSX_R64_R32")
            wave.append(("setc", [
                Instr("TEST_R64_R64", {"op1": a, "op2": a}),
                Instr("SETC_R8", {"op1": b}),
                self._chain_instr(mv, a, b)]))
        cycles = yield from self._cycles_wave([seq for _, seq in wave])
        got = dict(zip((k for k, _ in wave), cycles))
        self.lat_test = 1.0
        self.lat_movsx = got["movsx"] / 2
        self.vec_chains = {nm: got[nm] / 2 for nm in vec_names}
        self.lat_xor = got.get("xor", 1.0)
        self.lat_setc = (max(got["setc"] - self.lat_test - self.lat_movsx,
                             0.0) if have_setc else 1.0)
        # type-crossing chain candidates: (vec->gpr) and (gpr->vec) movers
        self.cross = {"to_gpr": [], "to_vec": []}
        for s in isa:
            ops = s.explicit_operands
            if len(ops) != 2 or any(o.otype == IMM for o in ops):
                continue
            d, src = ops[0], ops[1]
            if d.written and not d.read and src.read:
                if d.otype == GPR and src.otype == VEC:
                    self.cross["to_gpr"].append(s.name)
                elif d.otype == VEC and src.otype == GPR:
                    self.cross["to_vec"].append(s.name)
        self._booted = True

    def boot_plan(self) -> MeasurementPlan:
        return MeasurementPlan(self.boot_gen(), name="latency-boot",
                               phase="latency")

    # -- link builders ------------------------------------------------------
    def _breakers(self, spec: InstrSpec, skip: set) -> list[Instr]:
        """Dependency-breaking instructions for RMW operands not under test."""
        out = []
        for o in spec.operands:
            if o.name in skip or not o.rmw:
                continue
            if o.otype == FLAGS:
                out.append(self._flags_break())
        # flags written by chain XORs etc. are broken by the same TEST
        return out

    def _assign(self, spec: InstrSpec, fixed: dict) -> dict:
        """Registers for all explicit operands; unfixed ones get aux regs."""
        regs = dict(fixed)
        gi = vi = 0
        for o in spec.explicit_operands:
            if o.name in regs or o.otype == IMM:
                continue
            if o.otype == GPR:
                regs[o.name] = AUX_GPR[gi % len(AUX_GPR)]
                gi += 1
            elif o.otype == VEC:
                regs[o.name] = AUX_VEC[vi % len(AUX_VEC)]
                vi += 1
            elif o.otype == MEM:
                regs[o.name] = MEM_BASE
        return regs

    # -- per-case measurements ----------------------------------------------
    def _reg_reg(self, spec, s, d, value_hint="low"):
        """Same-type register→register (gpr or vec)."""
        otype = s.otype
        ca, cb = CHAIN_GPR if otype == GPR else CHAIN_VEC
        chains = ({"MOVSX_R64_R32": self.lat_movsx} if otype == GPR
                  else self.vec_chains)
        links, offsets = [], []
        for cname, clat in chains.items():
            link: list[Instr] = []
            if s.name == d.name:
                regs = self._assign(spec, {s.name: ca})
                link += self._breakers(spec, {s.name})
                link.append(Instr(spec.name, regs, value_hint))
                offsets.append(0.0)
            else:
                fixed = {s.name: ca, d.name: cb}
                regs = self._assign(spec, fixed)
                link += self._breakers(spec, {s.name, d.name})
                if d.read:  # RMW dest: break the old-value dependency
                    link.append(self._reg_break(cb, otype))
                link.append(Instr(spec.name, regs, value_hint))
                link.append(self._chain_instr(cname, ca, cb))
                offsets.append(clat)
            links.append(link)
        cycles = yield from self._cycles_wave(links)
        per_chain = {cname: cyc - off for cname, cyc, off
                     in zip(chains, cycles, offsets)}
        val = min(per_chain.values())
        e = LatencyEntry(s.name, d.name, val, "exact",
                         chain="|".join(per_chain), per_chain=per_chain)
        # same-register scenario (§7.3.2)
        ex_regs = [o for o in spec.explicit_operands
                   if o.otype == otype]
        if s.name != d.name and len(ex_regs) >= 2:
            regs = self._assign(spec, {s.name: ca, d.name: ca})
            link = self._breakers(spec, {s.name, d.name})
            link.append(Instr(spec.name, regs, value_hint))
            e.same_reg = yield from self._cycles(link)
        return e

    def _flags_to_reg(self, spec, s, d):
        ca = CHAIN_GPR[0]
        link = []
        link.append(Instr("TEST_R64_R64", {"op1": ca, "op2": ca}))
        if d.read:
            link.append(self._reg_break(ca, GPR))
        regs = self._assign(spec, {d.name: ca})
        link.append(Instr(spec.name, regs))
        cyc = yield from self._cycles(link)
        return LatencyEntry(s.name, d.name, cyc - self.lat_test,
                            "exact", chain="TEST")

    def _reg_to_flags(self, spec, s, d):
        if s.otype != GPR:
            return None
        ca, cb = CHAIN_GPR
        regs = self._assign(spec, {s.name: ca})
        link = self._breakers(spec, {s.name, d.name})
        link.append(Instr(spec.name, regs))
        link.append(Instr("SETC_R8", {"op1": cb}))
        # width-matched MOVSX: SETC writes 8 bits; reading wider would incur
        # a partial-register stall and corrupt the measurement (§5.2.1)
        mv = ("MOVSX_R64_R8" if "MOVSX_R64_R8" in self.isa
              else "MOVSX_R64_R32")
        link.append(self._chain_instr(mv, ca, cb))
        cyc = yield from self._cycles(link)
        val = cyc - self.lat_setc - self.lat_movsx
        return LatencyEntry(s.name, d.name, val, "exact", chain="SETC+MOVSX")

    def _flags_to_flags(self, spec, s, d):
        link = [Instr(spec.name, self._assign(spec, {}))]
        cyc = yield from self._cycles(link)
        return LatencyEntry(s.name, d.name, cyc, "exact", chain="self")

    def _mem_to_reg(self, spec, s, d):
        """Double-XOR trick: address depends on the loaded result (§5.2.2)."""
        rb = MEM_BASE
        regs = self._assign(spec, {s.name: rb})
        rd = regs.get(d.name)
        if d.otype == VEC:
            # vec dest: compose with vec->gpr mover for an upper bound
            links = []
            for mv in self.cross["to_gpr"]:
                link = []
                if d.read:  # break the RMW old-value loop (e.g. AESDEC m128)
                    link.append(self._reg_break(regs[d.name], VEC))
                link += [Instr(spec.name, regs),
                         Instr(mv, {"op1": CHAIN_GPR[0], "op2": regs[d.name]}),
                         Instr("XOR_R64_R64", {"op1": rb, "op2": CHAIN_GPR[0]}),
                         Instr("XOR_R64_R64", {"op1": rb, "op2": CHAIN_GPR[0]}),
                         self._flags_break()]
                links.append(link)
            cycles = yield from self._cycles_wave(links)
            per = {mv: cyc - 2 * self.lat_xor for mv, cyc
                   in zip(self.cross["to_gpr"], cycles)}
            best = min(per.values())
            return LatencyEntry(s.name, d.name, max(best - 1, 0),
                                "upper_bound", chain="xor2+cross",
                                per_chain=per)
        link = self._breakers(spec, {s.name, d.name})
        link.append(Instr(spec.name, regs))
        link.append(Instr("XOR_R64_R64", {"op1": rb, "op2": rd}))
        link.append(Instr("XOR_R64_R64", {"op1": rb, "op2": rd}))
        link.append(self._flags_break())
        cyc = yield from self._cycles(link)
        return LatencyEntry(s.name, d.name, cyc - 2 * self.lat_xor,
                            "exact", chain="xor2")

    def _reg_to_mem(self, spec, s, d):
        """Store: measure a store→load round trip (§5.2.4)."""
        rb = MEM_BASE
        if s.otype == VEC:
            if "MOVAPS_X_M" not in self.isa:
                return None
            load, ca, cb = "MOVAPS_X_M", CHAIN_VEC[0], CHAIN_VEC[1]
            chain = next(iter(self.vec_chains)) if self.vec_chains else None
            clat = self.vec_chains.get(chain, 1.0)
        else:
            load, ca, cb = "MOV_R64_M64", CHAIN_GPR[0], CHAIN_GPR[1]
            chain, clat = "MOVSX_R64_R32", self.lat_movsx
        regs = self._assign(spec, {s.name: ca, d.name: rb})
        link = [Instr(spec.name, regs),
                Instr(load, {"op1": cb, "mem": rb})]
        if chain:
            link.append(self._chain_instr(chain, ca, cb))
        cyc = yield from self._cycles(link)
        val = cyc - clat
        return LatencyEntry(s.name, d.name, val, "roundtrip",
                            chain=f"store+{load}")

    def _cross_type(self, spec, s, d):
        """Different register types: compositions, upper bound (§5.2.1)."""
        movers, links = [], []
        if d.otype == VEC and s.otype == GPR:
            movers = self.cross["to_gpr"]  # vec result -> gpr source
            for mv in movers:
                regs = self._assign(spec, {s.name: CHAIN_GPR[0],
                                           d.name: CHAIN_VEC[0]})
                link = self._breakers(spec, {s.name, d.name})
                if d.read:
                    link.append(self._reg_break(CHAIN_VEC[0], VEC))
                link.append(Instr(spec.name, regs))
                link.append(Instr(mv, {"op1": CHAIN_GPR[0],
                                       "op2": CHAIN_VEC[0]}))
                links.append(link)
        elif d.otype == GPR and s.otype == VEC:
            movers = self.cross["to_vec"]
            for mv in movers:
                regs = self._assign(spec, {s.name: CHAIN_VEC[0],
                                           d.name: CHAIN_GPR[0]})
                link = self._breakers(spec, {s.name, d.name})
                if d.read:
                    link.append(self._reg_break(CHAIN_GPR[0], GPR))
                link.append(Instr(spec.name, regs))
                link.append(Instr(mv, {"op1": CHAIN_VEC[0],
                                       "op2": CHAIN_GPR[0]}))
                links.append(link)
        cycles = yield from self._cycles_wave(links)
        per = dict(zip(movers, cycles))
        if not per:
            return None
        return LatencyEntry(s.name, d.name, max(min(per.values()) - 1, 0),
                            "upper_bound", chain="compose", per_chain=per)

    # -- pair dispatch -------------------------------------------------------
    def _pair_gen(self, spec, s, d, value_hint="low"):
        if s.otype == FLAGS and d.otype == FLAGS:
            return (yield from self._flags_to_flags(spec, s, d))
        if s.otype == FLAGS:
            if d.otype != GPR:
                return None
            return (yield from self._flags_to_reg(spec, s, d))
        if d.otype == FLAGS:
            return (yield from self._reg_to_flags(spec, s, d))
        if s.otype == MEM:
            return (yield from self._mem_to_reg(spec, s, d))
        if d.otype == MEM:
            return (yield from self._reg_to_mem(spec, s, d))
        if s.otype == d.otype:
            return (yield from self._reg_reg(spec, s, d, value_hint))
        return (yield from self._cross_type(spec, s, d))

    def _pair_full_gen(self, spec, s, d):
        e = yield from self._pair_gen(spec, s, d)
        if e is not None and spec.uses_divider and e.kind == "exact":
            eh = yield from self._pair_gen(spec, s, d, value_hint="high")
            if eh is not None:
                e.high_value = eh.value
        return e

    # -- per-instruction plan ------------------------------------------------
    def analyze_gen(self, spec: InstrSpec):
        yield from self.boot_gen()
        pairs = [(s, d) for s in spec.sources if s.otype != IMM
                 for d in spec.dests]
        entries = yield Fork([
            MeasurementPlan(self._pair_full_gen(spec, s, d),
                            name=f"lat[{spec.name}:{s.name}->{d.name}]",
                            phase="latency")
            for s, d in pairs])
        res = LatencyResult(spec.name)
        for (s, d), e in zip(pairs, entries):
            if e is not None:
                res.entries[(s.name, d.name)] = e
        return res

    def analyze_plan(self, instr: InstrSpec | str) -> MeasurementPlan:
        spec = self.isa[instr] if isinstance(instr, str) else instr
        return MeasurementPlan(self.analyze_gen(spec),
                               name=f"latency[{spec.name}]", phase="latency")


def latency_plan(spec: InstrSpec | str, isa: ISA,
                 plans: LatencyPlans | None = None) -> MeasurementPlan:
    """Per-operand-pair latency inference for one instruction as a plan.

    Pass a shared :class:`LatencyPlans` so many instructions' plans reuse
    one boot (a fresh factory boots itself on first use)."""
    return (plans or LatencyPlans(isa)).analyze_plan(spec)


class LatencyAnalyzer:
    """Per-pair latency inference, run to completion on one machine.

    ``machine`` may be a machine or a :class:`MeasurementEngine`; every
    dependency-chain benchmark is a declarative Experiment requested by the
    underlying :class:`LatencyPlans`, so chains shared between pairs (or
    re-run across analyses) execute once. Boot measurements happen eagerly
    at construction, as before; boot constants (``lat_movsx``,
    ``vec_chains``, ``cross``, …) remain readable on the analyzer."""

    def __init__(self, machine, isa: ISA):
        self.engine = as_engine(machine)
        self.machine = self.engine.machine
        self.isa = isa
        self.plans = LatencyPlans(isa)
        run_plan(self.engine, self.plans.boot_plan())

    def __getattr__(self, name):
        # boot constants (lat_movsx, lat_setc, vec_chains, cross, ...)
        if name == "plans":    # guard: no recursion before __init__ sets it
            raise AttributeError(name)
        return getattr(self.plans, name)

    def analyze(self, instr: InstrSpec | str) -> LatencyResult:
        return run_plan(self.engine, self.plans.analyze_plan(instr))
