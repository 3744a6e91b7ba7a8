"""Seeded, stratified basic-block generation.

The port of the reference package's ``repro/corpus/generate.py``: the same
spec gives shards and a manifest byte-identical to the reference's.

Blocks are drawn per uarch from the variants that uarch actually
implements (``UArch.behaviors`` ∩ ISA, minus the paper-§8 exclusions) and
stratified into families chosen to stress different predictor terms:

* ``dep_chain`` — one serial dependency chain threaded through every
  instruction (latency-bound regime; register pool kept small so chains
  collide),
* ``port_pressure`` — independent instructions all drawn from one
  port-signature group of the uarch (port-bound regime; the narrower the
  signature, the hotter the contention),
* ``mixed`` — uniform sampling with random registers (the
  anything-can-happen regime the service sees),
* ``divider`` — divider-heavy blocks with ``!high`` operand-class hints
  mixed in (non-pipelined occupancy + value-dependent latency, §5.2.5),
* ``idiom`` — zero idioms and elimination-candidate moves woven into a
  chain (dependency-breaking detection, §7.3.6).

Everything is driven by one :class:`random.Random` seeded from a string
derived from ``(spec.seed, uarch)`` — Python seeds strings through
SHA-512, so the same spec yields byte-identical corpora on any host.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

from repro_torch.core.isa import FLAGS, GPR, IMM, ISA, MEM, TEST_ISA, VEC
from repro_torch.core.simulator import Instr
from repro_torch.core.uarch import SIM_UARCHES
from repro_torch.obs import tracer as obs
from repro_torch.service.protocol import format_block

FAMILIES = ("dep_chain", "port_pressure", "mixed", "divider", "idiom")

#: architectural register pools (the simulator's namespace, same as
#: repro_torch.service.workload)
_POOLS = {
    GPR: [f"R{i}" for i in range(16)],
    VEC: [f"X{i}" for i in range(16)],
    MEM: [f"RB{i}" for i in range(8)],
}
#: small pools force chains/collisions in the dependency-heavy families
_TIGHT_POOLS = {
    GPR: [f"R{i}" for i in range(6)],
    VEC: [f"X{i}" for i in range(6)],
    MEM: [f"RB{i}" for i in range(4)],
}


@dataclass(frozen=True)
class CorpusSpec:
    """Everything that determines a corpus, and nothing else — the spec is
    embedded in the manifest, and (spec, ISA) → corpus is a pure
    function."""
    seed: int = 0
    blocks_per_uarch: int = 10_000
    uarches: tuple = tuple(sorted(SIM_UARCHES))
    min_len: int = 2
    max_len: int = 12
    shard_size: int = 2048
    family_mix: tuple = tuple((f, 1.0) for f in FAMILIES)

    def as_dict(self) -> dict:
        return {"seed": self.seed,
                "blocks_per_uarch": self.blocks_per_uarch,
                "uarches": list(self.uarches),
                "min_len": self.min_len, "max_len": self.max_len,
                "shard_size": self.shard_size,
                "family_mix": {f: w for f, w in self.family_mix}}


def _supported(spec) -> bool:
    return not (spec.system or spec.serializing or spec.control_flow
                or spec.is_nop)


def variant_pool(uarch_name: str, isa: ISA) -> list[str]:
    """Variant names this uarch implements and the tool characterizes."""
    ua = SIM_UARCHES[uarch_name]
    return sorted(n for n in isa.names()
                  if n in ua.behaviors and _supported(isa[n]))


def _regs_for(spec, rng: random.Random, pools) -> dict[str, str]:
    return {o.name: rng.choice(pools[o.otype])
            for o in spec.explicit_operands
            if o.otype not in (IMM, FLAGS)}


def _chainable(spec):
    """The operand a dependency chain can thread through: prefer a
    read+written register operand, else any read one."""
    rw = [o for o in spec.explicit_operands
          if o.otype in (GPR, VEC) and o.read and o.written]
    if rw:
        return rw[0]
    r = [o for o in spec.explicit_operands
         if o.otype in (GPR, VEC) and o.read]
    return r[0] if r else None


def _written(spec):
    for o in spec.explicit_operands:
        if o.otype in (GPR, VEC) and o.written:
            return o
    return None


def _gen_dep_chain(isa, pool, rng, length):
    names = [n for n in pool if _chainable(isa[n]) is not None]
    prev = {GPR: "R0", VEC: "X0"}
    code = []
    for _ in range(length):
        spec = isa[rng.choice(names)]
        link = _chainable(spec)
        regs = _regs_for(spec, rng, _TIGHT_POOLS)
        regs[link.name] = prev[link.otype]
        code.append(Instr(spec.name, regs, "low"))
        out = _written(spec)
        if out is not None:
            prev[out.otype] = regs.get(out.name, prev[out.otype])
    return code


def _port_sig(uarch, name) -> frozenset:
    return frozenset(p for u in uarch.behaviors[name].uops for p in u.ports)


def _gen_port_pressure(isa, pool, rng, length, uarch):
    """Independent instructions from one port-signature group: the wave
    lands entirely on a narrow port set, so the port bound dominates."""
    groups: dict[frozenset, list[str]] = {}
    for n in pool:
        groups.setdefault(_port_sig(uarch, n), []).append(n)
    # favor narrow signatures (hotter contention), but keep it random
    sigs = sorted(groups, key=lambda s: (len(s), sorted(s)))
    sig = sigs[min(int(rng.expovariate(0.7)), len(sigs) - 1)]
    names = groups[sig]
    code = []
    for i in range(length):
        spec = isa[rng.choice(names)]
        regs = {}
        for j, o in enumerate(spec.explicit_operands):
            if o.otype in (IMM, FLAGS):
                continue
            p = _POOLS[o.otype]
            # distinct destinations per lane, sources rotated off them:
            # no chains, pure throughput
            regs[o.name] = p[(2 * i + j) % len(p)]
        code.append(Instr(spec.name, regs, "low"))
    return code


def _gen_mixed(isa, pool, rng, length):
    code = []
    for _ in range(length):
        spec = isa[rng.choice(pool)]
        hint = ("high" if spec.uses_divider and rng.random() < 0.3
                else "low")
        code.append(Instr(spec.name, _regs_for(spec, rng, _POOLS), hint))
    return code


def _gen_divider(isa, pool, rng, length):
    divs = [n for n in pool if isa[n].uses_divider]
    if not divs:
        return _gen_mixed(isa, pool, rng, length)
    code = []
    for _ in range(length):
        if rng.random() < 0.6:
            spec = isa[rng.choice(divs)]
            hint = "high" if rng.random() < 0.5 else "low"
        else:
            spec = isa[rng.choice(pool)]
            hint = "low"
        code.append(Instr(spec.name, _regs_for(spec, rng, _TIGHT_POOLS),
                          hint))
    return code


def _gen_idiom(isa, pool, rng, length):
    """Zero idioms (same source and dest register) and elimination
    candidates inside a chain: the predictor only gets these right if the
    model captured the dependency-breaking behavior."""
    idioms = [n for n in pool if isa[n].zero_idiom]
    moves = [n for n in pool if isa[n].may_eliminate]
    if not idioms and not moves:
        return _gen_dep_chain(isa, pool, rng, length)
    code = _gen_dep_chain(isa, pool, rng, length)
    for i in range(len(code)):
        roll = rng.random()
        if idioms and roll < 0.3:
            spec = isa[rng.choice(idioms)]
            reg = rng.choice(_TIGHT_POOLS[
                spec.explicit_operands[0].otype])
            regs = {o.name: reg for o in spec.explicit_operands
                    if o.otype not in (IMM, FLAGS)}
            code[i] = Instr(spec.name, regs, "low")
        elif moves and roll < 0.5:
            spec = isa[rng.choice(moves)]
            code[i] = Instr(spec.name,
                            _regs_for(spec, rng, _TIGHT_POOLS), "low")
    return code


_GENERATORS = {
    "dep_chain": lambda isa, pool, rng, length, ua: _gen_dep_chain(
        isa, pool, rng, length),
    "port_pressure": _gen_port_pressure,
    "mixed": lambda isa, pool, rng, length, ua: _gen_mixed(
        isa, pool, rng, length),
    "divider": lambda isa, pool, rng, length, ua: _gen_divider(
        isa, pool, rng, length),
    "idiom": lambda isa, pool, rng, length, ua: _gen_idiom(
        isa, pool, rng, length),
}


def generate_blocks(uarch_name: str, spec: CorpusSpec,
                    isa: ISA | None = None) -> list[dict]:
    """All of one uarch's corpus records, in deterministic order. Each
    record is ``{"id", "uarch", "family", "block"}`` with the block in the
    textual format (``repro_torch.service.protocol.parse_block`` inverts
    it)."""
    isa = isa if isa is not None else TEST_ISA
    ua = SIM_UARCHES[uarch_name]
    pool = variant_pool(uarch_name, isa)
    if not pool:
        raise ValueError(f"uarch {uarch_name!r} implements no ISA variant")
    # string seeding goes through SHA-512: stable across hosts/processes
    rng = random.Random(f"repro-corpus/{spec.seed}/{uarch_name}")
    fams = [f for f, _ in spec.family_mix]
    weights = [w for _, w in spec.family_mix]
    unknown = set(fams) - set(FAMILIES)
    if unknown:
        raise ValueError(f"unknown corpus families {sorted(unknown)}")
    records = []
    with obs.span("corpus.generate", uarch=uarch_name,
                  blocks=spec.blocks_per_uarch):
        for i in range(spec.blocks_per_uarch):
            fam = rng.choices(fams, weights)[0]
            length = rng.randint(spec.min_len, spec.max_len)
            code = _GENERATORS[fam](isa, pool, rng, length, ua)
            records.append({"id": f"{uarch_name}-{i:06d}",
                            "uarch": uarch_name, "family": fam,
                            "block": format_block(code)})
    return records


def generate_corpus(out_dir, spec: CorpusSpec | None = None,
                    isa: ISA | None = None) -> dict:
    """Generate and persist the full corpus; returns the manifest."""
    from repro_torch.corpus.store import write_corpus  # noqa: PLC0415

    spec = spec if spec is not None else CorpusSpec()
    by_uarch = {ua: generate_blocks(ua, spec, isa) for ua in spec.uarches}
    return write_corpus(out_dir, by_uarch, spec)
