"""Synthetic prediction workloads: seeded random basic blocks drawn from a
characterized model, used by the service-throughput benchmark and the
batch-vs-reference agreement tests."""
from __future__ import annotations

import random

from repro_torch.core.characterize import PerfModel
from repro_torch.core.isa import FLAGS, GPR, IMM, ISA, MEM, VEC
from repro_torch.core.simulator import Instr

_REG_POOLS = {
    GPR: [f"R{i}" for i in range(16)],
    VEC: [f"X{i}" for i in range(16)],
    MEM: [f"RB{i}" for i in range(8)],
}


def random_block(model: PerfModel, isa: ISA, rng: random.Random,
                 length: int = 4) -> list[Instr]:
    """One block of ``length`` instructions over the model's characterized
    variants, with random (possibly chaining / colliding) registers — the
    interesting regime for the latency bound."""
    names = [n for n in model.instructions if n in isa]
    code = []
    for _ in range(length):
        spec = isa[rng.choice(names)]
        regs = {}
        for o in spec.explicit_operands:
            if o.otype in (IMM, FLAGS):
                continue
            regs[o.name] = rng.choice(_REG_POOLS[o.otype])
        hint = "high" if (spec.uses_divider and rng.random() < 0.3) else "low"
        code.append(Instr(spec.name, regs, hint))
    return code


def random_blocks(model: PerfModel, isa: ISA, n: int, *,
                  min_len: int = 1, max_len: int = 6,
                  seed: int = 0) -> list[list[Instr]]:
    rng = random.Random(seed)
    return [random_block(model, isa, rng, rng.randint(min_len, max_len))
            for _ in range(n)]
