"""Microarchitecture descriptions.

Two kinds live here:

1. **Simulated-core ground truths** (`SIM_*`): per-instruction μop tables —
   port sets, μop-level dataflow (which source operands each μop waits on,
   which destination it produces) and latencies. These are the *hidden*
   parameters the paper's algorithms must recover; tests compare inference
   output against them. Several real uops.info findings are planted:
   AESDEC's Sandy-Bridge 8/1-cycle per-operand-pair split (§7.3.1), SHLD's
   Skylake same-register fast path (§7.3.2), MOVQ2DQ's isolation-measurement
   fallacy (§7.3.3), ADC = 1*p0156+1*p06 on Haswell (§5.1), PCMPGTQ as an
   undocumented zero idiom (§7.3.6).

2. **The H100 SXM's published peaks** (`H100_SXM`), the roofline constants
   that bound the port's kernels, plus the simulated TPU-unit port model
   (`TPU_PORTS`, names only) that ``make_tpu_sim`` builds on.
"""
from __future__ import annotations

import random as _random
from dataclasses import dataclass, field, replace

from repro_torch.core.isa import ISA, TEST_ISA

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM peaks: the roofline constants of the port
# ---------------------------------------------------------------------------
# NVIDIA's H100 data sheet (SXM part, dense rates without sparsity, at the
# 700 W power limit), and the CUDA programming guide's arithmetic-throughput
# table for compute capability 9.0 (MUFU: 16 results per SM per clock).
H100_SXM = {
    "name": "h100_sxm",
    "peak_bf16_flops": 989e12,       # FLOP/s, tensor cores
    "peak_tf32_flops": 495e12,       # FLOP/s, tensor cores
    "peak_fp32_flops": 67e12,        # FLOP/s outside the tensor cores (FFMA)
    "hbm_bw": 3.35e12,               # B/s
    "hbm_bytes": 80e9,
    "l2_bytes": 50 * 2**20,          # 50 MB
    "sms": 132,
    "power_w": 700.0,
    "mufu_per_sm_per_clock": 16,
}
# the SM clock implied by the FP32 peak (132 SMs x 128 FFMA x 2 FLOP a
# clock): 1.98 GHz, NVIDIA's boost clock for the SXM part
H100_SXM["sm_clock_hz"] = H100_SXM["peak_fp32_flops"] / (
    H100_SXM["sms"] * 128 * 2)
# rsqrt/exp/... results per second over the whole card
H100_SXM["peak_mufu_ops"] = (H100_SXM["mufu_per_sm_per_clock"]
                             * H100_SXM["sms"] * H100_SXM["sm_clock_hz"])

# abstract TPU-core port model for kernel-level characterization
TPU_PORTS = ("MXU", "VPU", "XLU", "LSU", "SFU")


@dataclass(frozen=True)
class Uop:
    """One μop of the ground truth: allowed ports + local dataflow.

    ``reads``/``writes`` name instruction operands ("op1", "flags", "mem")
    or intra-instruction intermediates ("%0", "%1"...). ``occupancy`` > 1
    models non-pipelined units (dividers)."""
    ports: frozenset
    reads: tuple = ()
    writes: tuple = ()
    latency: int = 1
    occupancy: int = 1


def uop(ports, reads=(), writes=(), lat=1, occ=1) -> Uop:
    return Uop(frozenset(ports), tuple(reads), tuple(writes), lat, occ)


@dataclass(frozen=True)
class InstrBehavior:
    uops: tuple[Uop, ...]
    same_reg: "InstrBehavior | None" = None  # alt behavior when op1==op2
    elim_period: int = 0   # move elim: eliminate all but every k-th instance
    dep_breaking_same_reg: bool = False
    zero_uop_same_reg: bool = False
    divider_extra: int = 0  # extra latency+occupancy for "high" operand values


def beh(*uops_, **kw) -> InstrBehavior:
    return InstrBehavior(tuple(uops_), **kw)


@dataclass(frozen=True)
class UArch:
    name: str
    ports: tuple[str, ...]
    issue_width: int
    behaviors: dict[str, InstrBehavior] = field(repr=False)
    load_latency: int = 5
    store_forward_latency: int = 4
    overhead_cycles: int = 85  # measurement-harness overhead (Algorithm 2)
    # partial-register stall (§5.2.1): cycles added when reading a register
    # wider than its last (sub-64-bit) write — why chains use MOVSX
    partial_stall_penalty: int = 3

    def replace(self, **kw) -> "UArch":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Skylake-like simulated core (8 ports)
# ---------------------------------------------------------------------------

P0156 = frozenset("0156")
P06 = frozenset("06")
P01 = frozenset("01")
P015 = frozenset("015")
P23 = frozenset("23")
P237 = frozenset("237")
P4 = frozenset("4")
P5 = frozenset("5")
P1 = frozenset("1")
P0 = frozenset("0")
P15 = frozenset("15")


def _alu(lat=1, ports=P0156):
    return beh(uop(ports, ("op1", "op2"), ("op1", "flags"), lat))


def _skl_behaviors() -> dict[str, InstrBehavior]:
    b: dict[str, InstrBehavior] = {}
    for nm in ("ADD", "SUB", "AND", "OR"):
        b[f"{nm}_R64_R64"] = _alu()
    b["XOR_R64_R64"] = beh(
        uop(P0156, ("op1", "op2"), ("op1", "flags")),
        dep_breaking_same_reg=True, zero_uop_same_reg=True)
    b["SUBZ_R64_R64"] = beh(
        uop(P0156, ("op1", "op2"), ("op1", "flags")),
        dep_breaking_same_reg=True, zero_uop_same_reg=True)
    b["ADC_R64_R64"] = beh(  # SKL: single uop p06, 1 cycle
        uop(P06, ("op1", "op2", "flags"), ("op1", "flags")))
    b["SBB_R64_R64"] = beh(
        uop(P06, ("op1", "op2", "flags"), ("op1", "flags")))
    b["CMP_R64_R64"] = beh(uop(P0156, ("op1", "op2"), ("flags",)))
    b["TEST_R64_R64"] = beh(uop(P0156, ("op1", "op2"), ("flags",)))
    b["INC_R64"] = beh(uop(P0156, ("op1",), ("op1", "flags")))
    b["NOT_R64"] = beh(uop(P0156, ("op1",), ("op1",)))
    b["LEA_R64"] = beh(uop(frozenset("15"), ("op2",), ("op1",)))
    b["POPCNT_R64_R64"] = beh(uop(P1, ("op2",), ("op1", "flags"), 3))
    b["BSWAP_R32"] = beh(uop(P15, ("op1",), ("op1",)))
    b["BSWAP_R64"] = beh(uop(P06, ("op1",), ("%0",)),
                         uop(P15, ("%0",), ("op1",)))
    b["MOV_R64_R64"] = beh(uop(P0156, ("op2",), ("op1",)), elim_period=3)
    b["MOVSX_R64_R32"] = beh(uop(P0156, ("op2",), ("op1",)))
    b["MOVSX_R64_R8"] = beh(uop(P0156, ("op2",), ("op1",)))
    b["MOVZX_R64_R16"] = beh(uop(P0156, ("op2",), ("op1",)), elim_period=3)
    for nm in ("SHL", "SHR", "SAR", "ROL", "ROR"):
        b[f"{nm}_R64_I8"] = beh(
            uop(P06, ("op1", "flags"), ("op1", "flags")))
    # SHLD SKL (§7.3.2): 3 cycles normally, 1 cycle when op1==op2
    b["SHLD_R64_R64_I8"] = beh(
        uop(P1, ("op1", "op2"), ("op1", "flags"), 3),
        same_reg=beh(uop(P1, ("op1", "op2"), ("op1", "flags"), 1)))
    b["IMUL_R64_R64"] = beh(uop(P1, ("op1", "op2"), ("op1", "flags"), 3))
    b["MUL_R64"] = beh(uop(P1, ("op1", "op2"), ("op1", "flags"), 3),
                       uop(P5, ("op1", "op2"), ("hi",), 4))
    b["DIV_R64"] = beh(
        uop(P0, ("op1", "op2", "hi"), ("op1", "hi", "flags"), 23, occ=6),
        divider_extra=13)
    b["SETC_R8"] = beh(uop(P06, ("flags",), ("op1",)))
    b["CMOVBE_R64_R64"] = beh(uop(P06, ("op1", "op2", "flags"), ("op1",)))
    b["CMC"] = beh(uop(P0156, ("flags",), ("flags",)))
    b["SAHF"] = beh(uop(P06, ("op1",), ("flags",)))
    b["MOV_R64_M64"] = beh(uop(P23, ("mem",), ("op1",), 5))
    b["MOV_M64_R64"] = beh(uop(P237, ("mem",), ("%a",)),      # store addr
                           uop(P4, ("op1", "%a"), ("mem",)))  # store data
    b["ADD_R64_M64"] = beh(uop(P23, ("mem",), ("%0",), 5),
                           uop(P0156, ("op1", "%0"), ("op1", "flags")))
    b["IMUL_R64_M64"] = beh(uop(P23, ("mem",), ("%0",), 5),
                            uop(P1, ("op1", "%0"), ("op1", "flags"), 3))
    for pre in ("P", "VP"):
        b[f"{pre}ADDD_X_X"] = beh(uop(P015, ("op1", "op2"), ("op1",)))
        b[f"{pre}MULD_X_X"] = beh(uop(P01, ("op1", "op2"), ("op1",), 5))
        b[f"{pre}SHUFB_X_X"] = beh(uop(P5, ("op1", "op2"), ("op1",)))
        b[f"{pre}AND_X_X"] = beh(uop(P015, ("op1", "op2"), ("op1",)))
        # §7.3.6: undocumented zero idiom (still uses an execution port)
        b[f"{pre}CMPGTQ_X_X"] = beh(uop(P015, ("op1", "op2"), ("op1",)),
                                    dep_breaking_same_reg=True)
    b["SHUFPS_X_X"] = beh(uop(P5, ("op1", "op2"), ("op1",)))
    b["PSHUFD_X_X"] = beh(uop(P5, ("op2",), ("op1",)))
    b["MOVSHDUP_X_X"] = beh(uop(P5, ("op2",), ("op1",)))
    b["ADDPS_X_X"] = beh(uop(P01, ("op1", "op2"), ("op1",), 4))
    b["MULPS_X_X"] = beh(uop(P01, ("op1", "op2"), ("op1",), 4))
    b["DIVPS_X_X"] = beh(uop(P0, ("op1", "op2"), ("op1",), 11, occ=3),
                         divider_extra=3)
    # AESDEC on SKL-like: single 4-cycle uop (post-Haswell behavior)
    b["AESDEC_X_X"] = beh(uop(P0, ("op1", "op2"), ("op1",), 4))
    b["AESDEC_X_M"] = beh(uop(P23, ("mem",), ("%0",), 5),
                          uop(P0, ("op1", "%0"), ("op1",), 4))
    # MOVQ2DQ (§7.3.3): ground truth 1*p0 + 1*p015
    b["MOVQ2DQ_X_X"] = beh(uop(P0, ("op2",), ("%0",)),
                           uop(P015, ("%0",), ("op1",)))
    b["MOVAPS_X_X"] = beh(uop(P015, ("op2",), ("op1",)), elim_period=3)
    b["MOVD_R64_X"] = beh(uop(P0, ("op2",), ("op1",), 2))
    b["MOVD_X_R64"] = beh(uop(P5, ("op2",), ("op1",), 2))
    b["PEXTRQ_R64_X"] = beh(uop(P5, ("op2",), ("%0",), 2),
                            uop(P0, ("%0",), ("op1",)))
    b["MOVAPS_M_X"] = beh(uop(P237, ("mem",), ("%a",)),
                          uop(P4, ("op1", "%a"), ("mem",)))
    b["MOVAPS_X_M"] = beh(uop(P23, ("mem",), ("op1",), 6))
    b["NOP"] = beh()
    b["PAUSE"] = beh(uop(P0156, (), (), 4), uop(P0156, (), (), 4))
    b["LFENCE"] = beh(uop(P0156, (), (), 6))
    b["CPUID"] = beh(uop(P0156, ("op1",), ("op1",), 100))
    b["RDMSR"] = beh(uop(P0156, (), ("op1",), 100))
    b["JMP_R64"] = beh(uop(P06, ("op1",), (), 1))
    return b


SIM_SKL = UArch("sim_skl", tuple("01234567"), 4, _skl_behaviors())


def _hsw_behaviors() -> dict[str, InstrBehavior]:
    b = dict(_skl_behaviors())
    # §5.1: ADC on Haswell = 1*p0156 + 1*p06 (isolation suggests 2*p0156)
    b["ADC_R64_R64"] = beh(
        uop(P0156, ("op2",), ("%0",)),
        uop(P06, ("op1", "%0", "flags"), ("op1", "flags")))
    b["SBB_R64_R64"] = b["ADC_R64_R64"]
    # AESDEC on Haswell: one 7-cycle uop (§7.3.1)
    b["AESDEC_X_X"] = beh(uop(P5, ("op1", "op2"), ("op1",), 7))
    b["AESDEC_X_M"] = beh(uop(P23, ("mem",), ("%0",), 5),
                          uop(P5, ("op1", "%0"), ("op1",), 7))
    # MOVDQ2Q-style: 1*p5 + 1*p015 (§7.3.4) reusing MOVQ2DQ slot semantics
    b["MOVQ2DQ_X_X"] = beh(uop(P5, ("op2",), ("%0",)),
                           uop(P015, ("%0",), ("op1",)))
    # SHLD on Haswell: no same-register fast path
    b["SHLD_R64_R64_I8"] = beh(
        uop(P1, ("op1", "op2"), ("op1", "flags"), 3))
    return b


SIM_HSW = UArch("sim_hsw", tuple("01234567"), 4, _hsw_behaviors())


def _snb_behaviors() -> dict[str, InstrBehavior]:
    """Sandy-Bridge-like: 6 ports (0,1,5 exec; 2,3 load; 4 store-data)."""
    b = dict(_skl_behaviors())
    snb_remap = {frozenset("0156"): P015, frozenset("06"): frozenset("05"),
                 frozenset("237"): P23}

    def remap(behavior: InstrBehavior) -> InstrBehavior:
        def fix(u: Uop) -> Uop:
            return Uop(snb_remap.get(u.ports, u.ports), u.reads, u.writes,
                       u.latency, u.occupancy)
        return InstrBehavior(
            tuple(fix(u) for u in behavior.uops),
            same_reg=remap(behavior.same_reg) if behavior.same_reg else None,
            elim_period=0,  # SnB: no move elimination yet
            dep_breaking_same_reg=behavior.dep_breaking_same_reg,
            zero_uop_same_reg=False,  # dep-breaking but still executed
            divider_extra=behavior.divider_extra)

    b = {k: remap(v) for k, v in b.items()}
    # AESDEC on SnB (§7.3.1): 2 uops, lat(op1,op1)=8, lat(op2,op1)=1
    b["AESDEC_X_X"] = beh(uop(P1, ("op1",), ("%0",), 7),
                          uop(P015, ("%0", "op2"), ("op1",), 1))
    b["AESDEC_X_M"] = beh(uop(P23, ("mem",), ("%m",), 5),
                          uop(P1, ("op1",), ("%0",), 7),
                          uop(P015, ("%0", "%m"), ("op1",), 1))
    # SHLD on SnB/NHM-like: lat(op1,op1)=3, lat(op2,op1)=4 (§7.3.2)
    b["SHLD_R64_R64_I8"] = beh(
        uop(P5, ("op2",), ("%0",), 1),
        uop(P1, ("op1", "%0"), ("op1", "flags"), 3))
    return b


SIM_SNB = UArch("sim_snb", tuple("012345"), 4, _snb_behaviors())

SIM_UARCHES = {u.name: u for u in (SIM_SKL, SIM_HSW, SIM_SNB)}


# ---------------------------------------------------------------------------
# TPU-unit simulated core: the paper's method one level up.
#
# Ports are functional-unit classes (MXU/VPU/XLU/LSU/SFU); "instructions"
# are kernel-level tile ops (a 128x128 matmul tile, a vector FMA tile, a
# VMEM<->HBM copy, a softmax tile, a flash-attention tile...). The hidden
# ground truth encodes how many issue slots of each unit a fused tile op
# occupies — exactly what `kernels/microbench.py` blocking kernels probe on
# real hardware, and what Algorithm 1 must recover here.
# ---------------------------------------------------------------------------


def _tpu_isa_and_behaviors():
    from repro_torch.core.isa import GPR, ISA, InstrSpec, op  # noqa: PLC0415

    def tile(name):
        return InstrSpec(name, name,
                         (op("op1", GPR, "w"), op("op2", GPR, "r")))

    MXU = frozenset(["MXU"])
    VPU = frozenset(["VPU"])
    XLU = frozenset(["XLU"])
    LSU = frozenset(["LSU"])
    SFU = frozenset(["SFU"])
    isa = ISA()
    b: dict[str, InstrBehavior] = {}
    specs = {
        # 1-slot unit saturators (the blocking-kernel candidates)
        "MATMUL_TILE": beh(uop(MXU, ("op2",), ("op1",), 2)),
        "FMA_TILE": beh(uop(VPU, ("op2",), ("op1",), 1)),
        "TRANSPOSE_TILE": beh(uop(XLU, ("op2",), ("op1",), 1)),
        "COPY_TILE": beh(uop(LSU, ("op2",), ("op1",), 4)),
        "EXP_TILE": beh(uop(SFU, ("op2",), ("op1",), 3)),
        # fused tile ops with multi-unit occupancy (the inference targets)
        "SOFTMAX_TILE": beh(uop(SFU, ("op2",), ("%0",), 3),
                            uop(VPU, ("%0",), ("op1",), 1)),
        "FLASH_ATTN_TILE": beh(uop(LSU, ("op2",), ("%0",), 4),
                               uop(MXU, ("%0",), ("%1",), 2),
                               uop(SFU, ("%1",), ("%2",), 3),
                               uop(MXU, ("%2",), ("%3",), 2),
                               uop(VPU, ("%3",), ("op1",), 1)),
        "RMSNORM_TILE": beh(uop(VPU, ("op2",), ("%0",), 1),
                            uop(SFU, ("%0",), ("%1",), 3),
                            uop(VPU, ("%1",), ("op1",), 1)),
        "SSD_CHUNK_TILE": beh(uop(LSU, ("op2",), ("%0",), 4),
                              uop(MXU, ("%0",), ("%1",), 2),
                              uop(MXU, ("%1",), ("%2",), 2),
                              uop(VPU, ("%2",), ("op1",), 1)),
        "GATHER_TILE": beh(uop(LSU, ("op2",), ("%0",), 4),
                           uop(XLU, ("%0",), ("op1",), 1)),
    }
    for name, behavior in specs.items():
        isa.add(tile(name))
        b[name] = behavior
    return isa, b


def make_tpu_sim():
    """(machine-ready uarch, isa, truth) for the TPU-unit port model."""
    isa, behaviors = _tpu_isa_and_behaviors()
    ua = UArch("sim_tpu", TPU_PORTS, 4, behaviors, overhead_cycles=40)
    truth = {name: {} for name in behaviors}
    for name, behavior in behaviors.items():
        for u in behavior.uops:
            truth[name][u.ports] = truth[name].get(u.ports, 0) + 1
    return ua, isa, truth


# ---------------------------------------------------------------------------
# randomized ground truths for property-based tests
# ---------------------------------------------------------------------------


def random_uarch_and_isa(seed: int, n_instr: int = 6,
                         ports: tuple[str, ...] = tuple("012345")):
    """Draw a random hidden ground truth plus an ISA guaranteed to contain a
    1-μop blocking instruction for every functional-unit port combination
    (the paper's §5.1.1 assumption). Returns (uarch, isa, truth) where
    ``truth[name]`` is the port-usage multiset {frozenset: count}."""
    from repro_torch.core.isa import GPR, InstrSpec, op  # noqa: PLC0415

    rng = _random.Random(seed)
    n_pc = rng.randint(2, 4)
    pcs: list[frozenset] = []
    while len(pcs) < n_pc:
        k = rng.randint(1, min(3, len(ports)))
        pc = frozenset(rng.sample(ports, k))
        if pc not in pcs:
            # keep combinations either disjoint or strictly nested/overlapping
            pcs.append(pc)
    isa = ISA()
    behaviors: dict[str, InstrBehavior] = {}
    truth: dict[str, dict[frozenset, int]] = {}
    # blocking candidates: one 1-uop instr per combination
    for i, pc in enumerate(pcs):
        nm = f"BLK{i}"
        isa.add(InstrSpec(nm, nm, (op("op1", GPR, "w"), op("op2", GPR, "r"))))
        behaviors[nm] = beh(uop(pc, ("op2",), ("op1",)))
        truth[nm] = {pc: 1}
    # random multi-uop instructions over those combinations
    for i in range(n_instr):
        nm = f"INS{i}"
        k = rng.randint(1, 3)
        usage: dict[frozenset, int] = {}
        uops = []
        for j in range(k):
            pc = rng.choice(pcs)
            usage[pc] = usage.get(pc, 0) + 1
            reads = ("op2",) if j == 0 else (f"%{j-1}",)
            writes = ("op1",) if j == k - 1 else (f"%{j}",)
            uops.append(uop(pc, reads, writes, rng.randint(1, 4)))
        isa.add(InstrSpec(nm, nm, (op("op1", GPR, "w"), op("op2", GPR, "r"))))
        behaviors[nm] = InstrBehavior(tuple(uops))
        truth[nm] = usage
    ua = UArch(f"rand{seed}", ports, 6, behaviors, overhead_cycles=50)
    return ua, isa, truth
