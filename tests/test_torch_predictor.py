"""The port's scalar predictor (``repro_torch.core.predictor``) against the
reference's on all three simulated uarches.

Models come from each package's ``Campaign`` over the reference tests'
``NAMES`` subset (``tests/test_predict_device.py``) plus the variants that
``tests/test_predictor.py``'s cases use; the two packages' model XML must
be byte-identical.  Every prediction is compared as the exact bits of
every float field, and the cases of ``tests/test_predictor.py`` are
repeated on the port with the reference's own assertions."""
import pickle
import random
import struct

import pytest

from repro.core import model_io as r_io
from repro.core import predictor as r_pred
from repro.core.engine import Campaign as RCampaign
from repro.core.isa import TEST_ISA as R_ISA
from repro.core.simulator import Instr as RInstr
from repro.core.simulator import SimMachine as RSim
from repro.core.uarch import SIM_UARCHES as R_UARCHES
from repro_torch.core import model_io as p_io
from repro_torch.core import predictor as p_pred
from repro_torch.core.engine import Campaign as PCampaign
from repro_torch.core.isa import TEST_ISA as P_ISA
from repro_torch.core.machine import RegPool, independent_seq, measure
from repro_torch.core.simulator import Instr as PInstr
from repro_torch.core.simulator import SimMachine as PSim
from repro_torch.core.uarch import SIM_UARCHES as P_UARCHES
from repro_torch.service.workload import random_blocks

NAMES = ["ADD_R64_R64", "IMUL_R64_R64", "MUL_R64", "ADC_R64_R64", "CMC",
         "TEST_R64_R64", "SHLD_R64_R64_I8", "MOVQ2DQ_X_X", "AESDEC_X_X",
         "PSHUFD_X_X", "PADDD_X_X", "MOV_R64_M64"]
# what tests/test_predictor.py's cases use beyond NAMES
CASE_NAMES = ["MOV_M64_R64", "MULPS_X_X", "PCMPGTQ_X_X"]
UARCHES = sorted(R_UARCHES)


@pytest.fixture(scope="module")
def models():
    """``{uarch: (reference model, port model)}``."""
    names = NAMES + CASE_NAMES
    ref = RCampaign(instr_names=names).run(
        [RSim(ua, R_ISA) for ua in R_UARCHES.values()], R_ISA).models
    port = PCampaign(instr_names=names).run(
        [PSim(ua, P_ISA, backend="torch", device="cpu")
         for ua in P_UARCHES.values()], P_ISA).models
    return {n: (ref[n], port[n]) for n in UARCHES}


def _bits(p):
    """Exact bit pattern of every float field, and the rest of the
    prediction (the reference tests' ``_bits``, with the port order and
    the bottleneck)."""
    return (struct.pack("<4d", p.cycles, p.port_bound, p.latency_bound,
                        p.frontend_bound)
            + struct.pack(f"<{len(p.port_pressure)}d",
                          *p.port_pressure.values()),
            tuple(p.port_pressure), p.bottleneck)


def _r(code):
    """A port block as the reference's Instr objects."""
    return [RInstr(i.spec, dict(i.regs), i.value_hint) for i in code]


def _both(uarch, models, code, legacy=False):
    """The reference's and the port's prediction of one block, compared
    bit for bit; returns the port's."""
    ref_model, port_model = models[uarch]
    if legacy:
        ref = r_pred.LegacyAnalyzer(ref_model, R_ISA).predict(_r(code))
        got = p_pred.LegacyAnalyzer(port_model, P_ISA).predict(code)
    else:
        ref = r_pred.predict(ref_model, R_ISA, _r(code))
        got = p_pred.predict(port_model, P_ISA, code)
    assert _bits(got) == _bits(ref), (uarch, code)
    return got


@pytest.mark.parametrize("uarch", UARCHES)
def test_models_are_byte_identical(models, uarch):
    ref, port = models[uarch]
    assert p_io.to_xml(port, P_ISA) == r_io.to_xml(ref, R_ISA)
    assert set(port.instructions) == set(NAMES + CASE_NAMES)


@pytest.mark.parametrize("legacy", [False, True], ids=["predict", "legacy"])
@pytest.mark.parametrize("uarch", UARCHES)
def test_random_blocks_bit_identical(models, uarch, legacy):
    _, port_model = models[uarch]
    for seed in (101, 102):
        for code in random_blocks(port_model, P_ISA, 40, seed=seed,
                                  max_len=8):
            _both(uarch, models, code, legacy)


@pytest.mark.parametrize("uarch", UARCHES)
def test_helpers_equal_the_reference(models, uarch):
    """``check_block``, ``missing_specs``, ``sum_usage``,
    ``port_pressure``, ``_latency_bound`` and ``classify_bottleneck`` give
    the reference's values, dict order included."""
    ref_model, port_model = models[uarch]
    for code in random_blocks(port_model, P_ISA, 30, seed=7, max_len=8):
        rc = _r(code)
        p_pred.check_block(port_model, code, P_ISA)
        assert p_pred.missing_specs(port_model, code) == []
        pu, pn = p_pred.sum_usage(port_model, code)
        ru, rn = r_pred.sum_usage(ref_model, rc)
        assert pn == rn
        assert [(sorted(k), v) for k, v in pu.items()] == \
            [(sorted(k), v) for k, v in ru.items()]
        assert list(p_pred.port_pressure(pu).items()) == \
            list(r_pred.port_pressure(ru).items())
        assert p_pred._latency_bound(port_model, P_ISA, code) == \
            r_pred._latency_bound(ref_model, R_ISA, rc)
    rng = random.Random(3)
    for _ in range(50):
        args = [rng.choice([0.0, 1.0, 2.5, 3.0]) for _ in range(3)]
        assert p_pred.classify_bottleneck(*args) == \
            r_pred.classify_bottleneck(*args)


# -- tests/test_predictor.py's cases, on the port, against the reference --

@pytest.mark.parametrize("uarch", UARCHES)
def test_port_bound_dominates_independent_alu(models, uarch):
    code = [PInstr("IMUL_R64_R64", {"op1": f"R{i}", "op2": f"R{i + 8}"})
            for i in range(3)]
    p = _both(uarch, models, code)
    if uarch == "sim_skl":
        assert p.port_bound == pytest.approx(3.0)  # 3 μops, only p1
        assert p.bottleneck == "ports"


@pytest.mark.parametrize("uarch", UARCHES)
def test_latency_bound_dominates_chain(models, uarch):
    p = _both(uarch, models,
              [PInstr("IMUL_R64_R64", {"op1": "R0", "op2": "R1"})])
    assert p.latency_bound == pytest.approx(3.0)
    assert p.cycles == pytest.approx(3.0)


@pytest.mark.parametrize("uarch", UARCHES)
def test_frontend_bound(models, uarch):
    code = [PInstr("ADD_R64_R64", {"op1": f"R{i}", "op2": f"R{i + 8}"})
            for i in range(8)]
    p = _both(uarch, models, code)
    if uarch == "sim_skl":
        assert p.cycles == pytest.approx(2.0)


def test_per_pair_latency_pays_off_aesdec(models):
    code = [PInstr("PCMPGTQ_X_X", {"op1": "X0", "op2": "X0"}),
            PInstr("AESDEC_X_X", {"op1": "X0", "op2": "X1"}),
            PInstr("PSHUFD_X_X", {"op1": "X1", "op2": "X0"})]
    p = _both("sim_snb", models, code)
    assert p.latency_bound <= 2.5
    pl = _both("sim_snb", models, code, legacy=True)
    assert pl.latency_bound >= 8.0
    machine = PSim(P_UARCHES["sim_snb"], P_ISA, backend="torch",
                   device="cpu")
    assert measure(machine, code).cycles == pytest.approx(p.cycles, abs=0.6)


@pytest.mark.parametrize("uarch", UARCHES)
def test_legacy_ignores_flags_cmc(models, uarch):
    code = [PInstr("CMC", {})]
    ours = _both(uarch, models, code)
    legacy = _both(uarch, models, code, legacy=True)
    assert ours.cycles == pytest.approx(1.0, abs=0.05)
    assert legacy.cycles < ours.cycles


@pytest.mark.parametrize("uarch", UARCHES)
def test_legacy_ignores_memory_dependence(models, uarch):
    code = [PInstr("MOV_M64_R64", {"mem": "RB0", "op1": "R1"}),
            PInstr("MOV_R64_M64", {"op1": "R1", "mem": "RB0"})]
    ours = _both(uarch, models, code)
    legacy = _both(uarch, models, code, legacy=True)
    assert ours.latency_bound > legacy.latency_bound


def test_prediction_matches_machine_throughput(models):
    machine = PSim(P_UARCHES["sim_skl"], P_ISA, backend="torch",
                   device="cpu")
    for name in ("ADD_R64_R64", "PADDD_X_X", "IMUL_R64_R64", "MULPS_X_X"):
        code = independent_seq(P_ISA[name], RegPool(), 8)
        pred = _both("sim_skl", models, code)
        assert measure(machine, code).cycles == \
            pytest.approx(pred.cycles, rel=0.25), name


@pytest.mark.parametrize("uarch", UARCHES)
def test_port_pressure_reported(models, uarch):
    p = _both(uarch, models,
              [PInstr("MOVQ2DQ_X_X", {"op1": "X0", "op2": "X1"})])
    if uarch == "sim_skl":
        assert p.port_pressure["0"] > 1.0  # 1 pinned + share of p015


@pytest.mark.parametrize("uarch", UARCHES)
def test_unknown_instruction_raises_typed_error(models, uarch):
    ref_model, port_model = models[uarch]
    code = [PInstr("ADD_R64_R64", {"op1": "R0", "op2": "R1"}),
            PInstr("LFENCE", {}),
            PInstr("JMP_R64", {"op1": "R2"})]
    with pytest.raises(r_pred.UnknownInstructionError) as want:
        r_pred.predict(ref_model, R_ISA, _r(code))
    with pytest.raises(p_pred.UnknownInstructionError) as ei:
        p_pred.predict(port_model, P_ISA, code)
    assert ei.value.missing == want.value.missing == ["JMP_R64", "LFENCE"]
    assert str(ei.value) == str(want.value)
    assert isinstance(ei.value, KeyError)
    assert p_pred.missing_specs(port_model, code) == \
        r_pred.missing_specs(ref_model, _r(code))
    with pytest.raises(p_pred.UnknownInstructionError):
        p_pred.LegacyAnalyzer(port_model, P_ISA).predict(code)
    e = pickle.loads(pickle.dumps(ei.value))
    assert e.missing == ei.value.missing and e.uarch == uarch
