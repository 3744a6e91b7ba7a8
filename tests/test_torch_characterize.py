"""End to end against the reference package: characterizations driven
through the port (its ``torch`` backend on the CPU) export model XML and
JSON byte-identical to the reference's — on ``sim_skl`` with the
conftest subset against the reference's ``numpy`` backend, on a few
names against its ``pallas`` backend (the TPU kernel in interpret mode),
as campaigns over ``sim_hsw``/``sim_snb``, and under a seeded
``REPRO_FAULTS`` plan with the same quarantined experiments.

JSON is compared with ``run_seconds`` set to 0 on both sides: it is the
one wall-clock field of the export."""
import re

import pytest
from conftest import CHAR_SUBSET

from repro.core import model_io as r_io
from repro.core.batch_sim import BatchSimMachine as RBatch
from repro.core.characterize import characterize as r_characterize
from repro.core.engine import Campaign as RCampaign
from repro.core.engine import MeasurementEngine as REngine
from repro.core.isa import TEST_ISA as R_ISA
from repro.core.simulator import SimMachine as RSim
from repro.core.uarch import SIM_UARCHES as R_UARCHES
from repro.faults import plan as r_faults
from repro_torch.core import model_io as p_io
from repro_torch.core.batch_sim import BatchSimMachine as PBatch
from repro_torch.core.characterize import characterize as p_characterize
from repro_torch.core.engine import Campaign as PCampaign
from repro_torch.core.engine import MeasurementEngine as PEngine
from repro_torch.core.isa import TEST_ISA as P_ISA
from repro_torch.core.simulator import SimMachine as PSim
from repro_torch.core.uarch import SIM_UARCHES as P_UARCHES
from repro_torch.faults import plan as p_faults


def _port_machine(name):
    return PSim(P_UARCHES[name], P_ISA, backend="torch", device="cpu")


def _json(io, model):
    model.run_seconds = 0.0
    return io.to_json(model)


def _assert_same_model(ref, port):
    assert p_io.to_xml(port, P_ISA) == r_io.to_xml(ref, R_ISA)
    assert _json(p_io, port) == _json(r_io, ref)


def test_char_subset_on_skl_equals_reference_numpy():
    ref = r_characterize(REngine(RSim(R_UARCHES["sim_skl"], R_ISA,
                                      backend="numpy")), R_ISA, CHAR_SUBSET)
    m = _port_machine("sim_skl")
    port = p_characterize(PEngine(m), P_ISA, CHAR_SUBSET)
    _assert_same_model(ref, port)
    assert len(port.instructions) == len(CHAR_SUBSET)
    st = m.device_stats()
    assert st["backend"] == "torch" and st["kernel_calls"] > 0


def test_few_names_equal_reference_pallas_interpret():
    pytest.importorskip("jax")
    names = ["ADD_R64_R64", "DIV_R64", "MOVQ2DQ_X_X"]
    ref = r_characterize(REngine(RSim(R_UARCHES["sim_skl"], R_ISA,
                                      backend="pallas")), R_ISA, names)
    port = p_characterize(PEngine(_port_machine("sim_skl")), P_ISA, names)
    _assert_same_model(ref, port)


CAMPAIGN_NAMES = ["ADD_R64_R64", "MUL_R64", "ADC_R64_R64", "SHLD_R64_R64_I8",
                  "MOV_R64_M64", "PSHUFD_X_X"]


def test_campaign_on_hsw_and_snb_equals_reference():
    names = sorted(set(R_UARCHES) - {"sim_skl"})
    ref = RCampaign(instr_names=CAMPAIGN_NAMES).run(
        [RSim(R_UARCHES[n], R_ISA, backend="numpy") for n in names], R_ISA)
    machines = [_port_machine(n) for n in names]
    port = PCampaign(instr_names=CAMPAIGN_NAMES).run(machines, P_ISA)
    assert sorted(port.models) == names
    for n in names:
        _assert_same_model(ref.models[n], port.models[n])
    for m in machines:      # the campaign placement kept them on the CPU
        assert str(m._batch.device) == "cpu"
        assert m.device_stats()["kernel_calls"] > 0
    assert port.quarantined == 0


def _records(res):
    return {u: sorted((r["uarch"], r["cache_key"], r["code"],
                       # the occurrence index counts fault checks, and the
                       # reference's degradation chain checks once more
                       # per failed chunk than the port, which has none
                       re.sub(r"#\d+", "#N", r["error"])) for r in recs)
            for u, recs in res.quarantine.items()}


def test_seeded_faults_quarantine_the_same_experiments():
    """Batched machines with ``min_lanes=1``, so that every sub-wave of the
    engine's bisecting retry reaches a kernel and its fault check."""
    spec = "seed=1337;wave.kernel:raise:p=0.08;wave.kernel:raise:match=AESDEC"
    names = ["ADD_R64_R64", "AESDEC_X_X"]
    results = []
    for faults, campaign, machine in (
            (r_faults, RCampaign,
             lambda: RBatch(R_UARCHES["sim_skl"], R_ISA, backend="numpy",
                            min_lanes=1)),
            (p_faults, PCampaign,
             lambda: PBatch(P_UARCHES["sim_skl"], P_ISA, backend="torch",
                            device="cpu", min_lanes=1))):
        prev = faults.set_plan(faults.FaultPlan.from_spec(spec))
        try:
            with pytest.warns(UserWarning, match="quarantined"):
                results.append(campaign(instr_names=names).run(
                    [machine()], R_ISA if faults is r_faults else P_ISA))
        finally:
            faults.set_plan(prev)
    ref, port = results
    assert ref.quarantined > 1
    assert port.quarantined == ref.quarantined
    assert _records(port) == _records(ref)
    _assert_same_model(ref.models["sim_skl"], port.models["sim_skl"])
