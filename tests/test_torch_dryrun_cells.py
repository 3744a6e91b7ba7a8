"""Production cells of the port's dry run beside the reference's, on the
CPU: ``smollm_360m decode_32k`` and ``phi3_5_moe_42b decode_32k`` (the
``cost`` variant) and ``smollm_360m train_4k`` (15 heads on 16 model
ranks: the regression test of the unflatten in attention's backward), on
the (16, 16) mesh of a fake 256-rank group, fake tensors on the CPU.

The port's cells run in one child process (``launch.dryrun.run_cell``);
the reference's ``run_cell`` in another, on 512 forced XLA host devices,
at the same time.  The reference's train cell is its ``memory`` variant
(4 microbatches, scans kept): its ``cost`` variant unrolls 32 layers and
takes XLA ~220 s to compile on this CPU.  Argument bytes do not depend on
the variant.

Required: ``ok`` on both sides; the analytic counters of the roofline
(``model_flops``, ``model_bytes``) equal; and argument bytes a device
equal to the reference's.  XLA pads an unevenly sharded dimension to the
largest shard, which DTensor's rank 0 also holds; none of these cells'
arguments is sharded unevenly (every sharded dimension divides by 16), so
the bytes agree exactly.

Printed side by side, not asserted: FLOPs (the port counts
``torch.utils.flop_counter``'s matrix products, attention and
convolutions; XLA's ``cost_analysis`` counts elementwise work too),
bytes accessed (both unfused operand+result sums, over different op
sets), temp bytes (XLA's buffer assignment against the peak of the
storages eager autograd holds) and the collectives (DTensor and XLA's
SPMD partitioner do not choose the same collectives: the port gathers
what XLA's partitioner reshards in place, and its layer loops are
unrolled where the reference's ``memory`` variant keeps a scan whose
body XLA counts once).
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from torch_mesh_util import SRC, run_py

PORT = [("smollm_360m", "decode_32k", "cost"),
        ("phi3_5_moe_42b", "decode_32k", "cost"),
        ("smollm_360m", "train_4k", "cost")]
REF_VARIANT = {"train_4k": "memory"}

PORT_RUN = """
import sys
from pathlib import Path
from repro_torch.launch.dryrun import run_cell
for arch, shape, variant in %r:
    run_cell(arch, shape, False, variant, out_dir=Path(sys.argv[1]),
             device_type="cpu")
"""

REF_RUN = """
import sys
from pathlib import Path
from repro.launch.dryrun import run_cell
for arch, shape, variant in %r:
    run_cell(arch, shape, False, variant, out_dir=Path(%r))
print("REF_OK")
"""


def _name(arch, shape, variant):
    return f"{arch}__{shape}__single__{variant}.json"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_cells")
    port_dir, ref_dir = tmp / "port", tmp / "ref"
    ref_cells = [(a, s, REF_VARIANT.get(s, v)) for a, s, v in PORT]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_py, REF_RUN % (ref_cells, str(ref_dir)), 512,
                          600)
        port = subprocess.run([sys.executable, "-c", PORT_RUN % (PORT,),
                               str(port_dir)], env=env, capture_output=True,
                              text=True, timeout=600)
        assert port.returncode == 0, port.stderr[-3000:]
        assert "REF_OK" in ref.result()
    out = {}
    for (a, s, v), (_, _, rv) in zip(PORT, ref_cells):
        out[(a, s)] = (json.loads((port_dir / _name(a, s, v)).read_text()),
                       json.loads((ref_dir / _name(a, s, rv)).read_text()))
    return out


CELLS = [(a, s) for a, s, _ in PORT]


def _side_by_side(port, ref):
    pm, rm = port["memory_analysis"], ref["memory_analysis"]
    pc, rc = port["cost_analysis"], ref["cost_analysis"]
    print(f"{port['arch']} {port['shape']}: port / reference")
    for what, p, r in (
            ("flops", pc["flops"], rc.get("flops")),
            ("bytes accessed", pc["bytes accessed"],
             rc.get("bytes accessed")),
            ("temp bytes", pm["temp_size_in_bytes"],
             rm["temp_size_in_bytes"]),
            ("collectives", port["collectives"]["count"],
             ref["collectives"]["count"]),
            ("wire bytes", port["collectives"]["total_wire_bytes"],
             ref["collectives"]["total_wire_bytes"])):
        print(f"  {what}: {p} / {r}")


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_cell_runs_on_both_sides_with_the_references_arguments(records,
                                                               cell):
    port, ref = records[cell]
    _side_by_side(port, ref)
    assert port["ok"], port.get("error")
    assert ref["ok"], ref.get("error")
    assert port["memory_analysis"]["argument_size_in_bytes"] == \
        ref["memory_analysis"]["argument_size_in_bytes"]
    assert port["cost_analysis"]["flops"] > 0
    assert port["compile_s"] == 0 and port["lower_s"] > 0


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_analytic_counters_and_schema_are_the_references(records, cell):
    from repro.analysis import roofline as RF

    from repro_torch.analysis import roofline as PR
    port, ref = records[cell]
    mine, theirs = PR.roofline(port), RF.roofline(ref)
    for key in ("model_flops", "model_bytes"):
        assert mine[key] == theirs[key], key
    assert set(ref) - set(port) == {"hlo_bytes"}
    assert set(port["memory_analysis"]) == \
        set(ref["memory_analysis"]) - {"generated_code_size_in_bytes"}
    assert set(port["collectives"]) == set(ref["collectives"])
    assert sum(port["collective_links"].values()) == pytest.approx(
        port["collectives"]["total_wire_bytes"])


def test_train_step_aliases_its_parameters_and_moments(records):
    port, _ = records[("smollm_360m", "train_4k")]
    ma = port["memory_analysis"]
    # parameters (f32) and the two f32 moments, updated in place
    assert ma["alias_size_in_bytes"] > 0
    assert ma["alias_size_in_bytes"] <= ma["argument_size_in_bytes"]
    assert ma["temp_size_in_bytes"] > ma["argument_size_in_bytes"]


def test_no_rank_holds_the_whole_batchs_logits(records):
    """The gather CE's (B, 512, V) f32 logits of one sequence chunk, for
    the global batch, exceed a rank's whole temp: each rank computes its
    own rows' (batch over ``data``, vocab over ``model``)."""
    from repro_torch.configs.base import SHAPES, load_config
    port, _ = records[("smollm_360m", "train_4k")]
    cfg = load_config("smollm_360m")
    whole_chunk = SHAPES["train_4k"].global_batch * 512 * cfg.vocab_padded * 4
    assert port["memory_analysis"]["temp_size_in_bytes"] < whole_chunk
