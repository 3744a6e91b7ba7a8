"""The port's collective statistics against the reference's, on the CPU.

  * ``parse_collectives``, an exact copy, gives the reference's counts,
    result bytes and wire bytes on the HLO snippets of
    ``tests/test_hlo_stats.py`` (one line at a time and the whole module);
  * ``CollectiveRecorder`` on four gloo ranks
    (``torch_mesh_util.run_ranks``): one known collective of each kind
    (the functional all-gather, reduce-scatter, all-reduce and
    all-to-all, ``torch.distributed``'s all-reduce and all-gather, a
    send/recv ring, a DTensor redistribution), each counted once with its
    exact result bytes and the ``_wire`` bytes of its group's size, and
    the wire bytes split by link for nodes of two ranks;
  * ``launch.dryrun``'s ``main`` exits 1 and writes the failure record
    (``ok: false``, ``error``, ``traceback``) for a cell made to fail (an
    unknown config field), as the reference's does.

Run as ``python tests/test_torch_dryrun_recorder.py --rank ...`` this file
is one rank (``torch_mesh_util.rank_main``); it imports no jax then.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_mesh_util import SRC, rank_main, run_ranks

WORLD = 4
N = 6 * 4   # elements a rank contributes (divides over every group)


# ------------------------------------------------------------ the ranks
def _check_recorder(tmp: Path) -> dict:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.analysis.hlo_stats import CollectiveRecorder

    rank = dist.get_rank()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    model = mesh.get_group("model")     # ranks {0, 1} / {2, 3}: one node
    data = mesh.get_group("data")       # ranks {0, 2} / {1, 3}: two nodes
    x = torch.arange(N, dtype=torch.float32) + rank
    dt = distribute_tensor(torch.ones(8, N), mesh, [Shard(0), Replicate()])
    out = {}

    def record(name, fn):
        with CollectiveRecorder(node_size=2) as rec:
            got = fn()
        out[name] = {"stats": rec.stats.to_dict(), "links": rec.links}
        return got

    # "* 1" waits for the functional collective's result
    record("funcol_all_gather",
           lambda: funcol.all_gather_tensor(x, 0, model) * 1)
    record("funcol_reduce_scatter", lambda: funcol.reduce_scatter_tensor(
        x, "sum", 0, data) * 1)
    record("funcol_all_reduce",
           lambda: funcol.all_reduce(x, "sum", model) * 1)
    record("funcol_all_to_all", lambda: funcol.all_to_all_single(
        x, None, None, data) * 1)

    def c10d_all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y

    def c10d_all_gather():
        y = torch.empty(2 * N)
        dist.all_gather_into_tensor(y, x, group=data)
        return y

    def ring():
        got = torch.empty(N)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, (rank + 1) % WORLD),
            dist.P2POp(dist.irecv, got, (rank - 1) % WORLD)])
        for r in reqs:
            r.wait()
        return got

    record("c10d_all_reduce", c10d_all_reduce)
    record("c10d_all_gather", c10d_all_gather)
    out["ring_value"] = record("ring", ring)
    record("dtensor_gather", lambda: dt.redistribute(
        mesh, [Replicate(), Replicate()]).to_local())
    return out


CHECKS = {"recorder": _check_recorder}


# ----------------------------------------------------------------- tests
def test_parse_collectives_is_the_references():
    from repro.analysis import hlo_stats as ref
    from test_hlo_stats import SAMPLE

    from repro_torch.analysis import hlo_stats as port
    lines = [line for line in SAMPLE.splitlines() if "=" in line]
    for text in (SAMPLE, *lines, "%add = f32[4] add(%a, %b)\n", ""):
        assert port.parse_collectives(text).to_dict() == \
            ref.parse_collectives(text).to_dict(), text
        assert port._group_size(text) == ref._group_size(text)
    for dims, dtype in (("16,4096", "bf16"), ("", "f32"), ("3,5", "s4")):
        assert port._shape_bytes(dtype, dims) == ref._shape_bytes(dtype, dims)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    return run_ranks(Path(__file__), WORLD,
                     tmp_path_factory.mktemp("dryrun_recorder"), "recorder")


B = 4  # float32


# name -> (kind, result bytes on rank 0, group size, link for 2-rank nodes)
EXPECTED = {
    "funcol_all_gather": ("all-gather", 2 * N * B, 2, "nvlink"),
    "funcol_reduce_scatter": ("reduce-scatter", N // 2 * B, 2, "ib"),
    "funcol_all_reduce": ("all-reduce", N * B, 2, "nvlink"),
    "funcol_all_to_all": ("all-to-all", N * B, 2, "ib"),
    "c10d_all_reduce": ("all-reduce", N * B, WORLD, "ib"),
    "c10d_all_gather": ("all-gather", 2 * N * B, 2, "ib"),
    "ring": ("collective-permute", N * B, 2, "ib"),   # rank 3 -> rank 0
    "dtensor_gather": ("all-gather", 8 * N * B, 2, "ib"),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_recorder_counts_each_collective_once(recorded, name):
    from repro_torch.analysis.hlo_stats import _wire
    kind, rbytes, g, link = EXPECTED[name]
    got = recorded[name]
    assert got["stats"]["count"] == {kind: 1}
    assert got["stats"]["result_bytes"] == {kind: rbytes}
    wire = _wire(kind, rbytes, g)
    assert got["stats"]["wire_bytes"] == {kind: wire}
    assert got["stats"]["total_wire_bytes"] == wire
    assert got["links"] == {"nvlink": 0.0, "ib": 0.0, link: wire}


def test_recorded_ring_moved_the_previous_ranks_values(recorded):
    import torch
    assert torch.equal(recorded["ring_value"],
                       torch.arange(N, dtype=torch.float32) + WORLD - 1)


def test_main_exits_1_and_writes_the_failure_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm_360m", "--shape", "decode_32k", "--device-type", "cpu",
         "--cfg", "no_such_field=1", "--tag", "broken", "--out-dir",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "failures: 1" in proc.stdout
    rec = json.loads((tmp_path / "smollm_360m__decode_32k__single__memory"
                      "__broken.json").read_text())
    assert rec["ok"] is False and rec["tag"] == "broken"
    assert "no_such_field" in rec["error"]
    assert "Traceback" in rec["traceback"]
    assert rec["total_s"] > 0


if __name__ == "__main__":
    rank_main(CHECKS)
