"""The port's roofline and report against the reference's, on a record
the reference's dry run writes, on the CPU.

A child process (``run_py``, 512 forced XLA host devices) runs the
reference's ``run_cell`` on ``smollm_360m decode_32k`` (the ``cost``
variant, the single-pod mesh) into ``tmp_path``, and keeps the HLO text
that ``run_cell`` hands to ``parse_collectives``.  Then:

  * the port's ``parse_collectives`` (an exact copy) gives the reference's
    statistics on that HLO, equal to the record's ``collectives``;
  * ``roofline``, ``full_table`` and ``markdown_table`` equal the
    reference's functions on the same record with the TPU v5e's
    constants swapped for the H100's (``peak_bf16_flops``, ``hbm_bw``, and
    for ``ici_bw`` the InfiniBand link ``ib_bw``, which a record without
    the port's per-link split is divided by);
  * ``dryrun_table`` equals the reference's with ``HBM`` = 80 GB, column
    by column, except the header (the port's says "fits 80GB" and names
    the trace, not a compile) and the last column (the port shows
    ``lower_s + compile_s``: it compiles nothing).
"""
import json

import pytest

from torch_mesh_util import run_py

CELL = ("smollm_360m", "decode_32k")

REFERENCE = """
import sys
from pathlib import Path
import repro.analysis.hlo_stats as H
from repro.launch import dryrun
out = Path(sys.argv[1])
texts = []
parse = H.parse_collectives

def keep(text):
    texts.append(text)
    return parse(text)

H.parse_collectives = keep
rec = dryrun.run_cell(%r, %r, False, "cost", out_dir=out)
assert rec["ok"], rec.get("error")
(out / "cell.hlo").write_text(texts[0])
print("REF_OK")
""" % CELL


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_roofline")
    code = REFERENCE.replace("Path(sys.argv[1])", f"Path({str(tmp)!r})")
    assert "REF_OK" in run_py(code, 512, 480)
    rec = json.loads((tmp / f"{CELL[0]}__{CELL[1]}__single__cost.json")
                     .read_text())
    return tmp, rec, (tmp / "cell.hlo").read_text()


@pytest.fixture
def swapped(monkeypatch):
    """The reference's roofline and report modules with H100 constants."""
    import repro.analysis.report as RR
    import repro.analysis.roofline as RF

    from repro_torch.core.uarch import H100_SXM
    monkeypatch.setattr(RF, "TPU_V5E", {
        "peak_bf16_flops": H100_SXM["peak_bf16_flops"],
        "hbm_bw": H100_SXM["hbm_bw"], "ici_bw": H100_SXM["ib_bw"]})
    monkeypatch.setattr(RR, "HBM", H100_SXM["hbm_bytes"])
    return RF, RR


def test_parse_collectives_on_a_cells_hlo_is_the_references(reference):
    from repro.analysis.hlo_stats import parse_collectives as ref_parse

    from repro_torch.analysis.hlo_stats import parse_collectives
    _, rec, hlo = reference
    got = parse_collectives(hlo).to_dict()
    assert got == ref_parse(hlo).to_dict()
    assert got == rec["collectives"]
    assert got["count"]   # the cell has collectives to count


def test_roofline_is_the_references_with_h100_constants(reference, swapped):
    from repro_torch.analysis import roofline as PR
    from repro_torch.core.uarch import H100_SXM
    RF, _ = swapped
    _, rec, _ = reference
    for chips in (256, 512):
        assert PR.roofline(rec, chips) == RF.roofline(rec, chips)
    got = PR.roofline(rec)
    assert got["collective_s"] == \
        rec["collectives"]["total_wire_bytes"] / H100_SXM["ib_bw"]
    assert PR.roofline(dict(rec, ok=False)) is None


def test_full_and_markdown_tables_are_the_references(reference, swapped,
                                                     monkeypatch):
    from repro_torch.analysis import roofline as PR
    RF, _ = swapped
    tmp, _, _ = reference
    # the records' directory is load_records' default argument
    monkeypatch.setattr(RF.load_records, "__defaults__",
                        (tmp, *RF.load_records.__defaults__[1:]))
    for variant, mesh in (("cost", "single"), ("memory", "single"),
                          ("cost", "multi")):
        rows = PR.full_table(variant, mesh, dryrun_dir=tmp)
        assert rows == RF.full_table(variant, mesh)
        assert PR.markdown_table(rows) == RF.markdown_table(rows)
    assert len(PR.full_table("cost", "single", dryrun_dir=tmp)) == 1
    assert PR.load_records(tmp).keys() == {CELL}


def test_dryrun_table_is_the_references_with_80gb(reference, swapped,
                                                  monkeypatch):
    from repro_torch.analysis.report import dryrun_table
    _, RR = swapped
    tmp, rec, _ = reference
    monkeypatch.setattr(RR, "DRYRUN_DIR", tmp)
    got = dryrun_table("single", "cost", dryrun_dir=tmp).splitlines()
    want = RR.dryrun_table("single", "cost").splitlines()
    assert "fits 80GB" in got[0] and len(got) == len(want) == 3
    assert got[1] == want[1]
    row, ref_row = got[2].split("|"), want[2].split("|")
    assert row[:-2] == ref_row[:-2]
    assert row[-2].strip() == \
        f"{rec['lower_s'] + rec['compile_s']:.0f}s"
