"""Generate the dry-run table from the memory-variant records (both
meshes): per-cell HBM fit, collective schedule summary, trace times.

The port of the reference package's ``repro.analysis.report``, fitting
the H100 SXM's 80 GB (``H100_SXM["hbm_bytes"]``) in place of the v5e's
16 GB.  The port compiles nothing: its records' ``compile_s`` is 0, and
the last column is the fake trace's ``lower_s``.  Run:
``PYTHONPATH=src python -m repro_torch.analysis.report``
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.analysis.roofline import DRYRUN_DIR
from repro_torch.core.uarch import H100_SXM

HBM = H100_SXM["hbm_bytes"]  # 80 GB a GPU


def dryrun_table(mesh: str = "single", variant: str = "memory",
                 dryrun_dir: Path = DRYRUN_DIR) -> str:
    rows = []
    for f in sorted(Path(dryrun_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("mesh") != mesh or rec.get("variant") != variant:
            continue
        if rec.get("tag"):
            continue
        ma = rec.get("memory_analysis", {})
        args_gb = ma.get("argument_size_in_bytes", 0) / 1e9
        temp_gb = ma.get("temp_size_in_bytes", 0) / 1e9
        tot = args_gb + temp_gb
        coll = rec.get("collectives", {}).get("count", {})
        coll_s = " ".join(f"{k}:{v}" for k, v in sorted(coll.items()))
        fits = "yes" if tot < HBM / 1e9 else "**NO**"
        status = "ok" if rec.get("ok") else "FAIL"
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {status} | {args_gb:.2f} | "
            f"{temp_gb:.2f} | {fits} | {coll_s} | "
            f"{rec.get('lower_s', 0) + rec.get('compile_s', 0):.0f}s |")
    hdr = (f"| arch | shape | trace | args GB/dev | temp GB/dev | "
           f"fits {HBM / 1e9:.0f}GB | collectives (count) | trace time |\n"
           "|---|---|---|---|---|---|---|---|")
    return hdr + "\n" + "\n".join(rows)


if __name__ == "__main__":
    import sys

    mesh = sys.argv[1] if len(sys.argv) > 1 else "single"
    print(dryrun_table(mesh=mesh))
