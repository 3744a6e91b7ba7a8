"""Roofline report from the port's dry-run records: the three terms per
cell on the H100 SXM, dominant bottleneck, and the §Perf score
(ideal/bound fraction).

Run after a dry-run sweep:
  PYTHONPATH=src python scripts/dryrun_torch.py --all --variant cost
  PYTHONPATH=src python examples/roofline_report_torch.py [tag]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis.roofline import full_table, markdown_table  # noqa: E402

tag = sys.argv[1] if len(sys.argv) > 1 else ""
rows = full_table(variant="cost", tag=tag)
if not rows:
    print("no cost-variant dry-run records found under "
          "experiments/dryrun_torch")
    sys.exit(1)
print(markdown_table(rows))
worst = min(rows, key=lambda r: r["roofline_fraction"])
coll = max(rows, key=lambda r: r["collective_s"])
print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']} "
      f"({worst['roofline_fraction']:.3f})")
print(f"most collective-bound:   {coll['arch']}/{coll['shape']} "
      f"({coll['collective_s']:.2f}s wire)")
