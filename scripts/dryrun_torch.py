"""The port's dry-run sweep and its tables: every runnable (arch × shape)
cell on the 256- and 512-rank production meshes, on fake tensors, then the
HBM-fit table (``analysis.report.dryrun_table``) of each mesh and the
three-term roofline (``analysis.roofline.markdown_table``) of the ``cost``
records.

Each cell runs ``repro_torch.launch.dryrun.run_cell`` (its own ``fake``
process group) in one of ``--jobs`` worker processes and writes its record
under ``--out-dir`` (default ``experiments/dryrun_torch/``).  No card is
needed; ``--device-type cuda`` (the default) makes fake CUDA tensors.
Exits 1 if any cell failed, as ``launch.dryrun`` does.

  PYTHONPATH=src python scripts/dryrun_torch.py --arch smollm_360m \\
      --shape decode_32k --device-type cpu
  PYTHONPATH=src python scripts/dryrun_torch.py --all --mesh both \\
      --device-type cpu --jobs 4
"""
import argparse
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis.report import dryrun_table  # noqa: E402
from repro_torch.analysis.roofline import (full_table,  # noqa: E402
                                           markdown_table)
from repro_torch.configs.base import runnable_cells  # noqa: E402
from repro_torch.launch.dryrun import OUT_DIR, run_cell  # noqa: E402


def _run(job):
    arch, shape, multi, variant, out_dir, device_type = job
    rec = run_cell(arch, shape, multi, variant, out_dir,
                   device_type=device_type)
    return (arch, shape, "multi" if multi else "single", variant,
            rec["ok"], rec.get("error", ""), rec["total_s"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every runnable cell")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--variant", choices=["memory", "cost", "both"],
                    default="memory")
    ap.add_argument("--device-type", choices=["cuda", "cpu"],
                    default="cuda")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out-dir", type=Path, default=OUT_DIR)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all, or --arch and --shape")

    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    variants = (["memory", "cost"] if args.variant == "both"
                else [args.variant])
    jobs = [(a, s, m, v, args.out_dir, args.device_type)
            for v in variants for m in meshes for a, s in cells]
    t0 = time.time()
    if args.jobs > 1:
        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing
                                 .get_context("spawn")) as pool:
            results = list(pool.map(_run, jobs))
    else:
        results = [_run(j) for j in jobs]

    print(f"\n## cells ({time.time() - t0:.0f} s)\n")
    print("| arch | shape | mesh | variant | ok | seconds | error |\n"
          "|---|---|---|---|---|---|---|")
    for arch, shape, mesh, variant, ok, err, secs in results:
        print(f"| {arch} | {shape} | {mesh} | {variant} | "
              f"{'ok' if ok else 'FAIL'} | {secs:.1f} | {err[:160]} |")
    for variant in variants:
        for mesh in ("single", "multi"):
            if [m for m in meshes if ("multi" if m else "single") == mesh]:
                print(f"\n## HBM fit, {mesh} mesh, {variant} variant\n")
                print(dryrun_table(mesh, variant, dryrun_dir=args.out_dir))
    if "cost" in variants:
        for mesh in ("single", "multi"):
            rows = full_table("cost", mesh, chips=512 if mesh == "multi"
                              else 256, dryrun_dir=args.out_dir)
            if rows:
                print(f"\n## roofline, {mesh} mesh (H100 SXM)\n")
                print(markdown_table(rows))
    n_fail = sum(1 for r in results if not r[4])
    print(f"\n[dryrun] done, failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
