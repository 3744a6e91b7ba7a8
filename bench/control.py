"""Readings that the limits of ``correct`` are set from, many seeds in one
process, each side against one plain float32 reference a seed:

* ``program``: the program's numbers, as a run's check computes them, on
  the cell's prompts (prefill: the pool's first ``check_batches``
  batches) or its check steps and the late step after them (train),
  without a measured window;
* ``control``: the plain reference one precision lower
  (``reference.common.Lowered``: fp8 GEMM operands, a bfloat16 SSD) in the
  program's place;
* ``half`` (train): the reference in the program's place with half of
  each batch left out, the mean taken over the rest.

    python bench/control.py --workload NAME --sides program,control --seeds 1,2,3

prints one JSON line a seed, with each side's ``correct`` as a run's gate
(``harness.verdict``) decides it against the cell's limits, and then, for
each side, the largest and smallest reading of each number.  The limits
in ``workloads/<cell>.json`` lie between the program's largest and the
smallest of a side that has to fail (``PERF.md``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(name: str, seed: int, sides, *, root: Path = ROOT,
             device: str = "cuda", config_override=None,
             traffic_override=None) -> dict:
    """{side: {number: reading}} of one seed."""
    import torch

    from bench import harness
    from bench.reference import common as C

    cs = harness.cell_spec(harness.load_json(root / "BENCHMARK.json"), name,
                           root)
    cell = harness.build(cs, seed, root=root, device=device,
                         config_override=config_override,
                         traffic_override=traffic_override)
    kind = harness.load_module(
        root / "bench" / "kinds" / f"{cs['work']['kind']}.py",
        f"bench.kinds.{cs['work']['kind']}")
    out = {}
    if cs["work"]["kind"] == "train":
        # the program's check steps and its late step (the step after
        # them) always run: the late step's state is where every side's
        # replay of it starts
        kind.setup(cell)
        prog = kind.program_readings(cell)
        late, before = kind.late_step(cell)
        cell.free_program()
        cell.weights = None
        exact = kind.reference_readings(cell)
        exact_late = kind.late_reference(cell, before)

        def numbers(ref, ref_late):
            return {**kind.compare(ref, exact),
                    **kind.late_numbers(ref_late, exact_late)}

        if "program" in sides:
            out["program"] = numbers(prog, late)
        if "control" in sides:
            lo = C.Lowered()
            out["control"] = numbers(kind.reference_readings(cell, lo),
                                     kind.late_reference(cell, before, lo))
        if "half" in sides:
            half = range(cell.traffic["batch"] // 2)
            out["half"] = numbers(
                kind.reference_readings(cell, rows=half),
                kind.late_reference(cell, before, rows=half))
        return out
    kind.setup(cell)
    ks = range(cell.traffic["check_batches"])
    kept = {}
    if "program" in sides:
        kept["program"] = [(k, *kind.unit(cell, k)) for k in ks]
    cell.free_program()
    exact = {k: kind.reference(cell, k) for k in ks}
    if "control" in sides:
        kept["control"] = [(k, *kind.reference(cell, k, C.Lowered()))
                           for k in ks]
    for side, rows in kept.items():
        out[side] = kind.compare(rows, exact.__getitem__)
    del kept, exact
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sides", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    harness.set_cache_dirs(ROOT)
    sides = args.sides.split(",")
    seen: dict = {}
    seeds = [int(s) for s in args.seeds.split(",")]
    limits = harness.load_json(
        ROOT / "bench" / "workloads" / f"{args.workload}.json")["limits"]
    for seed in seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, sides)
        correct = {side: harness.verdict(
            {"failed": 0}, {k: {"value": nums[k], "limit": v}
                            for k, v in limits.items()})
            for side, nums in r.items()}
        for side, nums in r.items():
            seen.setdefault(side, []).append(nums)
        print(json.dumps({"seed": seed, **r, "correct": correct,
                          "seconds": time.perf_counter() - t0}), flush=True)
    summary = {side: {k: [max(r[k] for r in rs), min(r[k] for r in rs)]
                      for k in rs[0]} for side, rs in seen.items()}
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "max_min": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
