"""Where the card's port-bound call starts to pay, on one NVIDIA GPU.

    PYTHONPATH=src python3 -m repro_torch.tools.port_bound_crossover \\
        [--reps 5] [--out FILE]

Characterizes the three simulated uarches on the card (a ``Campaign`` over
``TEST_ISA``).  For the first uarch of each distinct (C, S) of its min-cut
table, and for 32, 256, 1,024, 2,048 and 9,936 random blocks (seed 1241),
it takes host seconds of ``BatchPredictor._port_bounds`` on the ``cuda``
backend (packing the rows, the copy up, the kernel, the one copy back, the
division) against the ``numpy`` backend, in turns (cuda, numpy, numpy,
cuda) ``--reps`` times, and of ``_device_call`` alone on the packed rows;
it reports the medians.  The ``cuda`` predictor takes
``min_device_blocks=1``, so every count goes to the card in one launch;
served predictors keep ``MIN_DEVICE_BLOCKS``.  Both backends' bounds must
be equal (the script stops otherwise).  Prints a line a (uarch, count),
the card's name and power limit, and writes the readings as JSON to
``--out``.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels._build import build_dir
from repro_torch.tools.port_bound_ablation import ROWS, served_models

SEED = 1241


def _median(values):
    return sorted(values)[len(values) // 2]


def crossover(models, reps):
    """One reading a (uarch, count of blocks), as described above."""
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.predictor import sum_usage
    from repro_torch.service.batch_predictor import BatchPredictor
    from repro_torch.service.workload import random_blocks
    by_shape = {}
    for ua in sorted(models):
        bp = BatchPredictor(models[ua], TEST_ISA, backend="cuda",
                            min_device_blocks=1)
        by_shape.setdefault((len(bp._combos), bp._cut_mask.shape[1]),
                            (ua, bp))
    out = []
    for (C, S), (ua, bp) in sorted(by_shape.items()):
        host = BatchPredictor(models[ua], TEST_ISA, backend="numpy")
        blocks = random_blocks(models[ua], TEST_ISA, max(ROWS), seed=SEED)
        for n in ROWS:
            sums = {i: sum_usage(bp.model, list(b))
                    for i, b in enumerate(blocks[:n])}
            bp.launched_args = []
            if bp._port_bounds(sums) != host._port_bounds(sums):
                sys.exit(f"port_bound_crossover: {ua}, {n} blocks: the "
                         f"cuda backend's bounds differ from numpy's")
            if len(bp.launched_args) != 1:
                sys.exit(f"port_bound_crossover: {ua}, {n} blocks did not "
                         f"take the card in one launch")
            packed = bp.launched_args[0][0].cpu().numpy()
            bp.launched_args = None
            times = {"cuda": [], "numpy": [], "device_call": []}
            for _ in range(reps):
                for name in ("cuda", "numpy", "numpy", "cuda"):
                    t0 = time.perf_counter()
                    (bp if name == "cuda" else host)._port_bounds(sums)
                    times[name].append(time.perf_counter() - t0)
            for _ in range(reps):
                t0 = time.perf_counter()
                bp._device_call(packed)
                times["device_call"].append(time.perf_counter() - t0)
            med = {k: _median(v) for k, v in times.items()}
            out.append({"uarch": ua, "blocks": n, "device_rows": len(packed),
                        "C": C, "S": S, "cuda_s": med["cuda"],
                        "numpy_s": med["numpy"],
                        "device_call_s": med["device_call"],
                        "samples_s": times})
            print(f"[crossover] {ua} C={C} S={S} {n} blocks "
                  f"({len(packed)} device rows): _port_bounds cuda "
                  f"{med['cuda'] * 1e3:.3f} ms, numpy "
                  f"{med['numpy'] * 1e3:.3f} ms; _device_call "
                  f"{med['device_call'] * 1e3:.3f} ms (medians of "
                  f"{len(times['cuda'])})", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out",
                    default=str(build_dir() / "port_bound_crossover.json"))
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_bound_crossover: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    readings = crossover(served_models(), opt.reps)
    print(smi, flush=True)
    Path(opt.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opt.out).write_text(json.dumps({"device": smi,
                                         "readings": readings}, indent=1))


if __name__ == "__main__":
    main()
