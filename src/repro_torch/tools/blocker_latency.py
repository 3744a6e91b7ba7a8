"""The VPU, SFU and LSU blockers against a bound that counts their latency,
on one NVIDIA GPU.

    PYTHONPATH=src python3 -m repro_torch.tools.blocker_latency \\
        [--reps 200] [--out FILE]

At the reference's default sizes (8 rows of 128, so 1,024 threads on 4 of
the card's SMs) the VPU and SFU blockers are chains of dependent steps, and
a throughput bound (the steps over the whole card's FP32 or MUFU rate)
says nothing about them.  This script times each blocker's kernel, device
ms a launch with ``--reps`` launches back to back behind a spin, at several
chain lengths: VPU ``iters`` 0, 256, 1024, 4096, 16384; SFU 0, 128, 512,
2048, 8192; LSU at 8 and 4,096 rows.  A least-squares line through the
chain lengths gives each step's latency (ns, and cycles at the card's
maximum SM clock, as ``nvidia-smi`` reports it) and the fixed cost of a
launch (``iters`` 0: the launch, one load and one store of each element).
The latency bound of the default size is the default chain's steps times
the step's latency; its share of the kernel's time is printed without and
with the fixed cost added.  LSU's bound is its bytes (8 an element over the
published 3.35 TB/s), held against the time above the 8-row launch too.
Prints a line a unit, the card's name and power limit, and writes the
readings as JSON to ``--out``.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import microbench as mb
from repro_torch.kernels._build import build_dir

HBM_BYTES_PER_S = 3.35e12
CHAINS = {"VPU": (256, [0, 256, 1024, 4096, 16384]),
          "SFU": (128, [0, 128, 512, 2048, 8192])}


def _device_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise SystemExit("blocker_latency: the spin ended before the "
                         "launches were queued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _line(xs, ys):
    """Least-squares slope and intercept."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return slope, my - slope * mx


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default=str(build_dir() / "blocker_latency.json"))
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("blocker_latency: needs an NVIDIA GPU")
    query = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit, mhz = (v.strip() for v in query.split(","))
    ghz = float(mhz) / 1e3
    out = {"device": f"{name}, {limit} W", "sm_clock_max_ghz": ghz}
    for unit, (default, iters) in CHAINS.items():
        fn = mb.INNER[unit][0]
        ms = {}
        for it in iters:
            x, _ = mb.blocker_inputs(unit, "cuda", iters=it, rows=8)
            ms[it] = _device_ms(lambda: fn(x, it), opt.reps)
        chain = [it for it in iters if it > 0]
        slope, icept = _line(chain, [ms[it] for it in chain])
        step_ns = slope * 1e6
        bound = default * slope
        row = {"device_ms": ms, "step_ns": step_ns,
               "step_cycles": step_ns * ghz, "fixed_ms": ms[0],
               "fit_intercept_ms": icept, "default_iters": default,
               "default_ms": ms[default], "latency_bound_ms": bound,
               "share": bound / ms[default],
               "share_with_fixed": (bound + ms[0]) / ms[default]}
        out[unit] = row
        print(f"[latency] {unit} (8 rows): " + ", ".join(
            f"iters {k} {v:.5f} ms" for k, v in ms.items())
            + f"; a step {step_ns:.3f} ns ({row['step_cycles']:.2f} cycles "
            f"at {ghz:.3f} GHz); default ({default} iters) {ms[default]:.5f}"
            f" ms against a latency bound of {bound:.5f} ms (share "
            f"{row['share']:.3f}; with the fixed {ms[0]:.5f} ms, "
            f"{row['share_with_fixed']:.3f})", flush=True)
    lsu = {}
    for rows in (8, 4096):
        (x,) = mb.blocker_inputs("LSU", "cuda", rows=rows)
        lsu[rows] = _device_ms(lambda: mb.lsu_stream(x), opt.reps)
    bound = 4096 * 128 * 8 / HBM_BYTES_PER_S * 1e3
    out["LSU"] = {"device_ms": lsu, "bytes_bound_ms": bound,
                  "share": bound / lsu[4096],
                  "share_above_fixed": bound / (lsu[4096] - lsu[8])}
    print(f"[latency] LSU: 8 rows {lsu[8]:.5f} ms, 4096 rows "
          f"{lsu[4096]:.5f} ms against a byte bound of {bound:.5f} ms "
          f"(share {out['LSU']['share']:.3f}; of the time above 8 rows' "
          f"{out['LSU']['share_above_fixed']:.3f})", flush=True)
    print(f"{name}, {limit} W", flush=True)
    Path(opt.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opt.out).write_text(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
