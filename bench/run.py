"""Run one cell of the benchmark once and print its result line.

    python bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds the program (``src/repro_torch``),
on a machine with the cards the cell asks for.  The last line of standard
output is the result's JSON object; the numbers that decide ``correct``
follow on standard error, each beside its limit.  Exits 1 without a result
when the run cannot give one (no card, too few cards, the program missing,
JAX or the JAX package loaded).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    harness.set_cache_dirs(ROOT)
    try:
        result, lines = harness.run(args.workload, args.seed, args.seconds,
                                    bool(args.trace), t_start=T_START)
    except harness.RunError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    bad = harness.forbidden_modules()      # the window has closed
    if bad:
        print(f"bench: modules loaded in the run: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
