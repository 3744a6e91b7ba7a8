"""Corpus pipeline CLI of the PyTorch port.

Usage (from the repo root)::

    PYTHONPATH=src python -m repro_torch.corpus generate \\
        --out experiments/corpus --seed 0 --blocks 10000
    PYTHONPATH=src python -m repro_torch.corpus evaluate \\
        --corpus experiments/corpus --wave-width 2048 \\
        --accuracy experiments/corpus_accuracy.json
    PYTHONPATH=src python -m repro_torch.corpus report \\
        experiments/corpus_accuracy.json

``generate`` is deterministic under a seed (the same corpus as
``python -m repro.corpus generate``); ``evaluate`` resumes per shard
(kill it, rerun it, finished shards are skipped) and runs on the card:
the wave backend is ``REPRO_SIM_BACKEND`` (default ``cuda``), the
placement ``REPRO_SIM_DEVICES`` (default every card; the predictor runs
on its first device) and the predict backend ``REPRO_PREDICT_BACKEND``
(default ``cuda``) — on the CPU, set
``REPRO_SIM_BACKEND=torch REPRO_SIM_DEVICES=cpu
REPRO_PREDICT_BACKEND=numpy``; ``report`` renders the accuracy artifact
(``scripts/analyze_torch.py --corpus-report`` prints the same tables).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.corpus",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="generate a seeded corpus")
    g.add_argument("--out", default="experiments/corpus")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--blocks", type=int, default=10_000,
                   help="blocks per uarch (default 10000)")
    g.add_argument("--uarch", action="append",
                   help="restrict to these uarches (repeatable)")
    g.add_argument("--shard-size", type=int, default=2048)
    g.add_argument("--min-len", type=int, default=2)
    g.add_argument("--max-len", type=int, default=12)

    e = sub.add_parser("evaluate", help="mega-wave ground truth + scoring")
    e.add_argument("--corpus", default="experiments/corpus")
    e.add_argument("--uarch", action="append")
    e.add_argument("--backend", default=None,
                   help="wave backend (default: REPRO_SIM_BACKEND, "
                        "else cuda)")
    e.add_argument("--wave-width", type=int, default=2048)
    e.add_argument("--no-resume", action="store_true",
                   help="ignore per-shard result files")
    e.add_argument("--accuracy", default="experiments/corpus_accuracy.json",
                   help="where to write the accuracy artifact")

    r = sub.add_parser("report", help="render an accuracy artifact")
    r.add_argument("accuracy", help="corpus_accuracy.json path")
    r.add_argument("--json", action="store_true", dest="as_json")

    args = ap.parse_args(argv)
    if args.cmd == "generate":
        from repro_torch.corpus import CorpusSpec, generate_corpus
        from repro_torch.core.uarch import SIM_UARCHES

        uarches = tuple(sorted(args.uarch or SIM_UARCHES))
        spec = CorpusSpec(seed=args.seed, blocks_per_uarch=args.blocks,
                          uarches=uarches, shard_size=args.shard_size,
                          min_len=args.min_len, max_len=args.max_len)
        manifest = generate_corpus(args.out, spec)
        print(f"corpus {manifest['corpus_id'][:12]}: "
              f"{manifest['total_blocks']} blocks in "
              f"{len(manifest['shards'])} shards -> {args.out}")
        return 0
    if args.cmd == "evaluate":
        from repro_torch.corpus import (evaluate_corpus, format_report,
                                        score_results)

        results = evaluate_corpus(args.corpus, uarches=args.uarch,
                                  backend=args.backend,
                                  wave_width=args.wave_width,
                                  resume=not args.no_resume)
        report = score_results(results)
        out = Path(args.accuracy)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, sort_keys=True, indent=1))
        print(format_report(report))
        print(f"\naccuracy artifact -> {out}")
        return 0
    # report
    report = json.loads(Path(args.accuracy).read_text())
    if args.as_json:
        print(json.dumps(report, sort_keys=True, indent=1))
    else:
        from repro_torch.corpus import format_report

        print(format_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
