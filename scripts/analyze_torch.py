#!/usr/bin/env python
"""uops-as-a-service CLI on the PyTorch/CUDA port: predict a basic block
on every characterized microarchitecture and print a per-uarch bottleneck
report.

Reads the textual block format (see repro_torch/service/protocol.py)::

    IMUL_R64_R64 op1=R0 op2=R1
    ADD_R64_R64 op1=R0 op2=R2

Usage:
    PYTHONPATH=src python scripts/analyze_torch.py block.txt
    echo "CMC" | PYTHONPATH=src python scripts/analyze_torch.py -
    PYTHONPATH=src python scripts/analyze_torch.py block.txt --uarch sim_skl
    PYTHONPATH=src python scripts/analyze_torch.py block.txt \
        --connect HOST:PORT

Without --connect, an in-process service is started over --models
(default: experiments/models — run examples/export_models_torch.py
first), predicting with the ``cuda`` kernel on ``cuda:0`` unless
``REPRO_PREDICT_BACKEND`` names another backend.

With --corpus-report, the argument is a corpus accuracy artifact
(experiments/corpus_accuracy.json, written by
``python -m repro_torch.corpus evaluate``) and the output is the
per-uarch MAPE / Kendall-τ / error-bucket tables from
repro_torch.corpus.score, exactly what scripts/analyze.py prints for the
same artifact::

    PYTHONPATH=src python scripts/analyze_torch.py --corpus-report \\
        experiments/corpus_accuracy.json

With --trace-report, the argument is a trace file written by
repro_torch.obs.export (Chrome trace-event JSON or JSONL) and the output is
the per-wave bottleneck report of repro_torch.analysis.wave_report, what
scripts/analyze.py --trace-report prints for the same file::

    PYTHONPATH=src python scripts/analyze_torch.py --trace-report \\
        run.trace.json --top-waves 10
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.service.client import (  # noqa: E402
    ServiceClient, local_service)
from repro_torch.service.protocol import (  # noqa: E402
    format_block, parse_block)

REPO = Path(__file__).resolve().parents[1]


def report(uarch: str, resp: dict) -> str:
    if not resp.get("ok"):
        err = resp.get("error", {})
        lines = [f"{uarch}: ERROR [{err.get('type')}] {err.get('message')}"]
        if err.get("missing"):
            lines.append(f"  missing variants: {', '.join(err['missing'])}")
        return "\n".join(lines)
    r = resp["result"]
    pressure = sorted(r["port_pressure"].items(), key=lambda kv: -kv[1])
    top = ", ".join(f"p{p}={v:.2f}" for p, v in pressure[:4])
    return (f"{uarch}: {r['cycles']:.2f} cycles/iter — bottleneck: "
            f"{r['bottleneck']}\n"
            f"  bounds: ports={r['port_bound']:.2f} "
            f"latency={r['latency_bound']:.2f} "
            f"frontend={r['frontend_bound']:.2f}\n"
            f"  port pressure: {top or '-'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("block", nargs="?",
                    help="block file in the textual format, or - for stdin "
                         "(not needed with --trace-report)")
    ap.add_argument("--models", default=str(REPO / "experiments" / "models"),
                    help="model artifact directory (local mode)")
    ap.add_argument("--connect", metavar="HOST:PORT",
                    help="query a running server instead of starting one")
    ap.add_argument("--uarch", action="append",
                    help="restrict to these uarches (repeatable)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print raw JSON responses")
    ap.add_argument("--trace-report", metavar="TRACE",
                    help="summarize a repro_torch.obs trace file (Chrome "
                         "JSON or JSONL) instead of predicting a block")
    ap.add_argument("--top-waves", type=int, default=5, metavar="K",
                    help="slowest waves to list in --trace-report "
                         "(default 5)")
    ap.add_argument("--corpus-report", metavar="ACCURACY",
                    help="render a corpus accuracy artifact "
                         "(corpus_accuracy.json) instead of predicting "
                         "a block")
    args = ap.parse_args(argv)

    if args.corpus_report:
        from repro_torch.corpus import format_report  # noqa: PLC0415
        rep = json.loads(Path(args.corpus_report).read_text())
        if args.as_json:
            print(json.dumps(rep, sort_keys=True, indent=1))
        else:
            print(format_report(rep))
        return 0
    if args.trace_report:
        from repro_torch.analysis.wave_report import (  # noqa: PLC0415
            format_wave_report, report_from_file)
        rep = report_from_file(args.trace_report, top=args.top_waves)
        if args.as_json:
            print(json.dumps(rep, indent=1))
        else:
            print(format_wave_report(rep))
        return 0
    if not args.block:
        ap.error("a block file is required unless --trace-report or "
                 "--corpus-report is given")

    text = (sys.stdin.read() if args.block == "-"
            else Path(args.block).read_text())
    code = parse_block(text)
    if not code:
        print("empty block", file=sys.stderr)
        return 2

    with contextlib.ExitStack() as stack:
        if args.connect:
            host, sep, port = args.connect.rpartition(":")
            if not sep or not host or not port.isdigit():
                ap.error(f"--connect expects HOST:PORT, got {args.connect!r}")
            client = stack.enter_context(ServiceClient(host, int(port)))
        else:
            client = stack.enter_context(local_service(args.models))
        uarches = args.uarch or client.uarches()
        if not uarches:
            print(f"no model artifacts under {args.models}; run "
                  f"PYTHONPATH=src python examples/export_models_torch.py "
                  f"first",
                  file=sys.stderr)
            return 1
        responses = {ua: client.predict(ua, code, raw=True)
                     for ua in uarches}

    if args.as_json:
        print(json.dumps(responses, indent=1))
        return 0
    # echo the canonical textual form (format_block is the exact inverse of
    # parse_block, so this is re-parseable as-is)
    print(f"block ({len(code)} instructions):")
    for line in format_block(code).splitlines():
        print(f"  {line}")
    print()
    for ua in uarches:
        print(report(ua, responses[ua]))
    bad = sum(1 for r in responses.values() if not r.get("ok"))
    return 1 if bad == len(responses) else 0


if __name__ == "__main__":
    raise SystemExit(main())
