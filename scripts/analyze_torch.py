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
(default: experiments/models — run examples/export_models.py first),
predicting with the ``cuda`` kernel on ``cuda:0`` unless
``REPRO_PREDICT_BACKEND`` names another backend.

The port of scripts/analyze.py without its --trace-report and
--corpus-report modes: they read trace files and corpus accuracy
artifacts through obs/export.py and corpus/, which the port does not
have yet.
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
    ap.add_argument("block",
                    help="block file in the textual format, or - for "
                         "stdin")
    ap.add_argument("--models", default=str(REPO / "experiments" / "models"),
                    help="model artifact directory (local mode)")
    ap.add_argument("--connect", metavar="HOST:PORT",
                    help="query a running server instead of starting one")
    ap.add_argument("--uarch", action="append",
                    help="restrict to these uarches (repeatable)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print raw JSON responses")
    args = ap.parse_args(argv)

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
                  f"PYTHONPATH=src python examples/export_models.py first",
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
