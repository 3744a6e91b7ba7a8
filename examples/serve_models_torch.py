"""Start uops-as-a-service on the PyTorch/CUDA port over the exported
model artifacts.

Serves every uarch found under experiments/models/ (run
examples/export_models.py first) on a TCP port speaking the negotiated
binary / newline-JSON protocol, predicting with the port-bound CUDA kernel
on the card (REPRO_PREDICT_BACKEND=torch or numpy changes that). Query it
with scripts/analyze_torch.py --connect, or programmatically with
repro_torch.service.client.ServiceClient.

Run: PYTHONPATH=src python examples/serve_models_torch.py [--port 8642]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.service.server import start_server  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--models",
                default=str(Path(__file__).resolve().parents[1]
                            / "experiments" / "models"))
ap.add_argument("--host", default="127.0.0.1")
ap.add_argument("--port", type=int, default=8642)
ap.add_argument("--stats-every", type=float, default=30.0,
                help="print service stats every N seconds (0: never)")
args = ap.parse_args()

server = start_server(args.models, host=args.host, port=args.port)
uarches = server.service.uarches()
if not uarches:
    print(f"no model artifacts under {args.models}; run "
          f"PYTHONPATH=src python examples/export_models.py first",
          file=sys.stderr)
    server.close()
    sys.exit(1)
print(f"uops-as-a-service (PyTorch port) on {server.host}:{server.port} "
      f"serving {uarches}")
print(f"try: PYTHONPATH=src python scripts/analyze_torch.py /tmp/block.txt "
      f"--connect {server.host}:{server.port}")
try:
    while True:
        time.sleep(args.stats_every or 3600)
        if args.stats_every:
            st = server.service.stats()
            print(f"[stats] cache={st['cache']} "
                  f"coalescer={st['coalescer']} "
                  f"predictor={st.get('predictor')}")
except KeyboardInterrupt:
    print("\nshutting down")
finally:
    server.close()
