"""End-to-end serving driver on the PyTorch port: batched prefill +
autoregressive decode on a SmolLM-family model, with wall-clock throughput
and the perf-model's memory floor.

Run: PYTHONPATH=src python examples/serve_batched_torch.py [--big]
  (default: reduced dims for a fast demo; --big uses ~100M params;
  --device cpu runs on the CPU, the default is the card)

The same flags and lines as examples/serve_batched.py; the times are this
run's, on the device it names.  Weights are random, drawn from a
``torch.Generator`` seeded with 0 (not the reference's numbers).
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.base import load_config  # noqa: E402
from repro_torch.models import model as MF  # noqa: E402
from repro_torch.train.serve import make_serve_step  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--big", action="store_true", help="~100M params")
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--prefill", type=int, default=128)
ap.add_argument("--decode", type=int, default=64)
ap.add_argument("--device", default="cuda",
                help="torch device to serve on (default: cuda)")
args = ap.parse_args()
device = torch.device(args.device)

cfg = load_config("smollm_360m")
if args.big:  # ~100M-param variant of the family
    cfg = cfg.replace(num_layers=12, d_model=768, num_heads=12,
                      num_kv_heads=4, head_dim=64, d_ff=2048,
                      vocab_size=32000)
else:
    cfg = cfg.replace(num_layers=6, d_model=256, num_heads=8, num_kv_heads=4,
                      head_dim=32, d_ff=768, vocab_size=8192)
model = MF.build_model(cfg, device=device)
n_params = cfg.param_count()
print(f"model: {cfg.name}-variant, {n_params / 1e6:.1f}M params, "
      f"batch={args.batch}")

model.init(torch.Generator(device=device).manual_seed(0))
toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prefill),
                     generator=torch.Generator(device=device).manual_seed(1),
                     device=device, dtype=torch.int32)
serve_step = make_serve_step(model)


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize(device)


t0 = time.perf_counter()
logits, state = model.prefill({"tokens": toks},
                              pad_to=args.prefill + args.decode)
sync()
t_prefill = time.perf_counter() - t0
print(f"prefill: {args.batch}x{args.prefill} tokens in {t_prefill:.2f}s "
      f"({args.batch * args.prefill / t_prefill:.0f} tok/s)")

tok = torch.argmax(logits, -1).to(torch.int32)
# warm-up decode step (the reference's is its compile)
tok, _, state = serve_step(state, tok)
sync()
t0 = time.perf_counter()
out = [tok]
for _ in range(args.decode - 1):
    tok, _, state = serve_step(state, tok)
    out.append(tok)
sync()
t_decode = time.perf_counter() - t0
rate = args.batch * (args.decode - 1) / t_decode
print(f"decode: {args.decode - 1} steps x{args.batch} in {t_decode:.2f}s "
      f"({rate:.0f} tok/s, {1e3 * t_decode / (args.decode - 1):.1f} ms/step)")

# perf-model sanity: decode is memory-bound; floor = param+cache bytes / bw
from repro_torch.analysis.roofline import decode_state_bytes  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402

shape = ShapeSpec("serve", args.prefill + args.decode, args.batch, "decode")
floor_bytes = cfg.param_count() * 4 + decode_state_bytes(cfg, shape)
print(f"memory floor per decode step: {floor_bytes / 1e6:.1f} MB "
      f"(params + KV cache) -> the serving roofline the §Perf analysis "
      f"reasons about")
sample = torch.stack(out, dim=1)[0, :16]
print("sample continuation token ids:", list(map(int, sample)))
