"""End-to-end training on the PyTorch port: the synthetic pipeline with
checkpointing and straggler telemetry, on the card by default.

Run: PYTHONPATH=src python examples/train_100m_torch.py           (~20M)
     PYTHONPATH=src python examples/train_100m_torch.py --full    (~100M)
     PYTHONPATH=src python examples/train_100m_torch.py --device cpu
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ShapeSpec, load_config  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--full", action="store_true", help="~100M params")
ap.add_argument("--steps", type=int, default=150)
ap.add_argument("--ckpt-dir", default=str(Path(tempfile.gettempdir()) /
                                          "repro_torch_train_ckpt"))
ap.add_argument("--device", default="cuda",
                help="the device to train on (default: the card)")
args = ap.parse_args()

cfg = load_config("smollm_360m")
if args.full:
    cfg = cfg.replace(num_layers=12, d_model=768, num_heads=12,
                      num_kv_heads=4, head_dim=64, d_ff=2048,
                      vocab_size=32000)
    shape = ShapeSpec("train100m", 512, 8, "train")
else:
    cfg = cfg.replace(num_layers=6, d_model=320, num_heads=8, num_kv_heads=4,
                      head_dim=40, d_ff=1024, vocab_size=8192)
    shape = ShapeSpec("train20m", 256, 8, "train")

print(f"training {cfg.param_count() / 1e6:.1f}M params, "
      f"batch={shape.global_batch} seq={shape.seq_len}, {args.steps} steps "
      f"on {args.device}")
params, opt_state, losses = train(
    cfg, shape, steps=args.steps,
    opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup_steps=20,
                              total_steps=args.steps),
    ckpt_dir=args.ckpt_dir, ckpt_interval=50, microbatches=2,
    device=args.device)
print(f"loss: {losses[0][1]:.3f} -> {losses[-1][1]:.3f} "
      f"(checkpoints in {args.ckpt_dir})")
assert losses[-1][1] < losses[0][1], "loss must decrease"
