"""Training driver: data pipeline → train step → checkpoints →
fault-tolerance hooks, on one device or on a mesh (mesh/axes are
injected).

The port of the reference package's ``repro.launch.train``.  It runs on
the card by default (``device="cuda"``) and on the CPU when asked
(``device="cpu"``, as the tests do).  With ``mesh`` (a
``launch.mesh.make_host_mesh``/``make_production_mesh`` mesh, every rank
of the process group calling ``train`` alike) the model is built by
``axes_for``, its parameters and AdamW ``mu``/``nu`` are DTensors placed by
``param_pspecs``, the step is replicated and each synthetic batch is
sharded by ``input_pspecs``.

CLI (examples/train_100m_torch.py wraps ``train``):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        --smoke --steps 200 --batch 8 --seq 128 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeSpec, load_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.faults.tolerance import StepTimer, StragglerDetector
from repro_torch.models import model as MF
from repro_torch.models.sharding import SINGLE, distribute
from repro_torch.models.transformer import flatten_tree
from repro_torch.optim import adamw
from repro_torch.train.train_loop import make_train_step


@torch.no_grad()
def _load(model, tree: dict):
    """Copy a restored parameter tree (nested dict) into ``model``."""
    params = dict(model.named_parameters())
    for name, t in flatten_tree(tree).items():
        params[name].copy_(t)


def train(cfg, shape: ShapeSpec, *, steps: int, opt_cfg=None, mesh=None,
          ckpt_dir=None, ckpt_interval: int = 100, microbatches: int = 1,
          log_every: int = 10, resume: bool = True, seed: int = 0,
          log_fn=print, device="cuda"):
    """Train ``cfg`` on the synthetic pipeline for ``steps`` steps from
    weights drawn with ``torch.Generator(device).manual_seed(seed)``;
    returns (model, opt_state, losses), ``losses`` the (step, loss) pairs
    logged.  With ``ckpt_dir`` it checkpoints every ``ckpt_interval`` steps
    and at the end, and (``resume``) starts from the latest checkpoint
    there.  With ``mesh`` it trains sharded (module docstring); ``device``
    must then be of the mesh's device type."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=steps)
    device = torch.device(device)
    axes = MF.axes_for(cfg, shape, mesh) if mesh is not None else SINGLE
    model = MF.build_model(cfg, axes, mesh, device=device).init(
        torch.Generator(device).manual_seed(seed))
    opt_state = adamw.init_state(model)
    step_fn = make_train_step(model, opt_cfg, microbatches)
    in_specs = MF.input_pspecs(cfg, shape, axes) if mesh is not None else {}

    data = SyntheticTokens(cfg, shape, DataConfig(
        seed=seed, vocab_size=min(cfg.vocab_size, 512)), device=device)
    mgr = None
    start_step = 0
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, interval=ckpt_interval)
        if resume:
            got = mgr.restore_latest((model, opt_state))
            if got is not None:
                start_step, (tree, opt_state), _ = got
                _load(model, tree)
                log_fn(f"[train] resumed from step {start_step}")

    detector = StragglerDetector()
    losses = []
    saved = False
    for step in range(start_step, steps):
        batch = data.batch_at(step)
        if mesh is not None:  # every rank holds the global batch
            batch = {k: distribute(v, mesh, in_specs[k], what=k,
                                   src_data_rank=None)
                     for k, v in batch.items()}
        with StepTimer(detector):
            _, opt_state, metrics = step_fn(model, opt_state, batch)
        if (step + 1) % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            losses.append((step + 1, loss))
            gn = float(metrics.get("grad_norm", np.nan))
            log_fn(f"[train] step {step + 1}/{steps} loss={loss:.4f} "
                   f"gnorm={gn:.3f} ewma={detector.median():.3f}s")
        if mgr is not None:
            saved = mgr.maybe_save(step + 1, (model, opt_state),
                                   metadata={"arch": cfg.name})
    if mgr is not None:
        if not saved:  # the last step's checkpoint, unless just written
            mgr.maybe_save(steps, (model, opt_state), force=True,
                           metadata={"arch": cfg.name})
        mgr.wait()
    return model, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default: the card)")
    args = ap.parse_args()
    cfg = load_config(args.arch, smoke=args.smoke)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    t0 = time.time()
    _, _, losses = train(
        cfg, shape, steps=args.steps,
        opt_cfg=adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                                  total_steps=args.steps),
        ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
        device=args.device)
    print(f"[train] done in {time.time() - t0:.1f}s; "
          f"loss {losses[0][1]:.3f} -> {losses[-1][1]:.3f}")


if __name__ == "__main__":
    main()
