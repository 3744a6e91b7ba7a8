"""The sharded trainer on a 2 x 2 (data, model) mesh, on the CPU:
``launch.train.train(..., mesh=make_host_mesh(2, 2))`` on four gloo ranks
(``torch_mesh_util.run_ranks``), ``qwen3_8b`` smoke in f32, six steps of 4
x 32 tokens with a checkpoint every three.

  * its losses equal the unsharded port's (the same ``train`` without a
    mesh) within ``STEP_REL`` (1e-5), the bound of
    ``tests/test_torch_train_step.py``;
  * its parameters and AdamW moments are DTensors placed by
    ``param_pspecs``, the step replicated;
  * its step-3 checkpoint (written by rank 0 from the gathered leaves)
    restores in the unsharded port and in the reference's
    ``restore_checkpoint``, the same bits in both, and close to the
    unsharded run's own step-3 checkpoint: each leaf's mean |difference|
    within ``PARAM_TOL`` (1e-5) and every element within ``2 * lr *
    steps`` (AdamW normalizes each gradient element, so one whose
    gradient sits at f32 noise may step the other way, as
    ``tests/test_torch_train_step.py`` states);
  * a sharded run resumed from that checkpoint ends bit-identical to the
    uninterrupted one.

Run as ``python tests/test_torch_mesh_train.py --rank ...`` this file is
one rank (``torch_mesh_util.rank_main``); it imports no jax then.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_mesh_util import rank_main, run_ranks

STEP_REL = 1e-5
PARAM_TOL = 1e-5
WORLD = 4
STEPS, CKPT_AT, BATCH, SEQ = 6, 3, 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)


def _setup():
    from repro_torch.configs.base import ShapeSpec, load_config
    from repro_torch.optim import adamw
    cfg = load_config("qwen3_8b", smoke=True).replace(
        param_dtype=torch.float32, compute_dtype=torch.float32)
    return cfg, ShapeSpec("t", SEQ, BATCH, "train"), adamw.AdamWConfig(**OPT)


# ------------------------------------------------------------ the ranks
def _check_train(tmp: Path) -> dict:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.tree_util import tree_leaves

    cfg, shape, opt = _setup()
    mesh = make_host_mesh(2, 2, device_type="cpu")
    run_a, run_b = tmp / "a", tmp / "b"

    def run(ckpt_dir):
        return train(cfg, shape, steps=STEPS, opt_cfg=opt, mesh=mesh,
                     ckpt_dir=ckpt_dir, ckpt_interval=CKPT_AT, log_every=1,
                     log_fn=lambda *a: None, device="cpu")

    model, state, losses = run(run_a)
    leaves = tree_leaves((model, state))
    out = {"losses": losses,
           "all_dtensors": all(isinstance(t, DTensor) for t in leaves),
           "placements": {n: [type(p).__name__ + str(getattr(p, "dim", ""))
                              for p in t.placements]
                          for n, t in [*model.named_parameters(),
                                       ("step", state.step),
                                       ("mu.layers.attn.wq",
                                        state.mu["layers"]["attn"]["wq"])]}}
    if dist.get_rank() == 0:
        ckpt = f"{CKPT_AT:08d}.ckpt"
        run_b.mkdir()
        shutil.copytree(run_a / ckpt, run_b / ckpt)
    dist.barrier()
    model_b, state_b, losses_b = run(run_b)
    out["resumed_losses"] = losses_b
    out["resumed_identical"] = all(
        torch.equal(a.full_tensor(), b.full_tensor())
        for a, b in zip(leaves, tree_leaves((model_b, state_b))))
    out["checkpoints"] = sorted(p.name for p in run_a.iterdir())
    return out


CHECKS = {"train": _check_train}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the sharded run's results, the unsharded run's losses, its
    directory)."""
    from repro_torch.launch.train import train
    tmp = tmp_path_factory.mktemp("mesh_train")
    port = run_ranks(Path(__file__), WORLD, tmp, "train")
    cfg, shape, opt = _setup()
    _, _, losses = train(cfg, shape, steps=STEPS, opt_cfg=opt,
                         ckpt_dir=tmp / "u", ckpt_interval=CKPT_AT,
                         log_every=1, log_fn=lambda *a: None, device="cpu")
    return port, losses, tmp


def test_sharded_losses_equal_the_unsharded_port(runs):
    port, losses, _ = runs
    assert [s for s, _ in port["losses"]] == list(range(1, STEPS + 1))
    for (_, got), (_, want) in zip(port["losses"], losses, strict=True):
        assert abs(got - want) <= STEP_REL * abs(want), (got, want)
    assert port["losses"][-1][1] < port["losses"][0][1]


def test_parameters_and_moments_are_placed_by_param_pspecs(runs):
    port, _, _ = runs
    pl = port["placements"]
    assert port["all_dtensors"]
    assert pl["layers.attn.wq"] == ["Shard1", "Shard2"]   # (L, d, q): data, model
    assert pl["layers.attn.wo"] == ["Shard2", "Shard1"]
    assert pl["embed"] == ["Shard1", "Shard0"]
    assert pl["layers.ln1"] == ["Replicate", "Replicate"]
    assert pl["mu.layers.attn.wq"] == pl["layers.attn.wq"]
    assert pl["step"] == ["Replicate", "Replicate"]


def test_checkpoint_restores_unsharded_and_in_the_reference(runs):
    import jax

    from repro.checkpoint.checkpoint import restore_checkpoint as r_restore
    from repro.configs.base import load_config as r_load
    from repro.models import model as RMF
    from repro.optim import adamw as r_adamw
    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree_util import tree_leaves

    port, _, tmp = runs
    assert port["checkpoints"] == [f"{CKPT_AT:08d}.ckpt", f"{STEPS:08d}.ckpt"]
    cfg, _, opt = _setup()
    like = build_model(cfg, device="cpu")
    like = (like, adamw.init_state(like))
    path = tmp / "a" / f"{CKPT_AT:08d}.ckpt"
    step, got, _ = restore_checkpoint(path, like)
    _, want, _ = restore_checkpoint(tmp / "u" / f"{CKPT_AT:08d}.ckpt", like)
    assert step == CKPT_AT and int(got[1].step) == CKPT_AT
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want) == len(tree_leaves(like))
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        assert float(d.mean()) <= PARAM_TOL
        assert float(d.max()) <= 2 * opt.lr * CKPT_AT
    rcfg = r_load("qwen3_8b", smoke=True).replace(
        param_dtype=jax.numpy.float32, compute_dtype=jax.numpy.float32)
    params = RMF.build_model(rcfg).init(jax.random.PRNGKey(0))
    r_step, r_tree, _ = r_restore(path, (params,
                                         r_adamw.init_state(params)))
    assert r_step == CKPT_AT
    for a, b in zip(got, jax.tree.leaves(r_tree), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_resumed_sharded_run_is_the_uninterrupted_one(runs):
    port, _, _ = runs
    assert port["resumed_identical"]
    assert port["resumed_losses"] == port["losses"][CKPT_AT:]


if __name__ == "__main__":
    rank_main(CHECKS)
