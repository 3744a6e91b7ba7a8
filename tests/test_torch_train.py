"""The port's training substrate against the reference's, on the CPU:
AdamW (``optim/adamw.py``), int8 compression with error feedback
(``optim/compression.py``), the synthetic data pipeline
(``data/pipeline.py``), checkpoints (``checkpoint/checkpoint.py``) and the
trainer (``launch/train.py``, ``examples/train_100m_torch.py``).

Inputs are made with numpy from fixed seeds.  Tolerances:

* ``ADAMW_REL`` (1e-6): AdamW on the same gradients, each of new params,
  ``mu``, ``nu``, ``grad_norm`` and ``lr`` within 1e-6 of the reference
  leaf's largest magnitude, and 1e-6 relative elementwise.  Both packages
  compute in f32 in the same order; what is left is the last bit of
  ``cos``/``pow``/``sqrt`` in two math libraries.
* Quantization, tokens/labels and checkpoint bytes: bit for bit.
* ``RESUME_ATOL``/``RESUME_RTOL`` (2e-4, 2e-3), the reference test's
  (``tests/test_substrate.py::test_train_resume_from_checkpoint``), for a
  resumed run against an uninterrupted one; the port's CPU runs are also
  required to be bit-identical, which they are.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as r_ckpt
from repro.configs.base import ShapeSpec as RShape
from repro.configs.base import load_config as r_load
from repro.data.pipeline import DataConfig as RData
from repro.data.pipeline import SyntheticTokens as RTokens
from repro.models import model as RMF
from repro.optim import adamw as r_adamw
from repro.optim import compression as r_comp
from repro_torch.checkpoint import checkpoint as p_ckpt
from repro_torch.configs.base import ShapeSpec as PShape
from repro_torch.configs.base import load_config as p_load
from repro_torch.data.pipeline import DataConfig as PData
from repro_torch.data.pipeline import SyntheticTokens as PTokens
from repro_torch.launch.train import train as p_train
from repro_torch.models.carry import params_from_reference
from repro_torch.optim import adamw as p_adamw
from repro_torch.optim import compression as p_comp
from repro_torch.tree_util import tree_leaves, tree_map

ADAMW_REL = 1e-6
RESUME_ATOL, RESUME_RTOL = 2e-4, 2e-3
ROOT = Path(__file__).resolve().parent.parent


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype.name == \
        "bfloat16" else np.asarray(x)


def _close(got, want, rel=ADAMW_REL, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=what)


# ----------------------------------------------------------------- AdamW
def _tree(rng, scale=1.0):
    """0-d, 1-d, stacked (L, d), 2-d and bf16 leaves."""
    return {"b": np.float32(rng.standard_normal() * scale),
            "bias": (rng.standard_normal(7) * scale).astype(np.float32),
            "layers": {"ln1": (1 + 0.1 * rng.standard_normal((3, 5)) * scale
                               ).astype(np.float32),
                       "w": (rng.standard_normal((3, 5, 4)) * scale
                             ).astype(np.float32)},
            "w": (rng.standard_normal((6, 4)) * scale).astype(np.float32),
            "w16": (rng.standard_normal((4, 8)) * scale).astype(np.float32)}


def _ref_tree(t):
    out = tree_map(jnp.asarray, t)
    out["w16"] = out["w16"].astype(jnp.bfloat16)
    return out


def _port_tree(t):
    out = tree_map(lambda a: torch.tensor(np.asarray(a)), t)
    out["w16"] = out["w16"].to(torch.bfloat16)
    return out


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 130])
def test_schedule_matches_the_reference(step):
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = r_adamw.schedule(r_adamw.AdamWConfig(**cfg), jnp.int32(step))
    got = p_adamw.schedule(p_adamw.AdamWConfig(**cfg),
                           torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want, what=f"lr at step {step}")


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_apply_update_matches_the_reference(grad_scale):
    """Three updates on the same gradients (the reference's, as numpy):
    unclipped (grad_scale 0.01) and clipped (10).  New params, mu, nu,
    grad_norm and lr agree within ``ADAMW_REL``."""
    rng = np.random.default_rng(0)
    init = _tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1)
    r_params = _ref_tree(init)
    p_params = _port_tree(init)
    r_state = r_adamw.init_state(r_params)
    p_state = p_adamw.init_state(p_params)
    for i in range(3):
        g = _tree(np.random.default_rng(10 + i), grad_scale)
        r_params, r_state, r_m = r_adamw.apply_update(
            r_params, _ref_tree(g), r_state, r_adamw.AdamWConfig(**cfg))
        p_params, p_state, p_m = p_adamw.apply_update(
            p_params, _port_tree(g), p_state, p_adamw.AdamWConfig(**cfg))
        assert int(p_state.step) == i + 1
        assert p_state.step.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert p_m[k].dim() == 0
            _close(p_m[k], r_m[k], what=f"step {i} {k}")
        for name, r_t, p_t in (("params", r_params, p_params),
                               ("mu", r_state.mu, p_state.mu),
                               ("nu", r_state.nu, p_state.nu)):
            for j, (got, want) in enumerate(zip(tree_leaves(p_t),
                                                jax.tree.leaves(r_t))):
                _close(got, want, what=f"step {i} {name} leaf {j}")
    assert p_params["w16"].dtype == torch.bfloat16
    assert p_state.mu["w16"].dtype == torch.float32


def test_apply_update_works_in_place_and_decays_stacked_leaves():
    """The update writes into the tensors it was given; with zero
    gradients only the leaves with ndim >= 2 move (decay), the stacked
    ``(L, d)`` norm weight among them, as in the reference."""
    params = {"ln_f": torch.ones(4), "layers": {"ln1": torch.ones(3, 4)},
              "w": torch.ones(4, 4)}
    w = params["w"]
    state = p_adamw.init_state(params)
    grads = tree_map(torch.zeros_like, params)
    new, state, _ = p_adamw.apply_update(
        params, grads, state, p_adamw.AdamWConfig(lr=0.1, warmup_steps=0))
    assert new["w"] is w and float(w[0, 0]) < 1.0
    assert float(new["layers"]["ln1"][0, 0]) < 1.0
    assert torch.equal(new["ln_f"], torch.ones(4))


def test_adamw_converges_quadratic():
    cfg = p_adamw.AdamWConfig(lr=0.05, warmup_steps=5, total_steps=200,
                              weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
    target = {"w": torch.tensor([1.0, 1.0]), "b": torch.tensor(0.0)}
    state = p_adamw.init_state(params)

    def loss(p):
        return sum(torch.sum((a - t) ** 2)
                   for a, t in zip(tree_leaves(p), tree_leaves(target)))

    for _ in range(200):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        p = dict(zip(sorted(params), leaves))
        g = torch.autograd.grad(loss(p), leaves)
        params, state, _ = p_adamw.apply_update(
            {k: v.detach() for k, v in p.items()},
            dict(zip(sorted(params), g)), state, cfg)
    assert float(loss(params)) < 1e-2


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, gn = p_adamw.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(200.0)
    assert float(p_adamw.global_norm(clipped)) == pytest.approx(1.0,
                                                                rel=1e-3)


# ----------------------------------------------------------- compression
def _quant_inputs(case):
    rng = np.random.default_rng(7)
    if case == "odd":
        return (rng.standard_normal(1000) * 3).astype(np.float32)
    if case == "2d":
        return rng.standard_normal((10, 7)).astype(np.float32)
    if case == "zero_blocks":
        x = rng.standard_normal(3 * 256 + 5).astype(np.float32)
        x[256:512] = 0.0
        x[-5:] = 0.0
        return x
    if case == "ties":  # every value a multiple of 0.5 of its block's scale
        x = (np.arange(512) % 255 - 127).astype(np.float32) / 2
        x[::256] = 127.0   # scale exactly 1: x / scale = k + 0.5
        return x
    return (rng.standard_normal((3, 5, 33)) * 1e-4).astype(np.float32)


@pytest.mark.parametrize("case", ["odd", "2d", "zero_blocks", "ties",
                                  "tiny_3d"])
def test_quantize_int8_is_the_reference_bit_for_bit(case):
    x = _quant_inputs(case)
    rq, rs, rmeta = r_comp.quantize_int8(jnp.asarray(x))
    pq, ps, pmeta = p_comp.quantize_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy().view(np.uint32),
                                  np.asarray(rs).view(np.uint32))
    assert pmeta[0] == rmeta[0] and pmeta[1] == tuple(rmeta[1])
    np.testing.assert_array_equal(
        p_comp.roundtrip_int8(torch.from_numpy(x)).numpy(),
        np.asarray(r_comp.roundtrip_int8(jnp.asarray(x))))
    if case == "ties":   # half to even, as jnp.round
        # x = (odd k) / 2 at even indices: k / 2 rounds to the even side
        assert set(np.unique(pq.numpy()[0, 2:40:2] % 2)) == {0}


def test_error_feedback_matches_the_reference():
    rng = np.random.default_rng(1)
    r_res = r_comp.ErrorFeedback.init({"a": jnp.zeros(300),
                                       "b": jnp.zeros((4, 4))})
    p_res = p_comp.ErrorFeedback.init({"a": torch.zeros(300),
                                       "b": torch.zeros(4, 4)})
    for step in range(5):
        g = {"a": (rng.standard_normal(300) * 1e-3).astype(np.float32),
             "b": rng.standard_normal((4, 4)).astype(np.float32)}
        r_sent, r_res = r_comp.ErrorFeedback.apply(
            tree_map(jnp.asarray, g), r_res, lambda t: t)
        p_sent, p_res = p_comp.ErrorFeedback.apply(
            tree_map(torch.from_numpy, g), p_res, lambda t: t)
        for tree_p, tree_r in ((p_sent, r_sent), (p_res, r_res)):
            for got, want in zip(tree_leaves(tree_p),
                                 jax.tree.leaves(tree_r)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"step {step}")


def test_psum_int8_raises_for_the_mesh_slice():
    """The int8 sum runs over an axis of the current mesh
    (``tests/test_torch_mesh_collectives.py``); outside one it raises."""
    with pytest.raises(RuntimeError, match="no current mesh"):
        p_comp.psum_int8(torch.ones(4), "pod")


# -------------------------------------------------------------------- data
DATA_CASES = [("smollm_360m", 3, 0, 1, 0), ("smollm_360m", 0, 7, 4, 2),
              ("qwen2_vl_2b", 5, 2, 1, 0), ("qwen2_vl_2b", 1, 3, 2, 1),
              ("whisper_medium", 2, 4, 1, 0), ("phi3_5_moe_42b", 9, 1, 2, 0)]


def _pipes(arch, seed, shards=1, idx=0, batch=8, seq=40):
    rcfg, pcfg = r_load(arch, smoke=True), p_load(arch, smoke=True)
    if rcfg.family == "vlm":   # room for the patches and some text
        seq = rcfg.num_patch_tokens + seq
    return (RTokens(rcfg, RShape("t", seq, batch, "train"), RData(seed=seed),
                    shard_index=idx, num_shards=shards),
            PTokens(pcfg, PShape("t", seq, batch, "train"), PData(seed=seed),
                    shard_index=idx, num_shards=shards, device="cpu"))


@pytest.mark.parametrize("arch,seed,step,shards,idx", DATA_CASES)
def test_tokens_and_labels_are_the_reference_bit_for_bit(arch, seed, step,
                                                         shards, idx):
    ref, port = _pipes(arch, seed, shards, idx)
    want, got = ref.batch_at(step), port.batch_at(step)
    assert set(got) == set(want)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("patch_embeds", "audio_frames"):
        if k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert got[k].dtype == port.cfg.compute_dtype


def test_data_shards_partition_the_global_batch():
    _, full = _pipes("smollm_360m", 3)
    parts = [_pipes("smollm_360m", 3, shards=4, idx=i)[1].batch_at(2)
             for i in range(4)]
    merged = torch.cat([p["tokens"] for p in parts])
    assert torch.equal(full.batch_at(2)["tokens"], merged)


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "whisper_medium"])
def test_modality_draws_are_deterministic_per_seed_and_step(arch):
    key = "patch_embeds" if arch == "qwen2_vl_2b" else "audio_frames"
    a = _pipes(arch, 4)[1].batch_at(3)[key]
    b = _pipes(arch, 4)[1].batch_at(3)[key]
    c = _pipes(arch, 4)[1].batch_at(4)[key]
    d = _pipes(arch, 5)[1].batch_at(3)[key]
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert 0.015 < float(a.float().std()) < 0.025


# ------------------------------------------------------------- checkpoints
def _model_and_state(arch="smollm_360m", seed=0):
    """The reference's (params, AdamWState) after one update, and the
    port's on the same values."""
    rcfg, pcfg = r_load(arch, smoke=True), p_load(arch, smoke=True)
    params = RMF.build_model(rcfg).init(jax.random.PRNGKey(seed))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    r_state = r_adamw.init_state(params)
    params, r_state, _ = r_adamw.apply_update(
        params, grads, r_state, r_adamw.AdamWConfig(warmup_steps=0))
    port = params_from_reference(pcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    p_state = p_adamw.AdamWState(
        torch.tensor(int(r_state.step), dtype=torch.int32),
        tree_map(lambda a: torch.tensor(np.asarray(a)), r_state.mu),
        tree_map(lambda a: torch.tensor(np.asarray(a)), r_state.nu))
    return (params, r_state), (port, p_state)


def _assert_trees_equal(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    (r_tree, p_tree) = _model_and_state()
    p_ckpt.save_checkpoint(tmp_path, 3, p_tree, chunks=2,
                           metadata={"arch": "x"})
    step, got, meta = r_ckpt.restore_checkpoint(
        r_ckpt.latest_checkpoint(tmp_path), r_tree)
    assert step == 3 and meta == {"arch": "x"}
    assert isinstance(got[1], r_adamw.AdamWState)
    _assert_trees_equal(p_tree, got)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    (r_tree, p_tree) = _model_and_state(seed=1)
    r_ckpt.save_checkpoint(tmp_path, 5, r_tree, chunks=2)
    step, got, _ = p_ckpt.restore_checkpoint(
        p_ckpt.latest_checkpoint(tmp_path), p_tree)
    assert step == 5
    params, state = got
    assert isinstance(state, p_adamw.AdamWState)
    assert state.step.dtype == torch.int32 and state.step.dim() == 0
    assert isinstance(params, dict) and sorted(params) == sorted(r_tree[0])
    _assert_trees_equal(got, r_tree)


@pytest.mark.parametrize("chunks", [1, 2])
def test_leaf_files_are_the_reference_byte_for_byte(tmp_path, chunks):
    """The same tree (f32, bf16, int32 and 0-d leaves) written by both
    packages: equal leaf files, manifests equal but for ``treedef``."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    r_tree = {"w": jnp.asarray(w), "b": jnp.asarray(b).astype(jnp.bfloat16),
              "n": jnp.arange(4, dtype=jnp.int32), "s": jnp.float32(2.5)}
    p_tree = {"w": torch.from_numpy(w),
              "b": torch.from_numpy(b).to(torch.bfloat16),
              "n": torch.arange(4, dtype=torch.int32),
              "s": torch.tensor(2.5)}
    r_path = r_ckpt.save_checkpoint(tmp_path / "r", 1, r_tree, chunks=chunks)
    p_path = p_ckpt.save_checkpoint(tmp_path / "p", 1, p_tree, chunks=chunks)
    names = sorted(p.name for p in r_path.iterdir())
    assert names == sorted(p.name for p in p_path.iterdir())
    for name in names:
        if name != "manifest.json":
            assert (r_path / name).read_bytes() == \
                (p_path / name).read_bytes(), name
    rm, pm = (json.loads((p / "manifest.json").read_text())
              for p in (r_path, p_path))
    rm.pop("treedef"), pm.pop("treedef")
    assert rm == pm


def test_elastic_restore_across_shard_counts(tmp_path):
    t = {"w": torch.arange(32, dtype=torch.float32).reshape(16, 2),
         "s": torch.tensor(1.0)}
    for chunks, shards in ((1, 2), (2, 1), (4, 2)):
        d = tmp_path / f"c{chunks}"
        p_ckpt.save_checkpoint(d, 1, t, chunks=chunks)
        path = p_ckpt.latest_checkpoint(d)
        parts = [p_ckpt.restore_checkpoint(path, t, shard_index=i,
                                           num_shards=shards)[1]
                 for i in range(shards)]
        assert torch.equal(torch.cat([p["w"] for p in parts]), t["w"])
        assert all(torch.equal(p["s"], t["s"]) for p in parts)


def test_manager_snapshots_before_the_next_in_place_step(tmp_path):
    """``maybe_save`` copies on the caller's thread: an in-place update
    right after it does not reach the checkpoint."""
    _, (port, state) = _model_and_state()
    before = [p.detach().clone() for p in tree_leaves((port, state))]
    mgr = p_ckpt.CheckpointManager(tmp_path, interval=1)
    assert mgr.maybe_save(1, (port, state))
    with torch.no_grad():
        for p in port.parameters():
            p.add_(1.0)
        for m in tree_leaves(state.mu):
            m.mul_(-3.0)
    mgr.wait()
    _, got, _ = p_ckpt.restore_checkpoint(tmp_path / "00000001.ckpt",
                                          (port, state))
    for a, b in zip(tree_leaves(got), before):
        assert torch.equal(a, b)


def test_manager_retention_and_atomicity(tmp_path):
    mgr = p_ckpt.CheckpointManager(tmp_path, interval=2, keep=2)
    t = {"w": torch.ones(3, 2), "b": torch.ones(5, dtype=torch.bfloat16)}
    for step in range(1, 9):
        mgr.maybe_save(step, t)
    mgr.wait()
    kept = sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".ckpt")
    assert kept == ["00000006.ckpt", "00000008.ckpt"]
    assert not list(tmp_path.glob("*.tmp"))
    assert mgr.restore_latest(t)[0] == 8


# ---------------------------------------------------------------- trainer
def test_train_step_loss_decreases():
    cfg = p_load("smollm_360m", smoke=True)
    shape = PShape("t", 64, 8, "train")
    _, _, losses = p_train(cfg, shape, steps=80,
                           opt_cfg=p_adamw.AdamWConfig(
                               lr=3e-3, warmup_steps=10, total_steps=80),
                           log_every=20, log_fn=lambda *a: None,
                           device="cpu")
    assert losses[-1][1] < losses[0][1] - 0.05


def test_train_resume_from_checkpoint(tmp_path):
    """10 steps, a checkpoint, a resumed run to 20: the uninterrupted
    run's params and optimizer state, bit for bit (and so within the
    reference test's tolerance); the checkpoint restores in the
    reference."""
    cfg = p_load("smollm_360m", smoke=True)
    shape = PShape("t", 32, 4, "train")
    opt = p_adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    logs = []
    p_full, s_full, _ = p_train(cfg, shape, steps=20, opt_cfg=opt,
                                log_fn=lambda *a: None, device="cpu")
    p_train(cfg, shape, steps=10, opt_cfg=opt, ckpt_dir=tmp_path,
            ckpt_interval=10, log_fn=lambda *a: None, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["00000010.ckpt"]
    p_res, s_res, _ = p_train(cfg, shape, steps=20, opt_cfg=opt,
                              ckpt_dir=tmp_path, ckpt_interval=100,
                              log_fn=logs.append, device="cpu")
    assert logs[0] == "[train] resumed from step 10"
    for a, b in zip(tree_leaves((p_full, s_full)),
                    tree_leaves((p_res, s_res))):
        np.testing.assert_allclose(_np(a), _np(b), atol=RESUME_ATOL,
                                   rtol=RESUME_RTOL)
        assert torch.equal(a, b)
    # the final checkpoint (step 20) restores in the reference
    rcfg = r_load("smollm_360m", smoke=True)
    like = RMF.build_model(rcfg).init(jax.random.PRNGKey(0))
    step, (params, state), meta = r_ckpt.restore_checkpoint(
        r_ckpt.latest_checkpoint(tmp_path),
        (like, r_adamw.init_state(like)))
    assert step == 20 and meta == {"arch": cfg.name}
    assert int(state.step) == 20
    _assert_trees_equal((p_res, s_res), (params, state))


def test_example_trains_on_the_cpu_without_jax(tmp_path):
    """``examples/train_100m_torch.py --device cpu --steps 12`` in a
    process where ``import jax`` and ``import repro`` fail: the loss falls
    (steps 10 and 12 logged) and the checkpoint lands in ``--ckpt-dir``.
    Two threads: beside the other test workers more would contend."""
    run = ("import runpy, sys\n"
           "for name in ('jax', 'jaxlib', 'repro'):\n"
           "    sys.modules[name] = None\n"
           f"sys.argv = [{str(ROOT / 'examples/train_100m_torch.py')!r}, "
           f"'--device', 'cpu', '--steps', '12', '--ckpt-dir', "
           f"{str(tmp_path)!r}]\n"
           "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", run], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("training ") and lines[0].endswith("on cpu")
    assert lines[-1].startswith("loss: ")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["00000012.ckpt"]
