"""The sharding repairs that the production meshes' dry run needed, on
four gloo ranks (``torch_mesh_util.run_ranks``), in f32 against the
unsharded model from the same seed:

  * attention whose heads do not divide the ``model`` axis: the SmolLM
    smoke config with 15 heads (5 kv heads) of 32 on a 1 x 4 mesh, where
    the gradient of attention's head flatten arrives sharded on the
    flattened dimension and DTensor cannot unflatten it into 15 heads
    (``layers.full_attention`` places it whole first).  The loss within
    ``F32_REL`` (1e-5) relative and each gradient, gathered, within
    ``F32_REL`` of its leaf's largest element, as
    ``tests/test_torch_mesh_families.py`` holds the families;
  * the SSD's single-token step on local shards
    (``mamba.ssd_step_sharded``): a Mamba2 and a Zamba2 smoke
    ``decode_step`` on a 2 x 2 mesh from the unsharded prefill's state,
    the logits and the new SSM and conv states within ``DECODE_TOL``
    (1e-5) of the unsharded step's (the chunked scan's region is held by
    the families' training test);
  * microbatches with fewer rows than the batch ranks (Llama-4-Scout's 16
    microbatches of 256 rows over (pod, data) = 32 ranks): one
    ``make_train_step`` step of the SmolLM smoke config on a (pod 2, data
    2, model 1) mesh, 4 rows in 2 microbatches (run over ``data``,
    replicated over ``pod``) and in 4 (replicated over both), its loss
    within ``F32_REL`` of the unsharded step's and each updated parameter
    within ``F32_REL`` of its leaf's largest element.

Run as ``python tests/test_torch_mesh_repairs.py --rank ...`` this file
is one rank (``torch_mesh_util.rank_main``); it imports no jax then.
"""
from pathlib import Path

import pytest
import torch

from torch_mesh_util import rank_main, run_ranks

F32_REL = 1e-5
DECODE_TOL = 1e-5
WORLD = 4
BATCH, TEXT = 4, 32
HEADS = dict(num_heads=15, num_kv_heads=5, head_dim=32, d_model=480)
SSM_ARCHS = ["mamba2_2_7b", "zamba2_2_7b"]


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _check_repairs(tmp: Path) -> dict:
    from repro_torch.configs.base import ShapeSpec, load_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as MF
    from repro_torch.tree_util import tree_map

    out = {"micro": _check_microbatches()}
    mesh = make_host_mesh(1, WORLD, device_type="cpu")
    cfg = load_config("smollm_360m", smoke=True).replace(
        compute_dtype=torch.float32, **HEADS)
    shape = ShapeSpec("t", TEXT, BATCH, "train")
    batch = SyntheticTokens(cfg, shape, DataConfig(seed=5, vocab_size=512),
                            device="cpu").batch_at(0)
    for name, axes in (("plain", None), ("sharded",
                                         MF.axes_for(cfg, shape, mesh))):
        model = MF.build_model(cfg, axes, mesh if axes else None,
                               device="cpu").init(
            torch.Generator().manual_seed(4))
        model.requires_grad_(True)
        loss, _ = model.loss(batch)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        out[f"heads_{name}"] = (float(loss.detach()), dict(zip(
            names, [_whole(g) for g in grads])))

    mesh = make_host_mesh(2, 2, device_type="cpu")
    tokens = torch.from_numpy(__import__("numpy").random.default_rng(
        3).integers(0, 500, (2, 20)).astype("int32"))
    nxt = tokens[:, -1]
    for arch in SSM_ARCHS:
        cfg = load_config(arch, smoke=True).replace(
            compute_dtype=torch.float32)
        plain = MF.build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(3))
        shape = ShapeSpec("d", 20, 2, "decode")
        sharded = MF.build_model(cfg, MF.axes_for(cfg, shape, mesh), mesh,
                                 device="cpu").init(
            torch.Generator().manual_seed(3))
        _, state = plain.prefill({"tokens": tokens[:, :-1]}, pad_to=24)
        want = plain.decode_step(state, nxt)
        got = sharded.decode_step(state, nxt)
        out[arch] = (tree_map(_whole, got), want)
    return out


def _check_microbatches() -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeSpec, load_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import model as MF
    from repro_torch.models.sharding import distribute
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step

    mesh = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    cfg = load_config("smollm_360m", smoke=True).replace(
        param_dtype=torch.float32, compute_dtype=torch.float32)
    shape = ShapeSpec("t", TEXT, BATCH, "train")
    whole = SyntheticTokens(cfg, shape, DataConfig(seed=5, vocab_size=512),
                            device="cpu").batch_at(0)
    axes = MF.axes_for(cfg, shape, mesh)
    assert axes.batch == ("pod", "data")
    out = {}
    for n in (2, 4):
        res = {}
        for name in ("plain", "sharded"):
            sharded = name == "sharded"
            model = MF.build_model(cfg, axes if sharded else None,
                                   mesh if sharded else None,
                                   device="cpu").init(
                torch.Generator().manual_seed(4))
            batch = whole
            if sharded:   # as launch.train places it
                specs = MF.input_pspecs(cfg, shape, axes)
                batch = {k: distribute(v, mesh, specs[k], what=k)
                         for k, v in whole.items()}
            step = make_train_step(model, adamw.AdamWConfig(lr=1e-3), n)
            _, _, metrics = step(model, adamw.init_state(model), batch)
            res[name] = (float(_whole(metrics["loss"])), {
                k: _whole(p.detach()) for k, p in model.named_parameters()})
        out[n] = res
    return out


CHECKS = {"repairs": _check_repairs}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_ranks(Path(__file__), WORLD,
                     tmp_path_factory.mktemp("mesh_repairs"), "repairs")


def test_uneven_heads_loss_and_grads_equal_unsharded(results):
    (l0, g0), (l1, g1) = results["heads_plain"], results["heads_sharded"]
    assert abs(l1 - l0) <= F32_REL * abs(l0), (l0, l1)
    assert g0.keys() == g1.keys()
    for name in g0:
        scale = float(g0[name].abs().max())
        err = float((g1[name] - g0[name]).abs().max())
        assert err <= F32_REL * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize("n", [2, 4])
def test_microbatches_smaller_than_the_batch_ranks_train_as_unsharded(
        results, n):
    (l0, p0), (l1, p1) = (results["micro"][n]["plain"],
                          results["micro"][n]["sharded"])
    assert abs(l1 - l0) <= F32_REL * abs(l0), (l0, l1)
    assert p0.keys() == p1.keys()
    for name in p0:
        scale = float(p0[name].abs().max())
        err = float((p1[name] - p0[name]).abs().max())
        assert err <= F32_REL * scale, (name, err, scale)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_sharded_ssm_decode_step_equals_unsharded(results, arch):
    from repro_torch.tree_util import tree_leaves
    (logits, state), (want_logits, want_state) = results[arch]
    torch.testing.assert_close(logits, want_logits, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    assert state.keys() == want_state.keys()
    for key in ("ssm", "conv"):
        torch.testing.assert_close(state[key], want_state[key],
                                   atol=DECODE_TOL, rtol=DECODE_TOL)
    assert int(state["pos"]) == int(want_state["pos"]) == 20
    assert len(tree_leaves(state)) == len(tree_leaves(want_state))


if __name__ == "__main__":
    rank_main(CHECKS)
