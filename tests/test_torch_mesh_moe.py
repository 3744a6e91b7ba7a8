"""Expert-parallel MoE and the vocab-parallel cross-entropy on a 2 x 2
(data, model) mesh, against the reference's ``shard_map`` regions and the
port's own dense paths, on the CPU: four gloo ranks
(``torch_mesh_util.run_ranks``) beside the reference on four forced XLA
host devices, both on the reference's weights (``jax.random`` init,
carried) and one numpy batch of 4 x 16 tokens.

  * ``phi3_5_moe_42b`` smoke, as configured (bf16 compute): the sharded
    loss within ``MOE_BF16_TOL`` (2e-2) of the reference's sharded loss,
    the reference test's bound (sharded against dense); in f32 compute
    within ``F32_REL`` (1e-5) of it (both drop the same tokens: capacity
    counts each shard's tokens).
  * the same in f32 with ``capacity_factor = E / k`` (no expert drops a
    token, so the per-shard capacity changes nothing): loss and every
    gradient, gathered, within ``F32_REL`` of the port's dense path (a
    gradient relative to its leaf's largest element).
  * ``qwen3_8b`` smoke in f32: ``ce_impl="vocab_parallel"`` with
    ``embed_sharding="model_only"`` against the gather CE, loss and
    gradients within ``VP_TOL`` (1e-4), and the loss within ``VP_TOL`` of
    the reference's vocab-parallel loss.
  * the reference's own sharded gradients (both regions) equal its dense
    ones within ``F32_REL``: no difference to record or keep out.

Run as ``python tests/test_torch_mesh_moe.py --rank ...`` this file is
one rank (``torch_mesh_util.rank_main``); it imports no jax then.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_mesh_util import rank_main, run_py, run_ranks

MOE_BF16_TOL = 2e-2
F32_REL = 1e-5
VP_TOL = 1e-4
WORLD = 4
BATCH, SEQ = 4, 16


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _no_drop(cfg):
    return cfg.replace(capacity_factor=cfg.num_experts / cfg.experts_per_token)


# ------------------------------------------------------------ the ranks
def _loss_grads(model, batch, grads: bool = True):
    """(loss, {name: gradient}) of ``model`` on ``batch``, whole tensors."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    model.requires_grad_(grads)
    loss, _ = model.loss(batch)
    if not grads:
        return float(whole(loss)), {}
    names, params = zip(*model.named_parameters())
    gs = torch.autograd.grad(loss, params)
    return float(whole(loss.detach())), {n: whole(g) for n, g in
                                         zip(names, gs)}


def _check_regions(tmp: Path) -> dict:
    from repro_torch.configs.base import ShapeSpec, load_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as MF
    from repro_torch.models.carry import params_from_reference

    data = dict(np.load(tmp / "inputs.npz"))
    batch = {"tokens": torch.from_numpy(data["tokens"]),
             "labels": torch.from_numpy(data["labels"])}
    mesh = make_host_mesh(2, 2, device_type="cpu")
    shape = ShapeSpec("t", SEQ, BATCH, "train")
    out = {}

    def on_mesh(cfg, tree):
        axes = MF.axes_for(cfg, shape, mesh)
        return params_from_reference(cfg, tree, device="cpu", axes=axes,
                                     mesh=mesh)

    moe = _nest({k: v for k, v in np.load(tmp / "moe.npz").items()})
    cfg = load_config("phi3_5_moe_42b", smoke=True)
    out["moe_bf16"], _ = _loss_grads(on_mesh(cfg, moe), batch, False)
    f32 = cfg.replace(compute_dtype=torch.float32)
    out["moe_f32"], _ = _loss_grads(on_mesh(f32, moe), batch, False)
    nd = _no_drop(f32)
    out["moe_nd"], out["moe_nd_grads"] = _loss_grads(on_mesh(nd, moe), batch)
    dense = params_from_reference(nd, moe, device="cpu")
    out["moe_dense"], out["moe_dense_grads"] = _loss_grads(dense, batch)

    dn = _nest({k: v for k, v in np.load(tmp / "dense.npz").items()})
    cfg_g = load_config("qwen3_8b", smoke=True).replace(
        param_dtype=torch.float32, compute_dtype=torch.float32)
    cfg_v = cfg_g.replace(ce_impl="vocab_parallel",
                          embed_sharding="model_only")
    out["gather"], out["gather_grads"] = _loss_grads(on_mesh(cfg_g, dn),
                                                     batch)
    vp = on_mesh(cfg_v, dn)
    out["vp_embed_placements"] = [type(p).__name__ + str(getattr(p, "dim",
                                                                 ""))
                                  for p in vp["embed"].placements]
    out["vp"], out["vp_grads"] = _loss_grads(vp, batch)
    return out


CHECKS = {"regions": _check_regions}

# ----------------------------------------------------- the reference run
REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import load_config
from repro.models import model as MF
from repro.models.sharding import MeshAxes
TMP = %r
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,)*2)
axes = MeshAxes(batch=("data",), model="model", enabled=True)
data = np.load(TMP + "/inputs.npz")
batch = {"tokens": jnp.asarray(data["tokens"]),
         "labels": jnp.asarray(data["labels"])}

def nest(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
    return out

def worst(a, b):
    return max(float(jnp.max(jnp.abs(x - y)) / (jnp.max(jnp.abs(y)) + 1e-30))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))

vg = lambda m: jax.jit(jax.value_and_grad(lambda p, b: m.loss(p, b)[0]))
out = {}
moe = nest(dict(np.load(TMP + "/moe.npz")))
cfg = load_config("phi3_5_moe_42b", smoke=True)
f32 = cfg.replace(compute_dtype=jnp.float32)
nd = f32.replace(capacity_factor=f32.num_experts / f32.experts_per_token)
with jax.set_mesh(mesh):
    out["moe_bf16"] = float(jax.jit(MF.build_model(cfg, axes, mesh).loss)(
        moe, batch)[0])
    out["moe_f32"] = float(jax.jit(MF.build_model(f32, axes, mesh).loss)(
        moe, batch)[0])
    l_sh, g_sh = vg(MF.build_model(nd, axes, mesh))(moe, batch)
l_d, g_d = vg(MF.build_model(nd))(moe, batch)
out["moe_sharded_vs_dense"] = worst(g_sh, g_d)
dn = nest(dict(np.load(TMP + "/dense.npz")))
cfg_g = load_config("qwen3_8b", smoke=True).replace(
    param_dtype=jnp.float32, compute_dtype=jnp.float32)
cfg_v = cfg_g.replace(ce_impl="vocab_parallel", embed_sharding="model_only")
with jax.set_mesh(mesh):
    lg, gg = vg(MF.build_model(cfg_g, axes, mesh))(dn, batch)
    lv, gv = vg(MF.build_model(cfg_v, axes, mesh))(dn, batch)
out["vp"], out["gather"] = float(lv), float(lg)
out["vp_vs_gather"] = worst(gv, gg)
np.savez(TMP + "/ref.npz", **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port, reference) on the reference's weights: the four ranks and
    the reference's four devices run side by side."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from repro.configs.base import load_config
    from repro.models import model as RMF
    from repro_torch.models.transformer import flatten_tree

    tmp = tmp_path_factory.mktemp("mesh_moe")
    rng = np.random.default_rng(11)
    np.savez(tmp / "inputs.npz",
             tokens=rng.integers(0, 500, (BATCH, SEQ)).astype(np.int32),
             labels=rng.integers(0, 500, (BATCH, SEQ)).astype(np.int32))
    for name, arch, key in (("moe", "phi3_5_moe_42b", 1),
                            ("dense", "qwen3_8b", 0)):
        cfg = load_config(arch, smoke=True).replace(
            param_dtype=jax.numpy.float32)
        tree = RMF.build_model(cfg).init(jax.random.PRNGKey(key))
        np.savez(tmp / f"{name}.npz", **flatten_tree(
            jax.tree.map(np.asarray, tree)))
    with ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(run_py, REFERENCE % str(tmp), 4, 240)
        port = run_ranks(Path(__file__), WORLD, tmp, "regions")
        assert "REF_OK" in ref_run.result()
    return port, dict(np.load(tmp / "ref.npz"))


def _worst(got: dict, want: dict) -> tuple:
    assert got.keys() == want.keys()
    return max((float((got[k] - want[k]).abs().max()) /
                max(float(want[k].abs().max()), 1e-30), k) for k in want)


def test_moe_bf16_loss_matches_the_reference_sharded_loss(results):
    port, ref = results
    assert abs(port["moe_bf16"] - float(ref["moe_bf16"])) < MOE_BF16_TOL, \
        (port["moe_bf16"], float(ref["moe_bf16"]))


def test_moe_f32_loss_matches_the_reference_sharded_loss(results):
    port, ref = results
    want = float(ref["moe_f32"])
    assert abs(port["moe_f32"] - want) <= F32_REL * abs(want), \
        (port["moe_f32"], want)


def test_moe_expert_parallel_loss_and_grads_match_dense(results):
    port, _ = results
    assert abs(port["moe_nd"] - port["moe_dense"]) <= \
        F32_REL * abs(port["moe_dense"])
    worst, leaf = _worst(port["moe_nd_grads"], port["moe_dense_grads"])
    assert worst <= F32_REL, (worst, leaf)
    # every expert leaf took part
    assert float(port["moe_nd_grads"]["layers.moe.w_down"].abs().min(
        dim=-1).values.max()) > 0


def test_vocab_parallel_ce_matches_gather_loss_and_grads(results):
    port, ref = results
    assert abs(port["vp"] - port["gather"]) < VP_TOL, (port["vp"],
                                                       port["gather"])
    worst, leaf = _worst(port["vp_grads"], port["gather_grads"])
    assert worst < VP_TOL, (worst, leaf)
    assert abs(port["vp"] - float(ref["vp"])) < VP_TOL
    assert port["vp_embed_placements"] == ["Replicate", "Shard0"]


def test_reference_sharded_gradients_equal_its_dense_ones(results):
    """Nothing of the reference's regions to keep out of the port: its
    expert-parallel and vocab-parallel gradients are its dense ones."""
    _, ref = results
    assert float(ref["moe_sharded_vs_dense"]) <= F32_REL
    assert float(ref["vp_vs_gather"]) <= VP_TOL


if __name__ == "__main__":
    rank_main(CHECKS)
