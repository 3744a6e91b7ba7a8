"""The port's explicit collectives on a mesh against the reference's, on
the CPU: four gloo ranks (``torch_mesh_util.run_ranks``) beside the
reference on four forced XLA host devices (``run_py``, as
``tests/test_multidevice.py`` runs it), on the same inputs drawn with
numpy:

  * ``psum_int8`` over a 4-rank ``data`` axis: each rank's int8 payload
    and f32 scales bit-identical to the reference's, the sum within
    ``PSUM_REL`` (1e-6) relative of the reference's ``psum_int8`` and
    within ``4 * scale / 127`` of the exact sum, as the reference's test
    allows; ``compressed_psum_tree`` is ``psum_int8`` leaf by leaf;
  * ``pipeline_apply`` with 4 stages over ``pod`` and 6 microbatches of an
    8-layer tanh stack, within ``PIPE_TOL`` (1e-5) of the sequential stack
    and of the reference's pipeline; so are the gradients of a scalar loss
    (the outputs against a fixed cotangent) for the weights, the biases
    and ``xs``, against ``torch.autograd.grad`` of the sequential stack
    and the reference's ``jax.grad`` of its pipeline;
  * ``decode_attention`` with the cache sequence-sharded over a 4-rank
    ``model`` axis (minitron smoke, f32), within ``DECODE_TOL`` (1e-4) of
    the unsharded port and of the reference's sharded call; and a Qwen3
    smoke ``decode_step`` on a 1 x 4 mesh with ``kv_partition="seq"``
    (the cache written shard by shard) within ``DECODE_TOL`` of the
    unsharded model's, from the same prefill.

Run as ``python tests/test_torch_mesh_collectives.py --rank ...`` this
file is one rank (``torch_mesh_util.rank_main``); it imports no jax then.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_mesh_util import rank_main, run_py, run_ranks

PSUM_REL = 1e-6
PIPE_TOL = 1e-5
DECODE_TOL = 1e-4
WORLD = 4
PIPE_L, PIPE_D, PIPE_MICRO, PIPE_B = 8, 16, 6, 3
DECODE_B, DECODE_S, DECODE_POS = 2, 64, 50


def _inputs(tmp: Path):
    """The inputs of every check, drawn with numpy from fixed seeds."""
    rng = np.random.default_rng(7)
    cfg_heads = (4, 2, 16)   # minitron smoke: heads, kv heads, head dim
    hq, hkv, dh = cfg_heads
    arrays = {
        "psum_x": rng.standard_normal((WORLD, 1024)).astype(np.float32),
        "psum_y": (3 * rng.standard_normal((WORLD, 100))).astype(np.float32),
        "pipe_w": (0.2 * rng.standard_normal(
            (PIPE_L, PIPE_D, PIPE_D))).astype(np.float32),
        "pipe_b": (0.1 * rng.standard_normal(
            (PIPE_L, PIPE_D))).astype(np.float32),
        "pipe_xs": rng.standard_normal(
            (PIPE_MICRO, PIPE_B, PIPE_D)).astype(np.float32),
        "pipe_ct": rng.standard_normal(
            (PIPE_MICRO, PIPE_B, PIPE_D)).astype(np.float32),
        "dec_q": rng.standard_normal((DECODE_B, 1, hq, dh)).astype(np.float32),
        "dec_k": rng.standard_normal(
            (DECODE_B, DECODE_S, hkv, dh)).astype(np.float32),
        "dec_v": rng.standard_normal(
            (DECODE_B, DECODE_S, hkv, dh)).astype(np.float32),
        "dec_model_tokens": rng.integers(0, 500, (2, 12)).astype(np.int32),
        "dec_model_next": rng.integers(0, 500, (2,)).astype(np.int32),
    }
    np.savez(tmp / "inputs.npz", **arrays)
    return arrays


# ------------------------------------------------------------ the ranks
def _apply_stack(params, x):
    for w, b in zip(params["w"].unbind(0), params["b"].unbind(0)):
        x = torch.tanh(x @ w + b)
    return x


def _check_collectives(tmp: Path) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs.base import load_config
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as MF
    from repro_torch.models.sharding import SINGLE, MeshAxes
    from repro_torch.optim import compression as C
    from repro_torch.train.pipeline import pipeline_apply, split_stages

    inp = {k: torch.from_numpy(v) for k, v in
           np.load(tmp / "inputs.npz").items()}
    rank = dist.get_rank()
    out = {}

    # psum_int8 over "data"
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    x = inp["psum_x"][rank]
    with set_mesh(mesh):
        out["psum"] = C.psum_int8(x, "data")
        tree = C.compressed_psum_tree({"x": x, "y": inp["psum_y"][rank]},
                                      "data")
    q, scale, _ = C.quantize_int8(x)
    qs = [torch.empty_like(q) for _ in range(WORLD)]
    ss = [torch.empty_like(scale) for _ in range(WORLD)]
    dist.all_gather(qs, q)
    dist.all_gather(ss, scale)
    out["payload"], out["scales"] = torch.stack(qs), torch.stack(ss)
    with set_mesh(mesh):
        out["tree_y"] = C.psum_int8(inp["psum_y"][rank], "data")
    out["tree"] = tree
    # every rank's sum is rank 0's
    same = torch.tensor(int(torch.equal(out["psum"], _bcast(out["psum"]))))
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    out["psum_same_on_every_rank"] = bool(same)

    # the GPipe pipeline over "pod"
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("pod",))
    layers = {"w": inp["pipe_w"], "b": inp["pipe_b"]}
    got = pipeline_apply(_apply_stack, split_stages(layers, WORLD),
                         inp["pipe_xs"], mesh, axis="pod")
    out["pipe_placements"] = _names(got.placements)
    out["pipe"] = got.full_tensor()
    out["pipe_seq"] = torch.stack([_apply_stack(layers, xi)
                                   for xi in inp["pipe_xs"]])
    # gradients of sum(outputs * ct) through the sends, against the
    # sequential stack's
    stacked = split_stages(layers, WORLD)
    leaves = {k: distribute_tensor(v, mesh, [Shard(0)]).requires_grad_()
              for k, v in stacked.items()}
    xs = distribute_tensor(inp["pipe_xs"], mesh, [Replicate()])
    xs.requires_grad_()
    ct = distribute_tensor(inp["pipe_ct"], mesh, [Replicate()])
    got = pipeline_apply(_apply_stack, leaves, xs, mesh, axis="pod")
    gw, gb, gx = torch.autograd.grad((got * ct).sum(),
                                     [leaves["w"], leaves["b"], xs])
    out["pipe_grad"] = {"w": gw.full_tensor().reshape(inp["pipe_w"].shape),
                        "b": gb.full_tensor().reshape(inp["pipe_b"].shape),
                        "xs": gx.full_tensor()}
    seq = {k: v.clone().requires_grad_() for k, v in layers.items()}
    sx = inp["pipe_xs"].clone().requires_grad_()
    sy = torch.stack([_apply_stack(seq, xi) for xi in sx])
    out["pipe_grad_seq"] = dict(zip(("w", "b", "xs"), torch.autograd.grad(
        (sy * inp["pipe_ct"]).sum(), [seq["w"], seq["b"], sx])))

    # sequence-sharded decode attention over "model"
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("model",))
    cfg = load_config("minitron_8b", smoke=True).replace(
        compute_dtype=torch.float32)
    axes = MeshAxes(batch=(), model="model", enabled=True,
                    kv_partition="seq")
    rep = [Replicate()]
    dq, dk, dv = (distribute_tensor(inp[k], mesh, rep)
                  for k in ("dec_q", "dec_k", "dec_v"))
    got = L.decode_attention(dq, dk, dv, torch.tensor(DECODE_POS), cfg, axes)
    out["decode"] = got.full_tensor()
    out["decode_unsharded"] = L.decode_attention(
        inp["dec_q"], inp["dec_k"], inp["dec_v"], DECODE_POS, cfg, SINGLE)

    # a model's decode step with the cache sharded on its sequence (2 kv
    # heads on 4 model ranks: choose_kv_partition gives "seq")
    cfg = load_config("qwen3_8b", smoke=True).replace(
        compute_dtype=torch.float32)
    mesh = make_host_mesh(1, WORLD, device_type="cpu")
    plain = MF.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    axes = MF.make_axes(mesh, kv_partition=MF.choose_kv_partition(
        cfg, WORLD))
    assert axes.kv_partition == "seq"
    sharded = MF.build_model(cfg, axes, mesh, device="cpu").init(
        torch.Generator().manual_seed(3))
    tokens = inp["dec_model_tokens"]
    out["dec_model_tokens"] = tokens.shape[1]
    _, state = plain.prefill({"tokens": tokens}, pad_to=16)
    want, want_state = plain.decode_step(state, inp["dec_model_next"])
    got, got_state = sharded.decode_step(state, inp["dec_model_next"])
    out["dec_model_logits"], out["dec_model_want"] = got.full_tensor(), want
    out["dec_model_cache"] = got_state["kv"]["k"].full_tensor()
    out["dec_model_cache_want"] = want_state["kv"]["k"]
    out["dec_model_cache_placements"] = _names(
        got_state["kv"]["k"].placements)
    return out


def _names(placements):
    return [(type(p).__name__, getattr(p, "dim", None)) for p in placements]


def _bcast(t):
    import torch.distributed as dist
    t = t.clone()
    dist.broadcast(t, 0)
    return t


CHECKS = {"collectives": _check_collectives}

# ----------------------------------------------------- the reference run
REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import load_config
from repro.models.layers import decode_attention
from repro.models.sharding import MeshAxes
from repro.optim.compression import psum_int8, quantize_int8
from repro.train.pipeline import pipeline_apply, split_stages
inp = dict(np.load(sys.argv[1]))
out = {}
mesh = jax.make_mesh((4,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
x = jnp.asarray(inp["psum_x"])

def f(x):
    return psum_int8(x[0], "data"), jax.lax.psum(x[0], "data")

with jax.set_mesh(mesh):
    approx, exact = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=P("data"), out_specs=P(),
        check_vma=False))(x)
out["psum"], out["exact"] = np.asarray(approx), np.asarray(exact)
qs = [quantize_int8(x[r]) for r in range(4)]
out["payload"] = np.stack([np.asarray(q) for q, _, _ in qs])
out["scales"] = np.stack([np.asarray(s) for _, s, _ in qs])

mesh = jax.make_mesh((4,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
layers = {"w": jnp.asarray(inp["pipe_w"]), "b": jnp.asarray(inp["pipe_b"])}

def apply_stack(params, x):
    def body(h, lp):
        return jnp.tanh(h @ lp["w"] + lp["b"]), None
    h, _ = jax.lax.scan(body, x, params)
    return h

with jax.set_mesh(mesh):
    pipe = jax.jit(lambda p, x: pipeline_apply(
        apply_stack, p, x, mesh, axis="pod"))(split_stages(layers, 4),
                                              jnp.asarray(inp["pipe_xs"]))
out["pipe"] = np.asarray(pipe)
ct = jnp.asarray(inp["pipe_ct"])

def pipe_loss(p, x):
    return jnp.sum(pipeline_apply(apply_stack, p, x, mesh, axis="pod") * ct)

with jax.set_mesh(mesh):
    gp, gx = jax.jit(jax.grad(pipe_loss, argnums=(0, 1)))(
        split_stages(layers, 4), jnp.asarray(inp["pipe_xs"]))
out["pipe_gw"] = np.asarray(gp["w"]).reshape(inp["pipe_w"].shape)
out["pipe_gb"] = np.asarray(gp["b"]).reshape(inp["pipe_b"].shape)
out["pipe_gxs"] = np.asarray(gx)

mesh = jax.make_mesh((4,), ("model",),
                     axis_types=(jax.sharding.AxisType.Auto,))
cfg = load_config("minitron_8b", smoke=True).replace(
    compute_dtype=jnp.float32)
axes = MeshAxes(batch=(), model="model", enabled=True, kv_partition="seq")
with jax.set_mesh(mesh):
    got = jax.jit(lambda *a: decode_attention(*a, cfg, axes))(
        jnp.asarray(inp["dec_q"]), jnp.asarray(inp["dec_k"]),
        jnp.asarray(inp["dec_v"]), jnp.int32(%d))
out["decode"] = np.asarray(got)
np.savez(sys.argv[2], **out)
print("REF_OK")
""" % DECODE_POS


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port, reference): the four ranks' results and the reference's, the
    two runs side by side."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("mesh_collectives")
    _inputs(tmp)
    ref_code = REFERENCE.replace(
        "inp = dict(np.load(sys.argv[1]))",
        f"inp = dict(np.load({str(tmp / 'inputs.npz')!r}))").replace(
        "np.savez(sys.argv[2], **out)",
        f"np.savez({str(tmp / 'ref.npz')!r}, **out)")
    with ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(run_py, ref_code, 4, 240)
        port = run_ranks(Path(__file__), WORLD, tmp, "collectives")
        assert "REF_OK" in ref_run.result()
    ref = dict(np.load(tmp / "ref.npz"))
    return port, ref


def test_psum_int8_payload_and_scales_are_the_references(results):
    port, ref = results
    np.testing.assert_array_equal(port["payload"].numpy(), ref["payload"])
    np.testing.assert_array_equal(port["scales"].numpy(), ref["scales"])


def test_psum_int8_sums_as_the_reference_does(results):
    port, ref = results
    got = port["psum"].numpy()
    np.testing.assert_allclose(got, ref["psum"], rtol=PSUM_REL,
                               atol=PSUM_REL * np.abs(ref["psum"]).max())
    err = float(np.max(np.abs(got - ref["exact"])))
    scale = float(np.max(np.abs(ref["exact"])))
    assert err < 4 * scale / 127, (err, scale)
    assert port["psum_same_on_every_rank"]


def test_compressed_psum_tree_is_psum_int8_leaf_by_leaf(results):
    port, _ = results
    assert torch.equal(port["tree"]["x"], port["psum"])
    assert torch.equal(port["tree"]["y"], port["tree_y"])


def test_pipeline_matches_sequential_and_reference(results):
    port, ref = results
    got = port["pipe"].numpy()
    assert got.shape == (PIPE_MICRO, PIPE_B, PIPE_D)
    np.testing.assert_allclose(got, port["pipe_seq"].numpy(), atol=PIPE_TOL,
                               rtol=PIPE_TOL)
    np.testing.assert_allclose(got, ref["pipe"], atol=PIPE_TOL,
                               rtol=PIPE_TOL)
    assert port["pipe_placements"] == [("Replicate", None)]
    for k, ref_k in (("w", "pipe_gw"), ("b", "pipe_gb"), ("xs", "pipe_gxs")):
        g = port["pipe_grad"][k].numpy()
        np.testing.assert_allclose(g, port["pipe_grad_seq"][k].numpy(),
                                   atol=PIPE_TOL, rtol=PIPE_TOL, err_msg=k)
        np.testing.assert_allclose(g, ref[ref_k], atol=PIPE_TOL,
                                   rtol=PIPE_TOL, err_msg=k)


def test_seq_sharded_decode_matches_unsharded_and_reference(results):
    port, ref = results
    got = port["decode"].numpy()
    np.testing.assert_allclose(got, port["decode_unsharded"].numpy(),
                               atol=DECODE_TOL, rtol=DECODE_TOL)
    np.testing.assert_allclose(got, ref["decode"], atol=DECODE_TOL,
                               rtol=DECODE_TOL)


def test_seq_sharded_model_decode_step_matches_unsharded(results):
    port, _ = results
    np.testing.assert_allclose(port["dec_model_logits"].numpy(),
                               port["dec_model_want"].numpy(), atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    # the step's row written into the shard that holds it, the rest kept
    got, want = port["dec_model_cache"], port["dec_model_cache_want"]
    S = port["dec_model_tokens"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    assert torch.equal(got[:, :, :S], want[:, :, :S])      # the prefill's
    assert torch.count_nonzero(got[:, :, S]) == got[:, :, S].numel()
    assert not torch.any(got[:, :, S + 1:])
    assert port["dec_model_cache_placements"] == [("Shard", 1), ("Shard", 2)]


if __name__ == "__main__":
    rank_main(CHECKS)
