"""The port's sharding rules and meshes against the reference's, on the
CPU.

In this process (no group, no spawn): ``param_pspecs`` leaf by leaf equal
to the reference's for every arch in ``ARCH_IDS`` at full size (the
port's model on ``meta`` against the reference's ``eval_shape`` of its
init), with ``embed_sharding="model_only"`` too; ``state_pspecs`` of each
family's decode state with the KV cache partitioned by heads and by
sequence; ``input_pspecs`` of every cell and ``choose_kv_partition``;
``to_shardings`` and ``abstract_params``.

In a child process over the ``fake`` backend (no communication): the
production meshes at 256 and 512 ranks, their shapes and axis names, and
``axes_for`` and ``batch_shardable`` of every (arch, shape) cell on them,
against the reference's functions on a mesh of the same shape; then, on a
one-rank gloo group the 1 x 1 host mesh starts itself, what ``sc`` and
the placements do and refuse.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
from jax.sharding import PartitionSpec

from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import load_config as r_load
from repro.models import model as RMF
from repro.models.sharding import MeshAxes as RAxes
from repro_torch.configs.base import load_config as p_load
from repro_torch.models import model as PMF
from repro_torch.models.sharding import P, MeshAxes

SRC = Path(__file__).resolve().parents[1] / "src"
FAMILY_ARCHS = ["smollm_360m", "qwen2_vl_2b", "phi3_5_moe_42b",
                "mamba2_2_7b", "zamba2_2_7b", "whisper_medium"]


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): tuple(spec) for path, spec in leaves}


def _port_flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, f"{prefix}{k}."))
        else:
            assert isinstance(v, P), (prefix + k, v)
            out[prefix + k] = tuple(v)
    return out


def _configs(arch, **kw):
    return r_load(arch).replace(**kw), p_load(arch).replace(**kw)


@pytest.mark.parametrize("embed", ["model_data", "model_only"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_are_the_references(arch, embed):
    rcfg, pcfg = _configs(arch, embed_sharding=embed)
    ref = RMF.param_pspecs(RMF.abstract_params(RMF.build_model(rcfg)), rcfg)
    port = PMF.param_pspecs(PMF.build_model(pcfg, device="meta"), pcfg)
    want, got = _ref_flat(ref), _port_flat(port)
    assert got == want
    assert any(s[-2:] == (("model", None) if embed == "model_only" else
                          ("model", "data")) for k, s in got.items()
               if k.endswith("embed"))


@pytest.mark.parametrize("kv", ["heads", "seq"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_state_pspecs_are_the_references(arch, kv):
    rcfg, pcfg = r_load(arch, smoke=True), p_load(arch, smoke=True)
    kw = dict(batch=("pod", "data"), model="model", enabled=True,
              kv_partition=kv)
    r_state = RMF.build_model(rcfg).decode_state_specs(4, 64)
    p_state = PMF.build_model(pcfg, device="meta").decode_state_specs(4, 64)
    want = _ref_flat(RMF.state_pspecs(r_state, RAxes(**kw)))
    got = _port_flat(PMF.state_pspecs(p_state, MeshAxes(**kw)))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_pspecs_and_kv_partition_are_the_references(arch):
    rcfg, pcfg = _configs(arch)
    for batch in ((), ("data",), ("pod", "data")):
        kw = dict(batch=batch, model="model", enabled=True)
        for shape in SHAPES.values():
            want = RMF.input_pspecs(rcfg, shape, RAxes(**kw))
            got = PMF.input_pspecs(pcfg, shape, MeshAxes(**kw))
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}
            assert all(isinstance(v, P) for v in got.values())
    for tp in (1, 2, 4, 16):
        assert PMF.choose_kv_partition(pcfg, tp) == \
            RMF.choose_kv_partition(rcfg, tp)


def test_to_shardings_names_shard_and_replicate_by_mesh_dimension():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    got = PMF.to_shardings(mesh, {"w": P(None, ("pod", "data"), "model"),
                                  "n": P(), "e": P("model", None)})
    from torch.distributed.tensor import Replicate, Shard
    assert got["w"] == (mesh, (Shard(1), Shard(1), Shard(2)))
    assert got["n"] == (mesh, (Replicate(),) * 3)
    assert got["e"] == (mesh, (Replicate(), Replicate(), Shard(0)))


def test_abstract_params_allocate_nothing():
    cfg = p_load("llama4_scout_17b")
    tree = PMF.abstract_params(PMF.build_model(cfg, device="meta"))
    leaves = [t for t in jax.tree.leaves(tree)]
    assert leaves and all(t.device.type == "meta" for t in leaves)
    ref = RMF.abstract_params(RMF.build_model(r_load("llama4_scout_17b")))
    assert sorted(tuple(t.shape) for t in leaves) == \
        sorted(tuple(t.shape) for t in jax.tree.leaves(ref))


MESHES = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import ARCH_IDS, SHAPES, load_config
from repro_torch.launch import mesh as LM
from repro_torch.models import model as MF
from repro_torch.models import sharding as SH
out = {"meshes": {}, "axes": {}, "refusals": []}

def refused(what, fn, err):
    try:
        fn()
    except err as e:
        out["refusals"].append(what)

refused("host mesh without a group", lambda: LM.make_host_mesh(
    2, 2, device_type="cpu"), RuntimeError)
refused("no current mesh", LM.current_mesh, RuntimeError)
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    mesh = LM.make_production_mesh(multi_pod=multi, device_type="cpu")
    out["meshes"][world] = [list(mesh.mesh_dim_names), list(mesh.shape)]
    refused(f"a 2 x 2 host mesh on {world} ranks", lambda: LM.make_host_mesh(
        2, 2, device_type="cpu"), RuntimeError)
    refused(f"the other production mesh on {world} ranks",
            lambda: LM.make_production_mesh(multi_pod=not multi,
                                            device_type="cpu"), RuntimeError)
    with LM.set_mesh(mesh):
        assert LM.current_mesh() is mesh
    for arch in ARCH_IDS:
        cfg = load_config(arch)
        for name, shape in SHAPES.items():
            a = MF.axes_for(cfg, shape, mesh)
            out["axes"][f"{world}/{arch}/{name}"] = [
                list(a.batch), a.model, a.enabled, a.kv_partition,
                MF.batch_shardable(shape, mesh)]
    dist.destroy_process_group()

# a 1 x 1 host mesh starts its own one-rank group
mesh = LM.make_host_mesh(1, 1, device_type="cpu")
out["host"] = [dist.get_world_size(), dist.get_backend(),
               list(mesh.mesh_dim_names), list(mesh.shape)]
axes = SH.make_axes(mesh)
x = SH.distribute(torch.arange(12.0).reshape(4, 3), mesh, SH.P("data"))
y = SH.sc(x, axes, None, "model")
out["sc"] = [str(p) for p in y.placements] + [
    bool(torch.equal(y.full_tensor(), x.full_tensor())),
    SH.sc(x, axes, "batch") is x,
    SH.sc(y, SH.SINGLE, "batch") is y]
refused("sc on a plain tensor", lambda: SH.sc(torch.ones(2), axes, "batch"),
        TypeError)
refused("axes out of the mesh's order", lambda: SH.placements(
    mesh, SH.P(("model", "data"))), ValueError)
refused("an axis named twice", lambda: SH.placements(
    mesh, SH.P("data", "data")), ValueError)
refused("a spec longer than the tensor", lambda: SH.placements(
    mesh, SH.P(None, None, "data"), 2), ValueError)
refused("a second group", lambda: LM.start_local_group("cpu"), RuntimeError)
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def meshes():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", MESHES], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_production_meshes_have_the_references_shapes(meshes):
    assert meshes["meshes"] == {"256": [["data", "model"], [16, 16]],
                                "512": [["pod", "data", "model"],
                                        [2, 16, 16]]}


def test_axes_for_and_batch_shardable_on_production_meshes(meshes):
    stubs = {"256": {"data": 16, "model": 16},
             "512": {"pod": 2, "data": 16, "model": 16}}
    for key, got in meshes["axes"].items():
        world, arch, name = key.split("/")
        shp = stubs[world]
        stub = SimpleNamespace(axis_names=tuple(shp), shape=shp)
        cfg, shape = r_load(arch), SHAPES[name]
        a = RMF.axes_for(cfg, shape, stub)
        assert got == [list(a.batch), a.model, a.enabled, a.kv_partition,
                       RMF.batch_shardable(shape, stub)], key
    assert len(meshes["axes"]) == 2 * len(ARCH_IDS) * len(SHAPES)


def test_host_mesh_starts_a_one_rank_group_and_sc_redistributes(meshes):
    assert meshes["host"] == [1, "gloo", ["data", "model"], [1, 1]]
    assert meshes["sc"] == ["R", "S(1)", True, True, True]


def test_meshes_refuse_what_the_reference_refuses(meshes):
    assert meshes["refusals"] == [
        "host mesh without a group", "no current mesh",
        "a 2 x 2 host mesh on 256 ranks",
        "the other production mesh on 256 ranks",
        "a 2 x 2 host mesh on 512 ranks",
        "the other production mesh on 512 ranks",
        "sc on a plain tensor", "axes out of the mesh's order",
        "an axis named twice", "a spec longer than the tensor",
        "a second group"]
