"""Every family's sharded loss and gradients on a 2 x 2 (data, model) mesh
equal the unsharded model's, on the CPU: four gloo ranks
(``torch_mesh_util.run_ranks``), the dense (``smollm_360m``: 3 heads, split
unevenly over 2 model ranks), VLM (``qwen2_vl_2b``), SSM
(``mamba2_2_7b``), hybrid (``zamba2_2_7b``) and encoder-decoder
(``whisper_medium``) smoke configs in f32, placed by ``param_pspecs`` from
the same seed, one synthetic batch of 4 rows (the MoE family and the
trainer are in ``test_torch_mesh_moe.py`` and ``test_torch_mesh_train.py``).

The loss within ``F32_REL`` (1e-5) relative, and each gradient, gathered,
within ``F32_REL`` of its leaf's largest element: only the order of the
sums over the shards differs.

Run as ``python tests/test_torch_mesh_families.py --rank ...`` this file
is one rank (``torch_mesh_util.rank_main``); it imports no jax then.
"""
from pathlib import Path

import pytest
import torch

from torch_mesh_util import rank_main, run_ranks

F32_REL = 1e-5
WORLD = 4
ARCHS = ["smollm_360m", "qwen2_vl_2b", "mamba2_2_7b", "zamba2_2_7b",
         "whisper_medium"]
BATCH, TEXT = 4, 32


def _check_families(tmp: Path) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeSpec, load_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as MF

    mesh = make_host_mesh(2, 2, device_type="cpu")
    out = {}
    for arch in ARCHS:
        cfg = load_config(arch, smoke=True).replace(
            compute_dtype=torch.float32)
        seq = TEXT + (cfg.num_patch_tokens if cfg.family == "vlm" else 0)
        shape = ShapeSpec("t", seq, BATCH, "train")
        batch = SyntheticTokens(cfg, shape, DataConfig(
            seed=5, vocab_size=min(cfg.vocab_size, 512)),
            device="cpu").batch_at(0)
        res = {}
        for name, axes in (("plain", None),
                           ("sharded", MF.axes_for(cfg, shape, mesh))):
            model = MF.build_model(cfg, axes, mesh if axes else None,
                                   device="cpu").init(
                torch.Generator().manual_seed(4))
            model.requires_grad_(True)
            loss, _ = model.loss(batch)
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params)
            whole = [g.full_tensor() if isinstance(g, DTensor) else g
                     for g in grads]
            res[name] = (float(loss.detach()), dict(zip(names, whole)),
                         all(isinstance(p, DTensor) for p in params))
        out[arch] = res
    return out


CHECKS = {"families": _check_families}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_ranks(Path(__file__), WORLD,
                     tmp_path_factory.mktemp("mesh_families"), "families")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_equal_unsharded(results, arch):
    (l0, g0, plain_dt), (l1, g1, all_dt) = (results[arch]["plain"],
                                            results[arch]["sharded"])
    assert all_dt and not plain_dt
    assert abs(l1 - l0) <= F32_REL * abs(l0), (l1, l0)
    assert g1.keys() == g0.keys()
    worst = max((float((g1[k] - g0[k]).abs().max()) /
                 max(float(g0[k].abs().max()), 1e-30), k) for k in g0)
    assert worst[0] <= F32_REL, worst


if __name__ == "__main__":
    rank_main(CHECKS)
