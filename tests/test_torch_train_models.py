"""The port's training losses and gradients against the reference's, on
the CPU: ``loss`` of every family (dense, VLM, MoE, SSM, hybrid,
encoder-decoder) and its gradients against
``jax.value_and_grad(model.loss, has_aux=True)`` on carried weights
(``models/carry.py``) and the same batch, in f32 and in bf16 compute.
``chunked_ce_loss`` and the ``cfg.remat`` settings are held in
``test_torch_train_remat.py``, which shares this file's helpers.

Inputs are made with numpy from fixed seeds (``B`` x ``S`` = 2 x 32,
labels with -1 at the first positions of a row).  Tolerances:

* f32 compute: the loss within ``F32_LOSS_REL`` (1e-5) relative; each
  gradient leaf's max |port - reference| within ``F32_GRAD_REL`` (1e-4)
  of the reference leaf's max |g| (measured: under 2e-6).
* bf16 compute: the loss within ``BF16_LOGIT_TOL`` (3e-2, the serving
  tests' logit bound); each leaf's ||port - reference|| / ||reference||
  within ``BF16_GRAD_REL`` (5e-2).  XLA keeps fused bf16 chains in f32
  where PyTorch rounds each op; the reference's own bf16 gradients are
  3-4.5% (L2) from its f32 gradients on Zamba2's smoke config, and the
  port's sit as far from them (measured: 3.0-4.7% port against reference
  on Zamba2, under 2.7% on the other families).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import load_config as r_load
from repro.models import model as RMF
from repro_torch.configs.base import load_config as p_load
from repro_torch.models.carry import params_from_reference

FAMILY_ARCHS = ["smollm_360m", "qwen2_vl_2b", "phi3_5_moe_42b",
                "mamba2_2_7b", "zamba2_2_7b", "whisper_medium"]
B, S = 2, 32
F32_LOSS_REL = 1e-5
F32_GRAD_REL = 1e-4
BF16_LOGIT_TOL = 3e-2
BF16_GRAD_REL = 5e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _batch(cfg, seed=1):
    """A training batch as numpy arrays: tokens, labels (-1 on the first
    three positions of row 0) and the family's modality stub."""
    rng = np.random.default_rng(seed)
    n_text = S - (cfg.num_patch_tokens if cfg.family == "vlm" else 0)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, n_text)),
         "labels": rng.integers(0, cfg.vocab_size, (B, n_text))}
    b = {k: v.astype(np.int32) for k, v in b.items()}
    b["labels"][0, :3] = -1
    if cfg.family == "vlm":
        b["patch_embeds"] = (rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        b["audio_frames"] = (rng.standard_normal(
            (B, cfg.num_audio_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return b


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _port_grads(model, batch):
    model.requires_grad_(True)
    loss, metrics = model.loss({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), metrics, dict(zip(names, grads))


@pytest.fixture(scope="module")
def reference():
    """(loss, metrics, flat grads) of the reference per (arch, dtype), and
    its initial params: one jitted value_and_grad each."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            rcfg = r_load(arch, smoke=True).replace(
                compute_dtype=DTYPES[dtype][0])
            ref = RMF.build_model(rcfg)
            params = ref.init(jax.random.PRNGKey(0))
            batch = _batch(rcfg)
            (loss, metrics), grads = jax.jit(jax.value_and_grad(
                ref.loss, has_aux=True))(params, tree_np(batch))
            cache[arch, dtype] = (float(loss), jax.tree.map(float, metrics),
                                  _flat(grads),
                                  jax.tree.map(np.asarray, params), batch)
        return cache[arch, dtype]

    return get


def tree_np(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_match_the_reference(reference, arch, dtype):
    r_loss, r_metrics, r_grads, params, batch = reference(arch, dtype)
    pcfg = p_load(arch, smoke=True).replace(compute_dtype=DTYPES[dtype][1])
    port = params_from_reference(pcfg, params, device="cpu")
    loss, metrics, grads = _port_grads(port, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert set(metrics) == set(r_metrics)
    if dtype == "f32":
        assert abs(float(loss) - r_loss) <= F32_LOSS_REL * abs(r_loss)
        for k, v in metrics.items():
            assert abs(float(v.detach()) - r_metrics[k]) <= \
                F32_LOSS_REL * abs(r_metrics[k]) + 1e-7, k
    else:
        assert abs(float(loss) - r_loss) <= BF16_LOGIT_TOL
    assert set(grads) == set(r_grads)
    for name, g in grads.items():
        got, want = g.float().numpy(), r_grads[name]
        assert got.shape == want.shape, name
        if dtype == "f32":
            err = float(np.max(np.abs(got - want)))
            bound = F32_GRAD_REL * float(np.max(np.abs(want)))
        else:
            err = float(np.linalg.norm(got - want))
            bound = BF16_GRAD_REL * float(np.linalg.norm(want))
        assert err <= bound, f"{name}: {err:.3g} > {bound:.3g}"
