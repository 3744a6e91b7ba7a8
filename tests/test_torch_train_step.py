"""The port's train step against the reference's, on the CPU: for every
family, ``train/train_loop.make_train_step`` in both packages from the
same (carried) weights runs three steps on the same ``SyntheticTokens``
batches (the reference's, as numpy: its modality stubs are ``jax.random``
draws), with one microbatch and with two (the reference's strided split).

f32 compute.  Per step, ``loss`` and ``grad_norm`` agree within
``STEP_REL`` (1e-5) relative and ``lr`` within 1e-6 (the loss tests' and
the AdamW tests' bounds, ``test_torch_train_models.py`` and
``test_torch_train.py``).  After the third step each parameter leaf's
mean |port - reference| is within ``PARAM_TOL`` (1e-5) and every element
within ``2 * lr * STEPS``: AdamW normalizes each gradient element, so
where an element's gradient sits at f32 noise its update's sign may
differ (measured: a few elements a leaf off by up to 1.1e-4, the rest
within 1e-6).  The metrics' keys are the
reference's for both microbatch counts (the MoE's ``load_balance`` and
``router_z`` only with one).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as RShape
from repro.configs.base import load_config as r_load
from repro.data.pipeline import DataConfig, SyntheticTokens
from repro.models import model as RMF
from repro.optim import adamw as r_adamw
from repro.train.train_loop import make_train_step as r_make
from repro_torch.configs.base import load_config as p_load
from repro_torch.models.carry import params_from_reference
from repro_torch.optim import adamw as p_adamw
from repro_torch.train.train_loop import make_train_step as p_make

FAMILY_ARCHS = ["smollm_360m", "qwen2_vl_2b", "phi3_5_moe_42b",
                "mamba2_2_7b", "zamba2_2_7b", "whisper_medium"]
STEPS, BATCH, TEXT = 3, 4, 32
STEP_REL = 1e-5
LR_REL = 1e-6
PARAM_TOL = 1e-5
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=STEPS)


def _tensor(a):
    """A reference batch leaf as a tensor (bf16 exactly, through f32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def run_both(arch, microbatches, dtypes=(jax.numpy.float32, torch.float32)):
    """Three train steps in both packages; returns the metrics of each
    step (reference, port) and the final (reference params, port)."""
    rcfg = r_load(arch, smoke=True).replace(compute_dtype=dtypes[0])
    pcfg = p_load(arch, smoke=True).replace(compute_dtype=dtypes[1])
    seq = TEXT + (rcfg.num_patch_tokens if rcfg.family == "vlm" else 0)
    data = SyntheticTokens(rcfg, RShape("t", seq, BATCH, "train"),
                           DataConfig(seed=2, vocab_size=rcfg.vocab_size))
    ref = RMF.build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = params_from_reference(pcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    r_state = r_adamw.init_state(params)
    p_state = p_adamw.init_state(port)
    r_step = jax.jit(r_make(ref, r_adamw.AdamWConfig(**OPT), microbatches))
    p_step = p_make(port, p_adamw.AdamWConfig(**OPT), microbatches)
    metrics = []
    for step in range(STEPS):
        batch = data.batch_at(step)
        params, r_state, r_m = r_step(params, r_state, batch)
        _, p_state, p_m = p_step(port, p_state,
                                 {k: _tensor(v) for k, v in batch.items()})
        metrics.append((r_m, p_m))
    assert int(p_state.step) == STEPS
    return metrics, params, port


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_steps_match_the_reference(arch, microbatches):
    metrics, params, port = run_both(arch, microbatches)
    for step, (r_m, p_m) in enumerate(metrics):
        assert set(p_m) == set(r_m)
        for k in ("loss", "grad_norm", "lr"):
            assert p_m[k].dim() == 0 and p_m[k].dtype == torch.float32
            got, want = float(p_m[k]), float(r_m[k])
            rel = LR_REL if k == "lr" else STEP_REL
            assert abs(got - want) <= rel * abs(want), (step, k, got, want)
    flat = {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    for name, p in port.named_parameters():
        diff = np.abs(p.detach().numpy() - flat[name.replace(".", "/")])
        assert float(diff.mean()) <= PARAM_TOL, (name, float(diff.mean()))
        assert float(diff.max()) <= 2 * OPT["lr"] * STEPS, name


def test_microbatches_are_strided_rows():
    """Microbatch i of n holds rows i, i + n, ... (the reference's
    reshape then moveaxis), and a batch that n does not divide raises."""
    from repro_torch.train.train_loop import _split
    x = torch.arange(12).reshape(6, 2)
    mbs = _split(x, 2)
    assert torch.equal(mbs[0], x[0::2]) and torch.equal(mbs[1], x[1::2])
    with pytest.raises(ValueError, match="microbatches"):
        _split(x, 4)
