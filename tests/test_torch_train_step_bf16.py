"""The port's train step against the reference's in bf16 compute, on the
CPU: ``test_torch_train_step.py``'s three steps from carried weights on
the reference's batches, one microbatch, every family.

Per step ``loss`` within ``BF16_LOGIT_TOL`` (3e-2) and ``grad_norm``
within ``BF16_GRAD_REL`` (5e-2) relative, the bf16 bounds of
``test_torch_train_models.py`` (stated there: XLA keeps fused bf16 chains
in f32 where PyTorch rounds each op); ``lr`` within 1e-6.  The metrics'
keys are the reference's.
"""
import jax
import pytest
import torch

from test_torch_train_models import BF16_GRAD_REL, BF16_LOGIT_TOL
from test_torch_train_step import FAMILY_ARCHS, LR_REL, run_both


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bf16_train_steps_match_the_reference(arch):
    metrics, _, _ = run_both(arch, 1, (jax.numpy.bfloat16, torch.bfloat16))
    for step, (r_m, p_m) in enumerate(metrics):
        assert set(p_m) == set(r_m)
        loss, want = float(p_m["loss"]), float(r_m["loss"])
        assert abs(loss - want) <= BF16_LOGIT_TOL, (step, loss, want)
        gn, want = float(p_m["grad_norm"]), float(r_m["grad_norm"])
        assert abs(gn - want) <= BF16_GRAD_REL * want, (step, gn, want)
        lr, want = float(p_m["lr"]), float(r_m["lr"])
        assert abs(lr - want) <= LR_REL * want, (step, lr, want)
