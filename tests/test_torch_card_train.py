"""The port's training path on the card against the same path on the CPU.

Every test is marked ``cuda`` and skips without a GPU.  The file imports
neither jax nor the reference package, so a GPU host without jax collects
and runs it:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card_train.py

(``chip_smoke.py``'s ``[card-tests]`` phase runs every
``tests/test_torch_card_*.py``).  Each family's smoke config, weights from
``torch.Generator(seed 0)``, f32 compute with TF32 off: the loss within
``LOSS_REL`` (1e-4) relative and each gradient leaf within ``GRAD_REL``
(1e-3) of its largest CPU magnitude; one train step's ``loss`` and
``grad_norm`` within ``LOSS_REL``; the pipeline's batch and a checkpoint
written from the card equal to the CPU's bit for bit.
"""
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ShapeSpec, load_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train.train_loop import make_train_step
from repro_torch.tree_util import tree_leaves

FAMILY_ARCHS = ["smollm_360m", "qwen2_vl_2b", "phi3_5_moe_42b",
                "mamba2_2_7b", "zamba2_2_7b", "whisper_medium"]
LOSS_REL = 1e-4
GRAD_REL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's half of a card = CPU "
                    "check)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _pair(arch, card):
    cfg = load_config(arch, smoke=True).replace(compute_dtype=torch.float32)
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    dev = build_model(cfg, device="meta")
    dev.load_state_dict({k: v.to(card, copy=True)
                         for k, v in cpu.state_dict().items()},
                        strict=True, assign=True)
    seq = 32 + (cfg.num_patch_tokens if cfg.family == "vlm" else 0)
    data = SyntheticTokens(cfg, ShapeSpec("t", seq, 4, "train"),
                           DataConfig(seed=1), device="cpu")
    return cfg, cpu, dev, data


def _grads(model, batch):
    model.requires_grad_(True)
    loss, _ = model.loss(batch)
    names, params = zip(*model.named_parameters())
    return loss.detach(), dict(zip(names,
                                   torch.autograd.grad(loss, params)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_on_the_card_equal_the_cpu(card, arch):
    _, cpu, dev, data = _pair(arch, card)
    batch = data.batch_at(0)
    want_loss, want = _grads(cpu, batch)
    got_loss, got = _grads(dev, {k: v.to(card) for k, v in batch.items()})
    assert abs(float(got_loss) - float(want_loss)) <= \
        LOSS_REL * abs(float(want_loss))
    for name, g in want.items():
        err = float((got[name].cpu() - g).abs().max())
        assert err <= GRAD_REL * float(g.abs().max()) + 1e-12, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_on_the_card_equals_the_cpu(card, microbatches):
    _, cpu, dev, data = _pair("phi3_5_moe_42b", card)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    steps = {m: make_train_step(m, opt, microbatches) for m in (cpu, dev)}
    states = {m: adamw.init_state(m) for m in (cpu, dev)}
    for step in range(2):
        batch = data.batch_at(step)
        out = {}
        for m, where in ((cpu, "cpu"), (dev, card)):
            _, states[m], out[where] = steps[m](
                m, states[m], {k: v.to(where) for k, v in batch.items()})
        assert set(out["cpu"]) == set(out[card])
        for k in ("loss", "grad_norm", "lr"):
            got, want = float(out[card][k]), float(out["cpu"][k])
            assert abs(got - want) <= LOSS_REL * abs(want), (step, k)
    assert int(states[dev].step) == 2 and states[dev].step.is_cuda


@pytest.mark.cuda
def test_pipeline_and_checkpoint_on_the_card_equal_the_cpu(card, tmp_path):
    cfg, cpu, dev, data = _pair("whisper_medium", card)
    on_card = SyntheticTokens(cfg, data.shape, data.dc, device=card)
    for k, v in data.batch_at(3).items():
        got = on_card.batch_at(3)[k]
        assert got.is_cuda and torch.equal(got.cpu(), v), k
    state = adamw.init_state(dev)
    ckpt.save_checkpoint(tmp_path / "card", 1, (dev, state), chunks=2)
    ckpt.save_checkpoint(tmp_path / "cpu", 1, (cpu, adamw.init_state(cpu)),
                         chunks=2)
    names = sorted(p.name for p in (tmp_path / "cpu" /
                                    "00000001.ckpt").iterdir())
    for name in names:
        if name != "manifest.json":
            assert (tmp_path / "card" / "00000001.ckpt" / name).read_bytes() \
                == (tmp_path / "cpu" / "00000001.ckpt" / name).read_bytes()
    _, got, _ = ckpt.restore_checkpoint(tmp_path / "card" / "00000001.ckpt",
                                        (dev, state))
    for a, b in zip(tree_leaves(got), tree_leaves((dev, state))):
        assert a.is_cuda and torch.equal(a, b)
