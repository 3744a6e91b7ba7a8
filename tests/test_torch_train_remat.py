"""The port's ``cfg.remat`` settings and ``chunked_ce_loss``, on the CPU.

The four remat settings (``"none"``, ``"full"``, ``"dots"``,
``"tp_out"``, ``models/transformer.py:_remat``) give every family the same
loss and gradients bit for bit (the same ops on the same values; only what
is kept between forward and backward differs), and each keeps what it
names: ``"full"`` runs a layer body again in the backward, ``"dots"``
keeps the unbatched products, ``"tp_out"`` the tagged outputs.
``chunked_ce_loss`` is held against the reference's, value and gradients,
at chunk sizes that divide ``S`` and one larger, with -1 labels masked.
Batches and tolerances are ``test_torch_train_models.py``'s (stated
there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import load_config as r_load
from repro.models import transformer as RT
from repro.models.sharding import SINGLE as R_SINGLE
from repro_torch.configs.base import load_config as p_load
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.sharding import SINGLE as P_SINGLE
from test_torch_train_models import (B, F32_GRAD_REL, F32_LOSS_REL,
                                     FAMILY_ARCHS, S, _batch, _port_grads)

REMATS = ("none", "full", "dots", "tp_out")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_settings_give_the_same_loss_and_gradients(arch):
    """none, full, dots and tp_out: bit for bit, on one init."""
    results = {}
    for remat in REMATS:
        cfg = p_load(arch, smoke=True).replace(compute_dtype=torch.float32,
                                               remat=remat)
        model = PT.build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        results[remat] = _port_grads(model, _batch(cfg))
    loss, _, grads = results["none"]
    for remat in REMATS[1:]:
        got_loss, _, got = results[remat]
        assert torch.equal(got_loss, loss), remat
        for name, g in grads.items():
            assert torch.equal(got[name], g), (remat, name)


def test_unknown_remat_raises():
    cfg = p_load("smollm_360m", smoke=True).replace(remat="most")
    with pytest.raises(ValueError, match="remat"):
        PT._remat(lambda x: x, cfg)


class _Count(TorchDispatchMode):
    """Counts the operators that run (not those a checkpoint serves from
    what it saved)."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_counts(remat, calls=None, forward=None):
    """Operator counts of one backward of SmolLM's smoke config in f32
    (and into ``forward``, those of its forward)."""
    cfg = p_load("smollm_360m", smoke=True).replace(
        compute_dtype=torch.float32, remat=remat)
    model = PT.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    with _Count() as fwd:
        loss, _ = model.loss({k: torch.from_numpy(v)
                              for k, v in _batch(cfg).items()})
    if forward is not None:
        forward.update(fwd.n)
    before = dict(calls) if calls is not None else None
    with _Count() as counter:
        torch.autograd.grad(loss, list(model.parameters()))
    ran = (None if calls is None else
           {k: calls[k] - before.get(k, 0) for k in calls})
    return counter.n, ran


def test_full_remat_runs_each_layer_body_again_in_the_backward(monkeypatch):
    """Under ``"full"`` each layer's ``transformer_block`` (and each CE
    chunk) runs once in the forward and once more in the backward; under
    ``"none"`` the backward runs none."""
    calls = {"block": 0}
    block = PL.transformer_block

    def counted(*a, **k):
        calls["block"] += 1
        return block(*a, **k)

    monkeypatch.setattr(PL, "transformer_block", counted)
    layers = p_load("smollm_360m", smoke=True).num_layers
    for remat, again in (("full", layers), ("none", 0)):
        calls["block"] = 0
        _, ran = _backward_counts(remat, calls)
        assert calls["block"] - ran["block"] == layers   # the forward
        assert ran["block"] == again, remat


def test_selective_remat_saves_what_it_names():
    """``"dots"`` keeps the unbatched products: its backward runs as many
    ``aten.mm`` as ``"none"``'s (``"full"`` runs them again).
    ``"tp_out"`` tags each layer's ``attn_out`` and ``mlp_out`` once in
    the forward and keeps them: its backward never recomputes a tag.  The
    other settings run no tag at all (the tag is a copy, paid only where
    it is read)."""
    mm = torch.ops.aten.mm.default
    tag = torch.ops.repro_torch.checkpoint_name.default
    fwd = {remat: {} for remat in REMATS}
    none, _ = _backward_counts("none", forward=fwd["none"])
    full, _ = _backward_counts("full", forward=fwd["full"])
    dots, _ = _backward_counts("dots", forward=fwd["dots"])
    tp, _ = _backward_counts("tp_out", forward=fwd["tp_out"])
    layers = p_load("smollm_360m", smoke=True).num_layers
    assert dots.get(mm, 0) == none.get(mm, 0) < full.get(mm, 0)
    assert fwd["tp_out"].get(tag, 0) == 2 * layers
    assert tp.get(tag, 0) == 0
    for remat, bwd in (("none", none), ("full", full), ("dots", dots)):
        assert fwd[remat].get(tag, 0) == bwd.get(tag, 0) == 0, remat
    assert tp.get(mm, 0) > none.get(mm, 0)   # the rest is recomputed


@pytest.mark.parametrize("chunk", [4, 8, 16, 32, 64])
def test_chunked_ce_loss_matches_the_reference(chunk):
    """The value and its gradients in ``h`` and the table, f32, with -1
    labels masked, at chunk sizes that divide S and one larger."""
    rng = np.random.default_rng(chunk)
    V, D = 96, 24
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    emb = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[:, ::5] = -1
    rcfg = r_load("smollm_360m", smoke=True)
    pcfg = p_load("smollm_360m", smoke=True)

    def r_fn(h, e):
        return RT.chunked_ce_loss(h, e, jnp.asarray(labels), rcfg, R_SINGLE,
                                  chunk=chunk)

    want, (gh_r, ge_r) = jax.value_and_grad(r_fn, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(emb))
    th = torch.from_numpy(h).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    got = PT.chunked_ce_loss(th, te, torch.from_numpy(labels), pcfg,
                             P_SINGLE, chunk=chunk)
    gh, ge = torch.autograd.grad(got, (th, te))
    assert abs(float(got) - float(want)) <= F32_LOSS_REL * abs(float(want))
    for g, w in ((gh, gh_r), (ge, ge_r)):
        w = np.asarray(w)
        assert float(np.max(np.abs(g.numpy() - w))) <= \
            F32_GRAD_REL * float(np.max(np.abs(w)))


def test_chunked_ce_loss_of_an_unlabelled_batch_is_zero():
    pcfg = p_load("smollm_360m", smoke=True)
    h = torch.ones(1, 8, 4)
    loss = PT.chunked_ce_loss(h, torch.ones(5, 4),
                              torch.full((1, 8), -1, dtype=torch.int32),
                              pcfg, P_SINGLE, chunk=4)
    assert float(loss) == 0.0
