"""The released Zamba2's plain reference (``reference/hybrid.py``) on the
CPU at ``configs/zamba2_7b.py``'s ``SMOKE_CONFIG`` sizes.

* It imports nothing of the program, of JAX or of the JAX package.
* Each part of the mechanism counts: with one of them dropped (an
  application's adapter, an application's linear, block 1 with block 0 run
  in its place, the embedding half of the shared block's input, the
  grouped gated norm, the 112^-0.5 scale, the injection point), the loss
  moves by more than the 1e-5 of itself that the program's float32 loss
  is held to, and the logits of every position by more than a hundred
  times the 1e-5 that its logits are held to
  (``tests/test_torch_zamba2_7b.py``).  So a program that left one out
  could not pass as the reference.  (The embedding half moves the loss
  least: the embedding's rows, drawn at 0.02, are a small part of
  ``[h ; e]``; its logits move 3.5-5.6% on three seeds.)
* The ``Lowered`` control of the reference moves the loss far more than
  the program's float32 path does.
* The cell's check at these sizes (``bench/control.py``'s readings, the
  configured bfloat16 through ``make_train_step``): the program within
  ``LIMITS``, the control and the half batch each past one of them."""
import ast

import pytest
import torch

from bench import smoke

smoke.program_path()

from bench.reference import common as C  # noqa: E402
from bench.reference import hybrid as R  # noqa: E402

SEED = 2**31 + 19
TOL = 1e-5
# program / control / half batch over 10 seeds at these sizes, the
# program's largest and the others' smallest reading: loss_gap 2.2e-4 /
# 2.3e-4 / 1.3e-3, grad_gap 0.091 / 0.083 / 0.079 (no limit between
# them: a loose one), change_gap 6.4e-3 / 9.8e-3 / 9.1e-3, late_loss_gap
# 9.9e-5 / 9.4e-5 / 3.1e-4, late_change_gap 3.7e-3 / 7.0e-3 / 9.0e-3
LIMITS = {"loss_gap": 6e-4, "grad_gap": 0.15, "change_gap": 8e-3,
          "late_loss_gap": 2.5e-4, "late_change_gap": 5.5e-3}


def _setup():
    cfg = smoke.config("zamba2-7b")
    w = C.nest(C.make_weights(R.leaf_specs(cfg), SEED, "cpu"))
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg["vocab_size"], (2, 40), generator=g,
                         dtype=torch.int32)
    lbl = torch.randint(0, cfg["vocab_size"], (2, 40), generator=g,
                        dtype=torch.int32)
    return cfg, w, toks, lbl


def _loss(cfg, w, toks, lbl):
    with torch.no_grad():
        return float(R.loss_sum(w, toks, lbl, cfg)) / toks.numel()


def _logits(cfg, w, toks):
    with torch.no_grad():
        return C.logits(R.hidden(w, toks, cfg), w, cfg, C.EXACT)


def test_imports_nothing_of_the_program():
    tree = ast.parse((smoke.ROOT / "bench/reference/hybrid.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "torch", "bench"}, names


def _drop_adapter(cfg, w):
    w["apps"]["lora_a"][2] = 0.0


def _drop_linear(cfg, w):
    w["apps"]["linear"][1] = torch.eye(cfg["d_model"])


def _block0_for_block1(cfg, w):
    def copy(tree):
        for v in tree.values():
            if isinstance(v, dict):
                copy(v)
            else:
                v[1] = v[0]
    copy(w["shared"])


def _drop_embedding_half(cfg, w, monkeypatch):
    orig = R.shared_block
    monkeypatch.setattr(R, "shared_block", lambda h, e, *a: orig(
        h, torch.zeros_like(e), *a))


def _ungrouped_norm(cfg, w, monkeypatch):
    orig = R.gated_norm
    monkeypatch.setattr(R, "gated_norm", lambda y, zg, wt, groups, eps:
                        orig(y, zg, wt, 1, eps))


def _head_dim_scale(cfg, w, monkeypatch):
    orig = R.attention
    monkeypatch.setattr(R, "attention", lambda q, k, v, scale, pr: orig(
        q, k, v, q.shape[-1] ** -0.5, pr))


def _inject_into_the_residual(cfg, w, monkeypatch):
    orig = R.mamba_layer
    monkeypatch.setattr(R, "mamba_layer", lambda x, p, c, pr, inject=None,
                        **kw: orig(x if inject is None else x + inject, p, c,
                                   pr, None, **kw))


ABLATIONS = {"adapter": _drop_adapter, "linear": _drop_linear,
             "block_1": _block0_for_block1,
             "embedding_half": _drop_embedding_half,
             "grouped_norm": _ungrouped_norm, "scale": _head_dim_scale,
             "injection_point": _inject_into_the_residual}


@pytest.mark.parametrize("name", sorted(ABLATIONS))
def test_each_part_moves_the_loss_past_the_tolerance(name, monkeypatch):
    cfg, w, toks, lbl = _setup()
    full, logits = _loss(cfg, w, toks, lbl), _logits(cfg, w, toks)
    fn = ABLATIONS[name]
    if fn.__code__.co_argcount == 3:
        fn(cfg, w, monkeypatch)
    else:
        fn(cfg, w)
    assert abs(_loss(cfg, w, toks, lbl) / full - 1) > TOL, name
    moved = _logits(cfg, w, toks) - logits
    assert float(moved.norm() / logits.norm()) > 100 * TOL, name


def test_lowered_control_moves_the_loss():
    cfg, w, toks, lbl = _setup()
    with torch.no_grad():
        exact = float(R.loss_sum(w, toks, lbl, cfg))
        low = float(R.loss_sum(w, toks, lbl, cfg, C.Lowered()))
    assert abs(low / exact - 1) > 100 * TOL


def test_program_within_limits_and_control_outside():
    from bench import control
    sides = ["program", "control", "half"]
    r = control.readings("zamba2-7b.train_4k", 2**31 + 11, sides,
                         device="cpu", config_override=smoke.config(
                             "zamba2-7b"),
                         traffic_override=smoke.TRAFFIC["train"])
    assert all(r["program"][k] <= v for k, v in LIMITS.items()), r
    for side in sides[1:]:
        assert any(r[side][k] > v for k, v in LIMITS.items()), (side, r)
