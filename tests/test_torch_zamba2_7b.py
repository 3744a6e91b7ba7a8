"""The released Zamba2 layout (``configs/zamba2_7b.py``,
``models/transformer.py:Zamba2LM``) on the CPU, at ``SMOKE_CONFIG`` on the
benchmark's seeded weights, against the plain reference
``bench/reference/hybrid.py``.

* The published config: its widths, the 13 applications that
  ``bench/counts.py`` reads from ``attn_every``, 7.36B parameters; the
  benchmark's file differs from the module only in the cut it names.
* In float32 the program and the reference are the same mathematics: the
  loss to 1e-5 of itself and every leaf's gradient to 1e-4 of its norm
  (the shared blocks' included, summed over their applications), the
  prefill logits and every state leaf (``ssm``, ``conv``, each
  application's k and v) to 1e-5, and four decode steps after a prefill
  to 1e-5 of the reference's full forward over the longer sequence.  The
  bounds are float32 sums taken in other orders (measured: the loss equal,
  the gradients <= 8.7e-6, the rest <= 2.8e-6 at these sizes).
* ``make_train_step``, ``make_prefill`` and ``make_serve_step`` run it in
  the configured bfloat16; the Mamba2 block with the new options off is
  bit for bit the block before them; the spans and the counter appear
  only with the tracer on.

Imports no jax."""
import json

import pytest
import torch

from bench import counts, smoke

smoke.program_path()

from bench import harness  # noqa: E402
from bench.reference import common as C  # noqa: E402
from bench.reference import hybrid as R  # noqa: E402
from repro_torch.configs.base import Zamba2Config, load_config  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.sharding import SINGLE  # noqa: E402
from repro_torch.models.transformer import Zamba2LM  # noqa: E402
from repro_torch.obs import tracer as obs  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.serve import make_prefill, make_serve_step  # noqa: E402
from repro_torch.train.train_loop import make_train_step  # noqa: E402

CFG_FILE = json.loads((smoke.ROOT / "bench/configs/zamba2-7b.json")
                      .read_text())
SEED = 2**31 + 7


def _program(dtype=torch.float32, seed=SEED):
    cfg_json = smoke.config("zamba2-7b")
    cfg = load_config("zamba2_7b", smoke=True).replace(compute_dtype=dtype)
    w = C.make_weights(R.leaf_specs(cfg_json), seed, "cpu")
    model = build_model(cfg, device="meta")
    model.load_state_dict(w, strict=True, assign=True)
    return model, cfg_json, w


def _tokens(B, S, seed=1):
    return torch.randint(0, 512, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return float((a.float() - b).norm() / b.norm())


def test_published_config_and_its_applications():
    cfg = load_config("zamba2-7b")
    assert isinstance(cfg, Zamba2Config) and cfg.family == "hybrid"
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (81, 3584, 32, 224, 14336, 32000)
    assert cfg.q_dim == 2 * cfg.d_model == 7168
    assert (cfg.ssm_groups, cfg.ssm_state, cfg.ssm_headdim,
            cfg.ssm_heads) == (2, 64, 64, 112)
    assert cfg.attn_scale == 112 ** -0.5
    # bench/counts.py counts num_layers // attn_every applications
    assert cfg.num_layers // cfg.attn_every == len(cfg.hybrid_layer_ids) \
        == 13
    cut = CFG_FILE["config"]
    assert cut["num_layers"] // cut["attn_every"] == \
        len(cut["hybrid_layer_ids"]) == 4
    terms = counts.forward_terms(cut, 1, 1, head_rows=1)
    assert terms["shared_proj"] == 4 * (counts.attn_proj_flops(cut, 1, 1)
                                        + counts.mlp_flops(cut, 1, 1))
    model = build_model(cfg, device="meta")
    assert isinstance(model, Zamba2LM)
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() == 7_356_749_648
    assert build_model(load_config("zamba2_2_7b"),
                       device="meta").__class__.__name__ == "HybridLM"


def test_benchmark_file_differs_only_in_its_cut():
    cfg = harness.program_config(CFG_FILE)
    full = load_config("zamba2_7b")
    assert cfg.num_layers == 24 and cfg.hybrid_layer_ids == [6, 11, 17, 23]
    assert cfg.replace(num_layers=81,
                       hybrid_layer_ids=full.hybrid_layer_ids) == full
    assert cfg.param_count() == 2_733_050_240
    # the published values compare equal, lists and all: no cut, nothing
    # to name in reduced
    published = {**CFG_FILE["config"], "num_layers": 81,
                 "hybrid_layer_ids": CFG_FILE["hybrid_layer_ids"]
                 + [29, 35, 41, 47, 53, 59, 65, 71, 77]}
    assert harness.program_config({**CFG_FILE, "config": published,
                                   "reduced": []}) == full
    with pytest.raises(harness.RunError, match="hybrid_layer_ids"):
        harness.program_config({**CFG_FILE, "reduced": ["num_layers"]})


@pytest.mark.parametrize("B,S", [(2, 32), (1, 40)])
def test_loss_and_every_gradient_equal_the_reference_in_float32(B, S):
    model, cfg, w = _program()
    model.requires_grad_(True)
    toks, lbl = _tokens(B, S), _tokens(B, S, seed=2)
    loss, _ = model.loss({"tokens": toks, "labels": lbl})
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    ref_w = {k: v.detach().clone().requires_grad_(True)
             for k, v in w.items()}
    r_loss = R.loss_sum(C.nest(ref_w), toks, lbl, cfg) / toks.numel()
    r_loss.backward()
    assert abs(float(loss.detach()) / float(r_loss.detach()) - 1) < 1e-5
    assert set(names) == set(ref_w)
    for n, gp in zip(names, grads):
        assert _rel(gp, ref_w[n].grad) < 1e-4, n


def test_prefill_logits_and_every_state_leaf_equal_the_reference():
    model, cfg, w = _program()
    toks = _tokens(2, 40)
    logits, state = make_prefill(model)({"tokens": toks}, pad_to=48)
    r_logits, r_state = R.prefill(C.nest(w), toks, cfg, pad_to=48)
    assert _rel(logits, r_logits) < 1e-5
    leaves = {"ssm": (state["ssm"], r_state["ssm"]),
              "conv": (state["conv"], r_state["conv"]),
              "k": (state["kv"]["k"], r_state["kv"]["k"]),
              "v": (state["kv"]["v"], r_state["kv"]["v"])}
    assert tuple(state["kv"]["k"].shape) == (4, 2, 48, 4, 32)
    for key, (p, r) in leaves.items():
        assert p.shape == r.shape, key
        for i in range(p.shape[0]):    # each layer, each application
            assert _rel(p[i], r[i]) < 1e-5, (key, i)
    assert int(state["pos"]) == 40


def test_decode_after_prefill_equals_the_full_forward():
    model, cfg, w = _program()
    toks = _tokens(2, 36)
    S = 32
    _, state = make_prefill(model)({"tokens": toks[:, :S]}, pad_to=S + 4)
    step = make_serve_step(model)
    ref = C.logits(R.hidden(C.nest(w), toks, cfg), C.nest(w), cfg,
                   C.EXACT)
    for t in range(4):
        _, logits, state = step(state, toks[:, S + t])
        assert _rel(logits, ref[:, S + t]) < 1e-5, t


def test_entry_points_run_in_bfloat16():
    model, cfg, _ = _program(torch.bfloat16)
    opt = adamw.AdamWConfig()
    step = make_train_step(model, opt, 2)
    state = adamw.init_state(model)
    before = model["apps"]["lora_b"].detach().clone()
    toks = _tokens(4, 32)
    _, state, met = step(model, state, {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(met["loss"]))
    assert not torch.equal(before, model["apps"]["lora_b"])
    model.requires_grad_(False)
    with torch.no_grad():
        logits, st = make_prefill(model)({"tokens": toks[:, :24]},
                                         pad_to=28)
        nxt, logits, st = make_serve_step(model)(st, toks[:, 24])
    assert bool(torch.isfinite(logits).all()) and nxt.shape == (4,)
    assert int(st["pos"]) == 25


def _parent_mamba_block(x, p, cfg, axes, layer=None):
    """``models/mamba.py:mamba_block`` as it was before the released
    Zamba2's options, op for op on the CPU without a mesh (its ``sc``
    calls are identities there, its spans record nothing, its route is
    the plain scan)."""
    F = torch.nn.functional
    B_, S, _ = x.shape
    cd = cfg.compute_dtype
    f32 = torch.float32
    g, n, hh, pp, w = (cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_headdim, cfg.ssm_conv)
    res = x
    x = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xin, Bp, Cp, dt_raw = M._project(x, p, cfg, axes)
    xbc = torch.cat([xin, Bp, Cp], dim=-1)
    conv_state = xbc[:, S - (w - 1):, :] if S >= w else None
    xbc = F.silu(M.causal_conv1d(xbc, p["conv"].to(cd)))
    di = cfg.d_inner
    xin = xbc[..., :di].reshape(B_, S, hh, pp)
    Bm = xbc[..., di:di + g * n].reshape(B_, S, g, n)
    Cm = xbc[..., di + g * n:].reshape(B_, S, g, n)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    ops = (xin.to(f32), dt, A, Bm.to(f32), Cm.to(f32))
    y, ssm_state = M.ssd_chunked_sharded(*ops, cfg.ssm_chunk, axes)
    y = y.to(f32) + (p["D"].to(f32)[:, None] * xin.to(f32))
    y = y.to(cd).reshape(B_, S, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out"].to(cd)
    return res + out, (ssm_state.to(cd), conv_state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_block_with_the_options_off_is_bit_identical(dtype):
    cfg = load_config("mamba2_2_7b", smoke=True).replace(compute_dtype=dtype)
    gen = torch.Generator().manual_seed(4)
    p = {k: v.requires_grad_(True)
         for k, v in M.mamba_params(gen, cfg).items()}
    x = torch.randn((2, 24, cfg.d_model), generator=gen).to(dtype)
    outs = []
    for fn in (M.mamba_block, _parent_mamba_block):
        y, (ssm, conv) = fn(x, p, cfg, SINGLE)
        grads = torch.autograd.grad(y.float().square().sum(), list(p.values()))
        outs.append((y, ssm, conv, grads))
    (y0, s0, c0, g0), (y1, s1, c1, g1) = outs
    assert torch.equal(y0, y1) and torch.equal(s0, s1) and torch.equal(c0, c1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_spans_and_the_scores_counter_only_with_the_tracer_on():
    model, _, _ = _program()
    toks = _tokens(2, 24)
    prev = obs.set_tracer(obs.Tracer(enabled=False))
    try:
        model.prefill({"tokens": toks})
        assert obs.get_tracer().events() == []
        tr = obs.Tracer(enabled=True)
        obs.set_tracer(tr)
        model.prefill({"tokens": toks})
        shared = [e for e in tr.events() if e["name"] == "hybrid.shared"]
        core = [e for e in tr.events() if e["name"] == "attn.core"]
        scores = [e for e in tr.events() if e["name"] == "attn.scores"]
        tr.clear()
        model.requires_grad_(True)
        loss, _ = model.loss({"tokens": toks, "labels": toks})
        loss.backward()
        trained = [e for e in tr.events() if e["name"] == "hybrid.shared"]
    finally:
        obs.set_tracer(prev)
    cfg = model.cfg
    assert [e["args"]["layer"] for e in shared] == cfg.hybrid_layer_ids
    assert [e["args"]["block"] for e in shared] == [0, 1, 0, 1]
    assert {e["args"]["tokens"] for e in shared} == {2 * 24}
    assert len(core) == 4
    # each core lies inside its application's span
    for c, s in zip(core, shared):
        assert s["t0"] <= c["t0"] and c["t0"] + c["dur"] <= s["t0"] + s["dur"]
    assert [e["args"]["value"] for e in scores] == [2 * 4 * 24 * 24] * 4
    # full remat: each application again in the backward
    assert len(trained) == 2 * 4
