"""The port's model substrate (``repro_torch.models``, ``train/serve.py``,
``analysis/roofline.py``) against the reference's, on the CPU.

Weights are the reference's: ``model.init(PRNGKey)`` in JAX, carried
across by ``models/carry.py`` (``jax.random`` and ``torch.Generator`` draw
different numbers, so two inits are never compared).  Inputs are made with
numpy from fixed seeds.  Every config runs at its smoke config
(``ARCH_IDS``, the encoder-decoder ``whisper_medium`` on random audio
frames beside its tokens): prefill logits and state, then three
decode steps fed the same tokens on both sides; decoding past the cache;
greedy ``generate`` ids against the reference's ``generate``.  Port-only
properties: both ``decode_loop`` settings give the same values, a decode
step continues a prefill as a prefill one token longer does, and
categorical sampling follows its ``torch.Generator``.  Layer-level
comparisons are in ``test_torch_model_layers.py``.

Tolerances, as max absolute differences:

* f32 compute: ``F32_TOL`` (1e-5) on logits and every state leaf.  The two
  packages run the same ops in the same order; what is left is the
  summation order of the CPU matmul kernels (measured: under 8e-7 on
  logits of scale ~0.5, under 4e-6 on the KV caches).
* bf16 compute: ``BF16_LOGIT_TOL`` (3e-2, ~5% of the logits' scale) and
  ``BF16_STATE_REL`` (5% of the leaf's largest magnitude) on the state.
  XLA keeps fused bf16 elementwise chains in f32 (excess precision) where
  PyTorch rounds every op, so the two differ by a few bf16 ulps a layer
  (measured: up to 1.2e-2 on logits, 2.5% of a KV leaf's scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import load_config as r_load
from repro.models import model as RMF
from repro.train import serve as r_serve
from repro_torch.configs.base import load_config as p_load
from repro_torch.models.carry import params_from_reference
from repro_torch.train import serve as p_serve

ARCHS = list(ARCH_IDS)
FAMILY_ARCHS = ["smollm_360m", "qwen2_vl_2b", "phi3_5_moe_42b",
                "mamba2_2_7b", "zamba2_2_7b", "whisper_medium"]
B, S = 2, 24          # 24 positions: two SSD chunks of 16, the second padded
PAD = 4               # decode headroom past the prefill
F32_TOL = 1e-5
BF16_LOGIT_TOL = 3e-2
BF16_STATE_REL = 0.05
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _configs(arch, dtype="f32", **kw):
    jd, td = DTYPES[dtype]
    return (r_load(arch, smoke=True).replace(compute_dtype=jd, **kw),
            p_load(arch, smoke=True).replace(compute_dtype=td, **kw))


def _pair(arch, dtype="f32", seed=0, **kw):
    """The reference model and its params, and the port's model on the
    same (carried) weights."""
    rcfg, pcfg = _configs(arch, dtype, **kw)
    ref = RMF.build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(seed))
    port = params_from_reference(pcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return ref, params, port


def _batch(cfg, seed=1, seq=S):
    """The same prefill batch for both packages: (reference, port)."""
    rng = np.random.default_rng(seed)
    n_text = seq - (cfg.num_patch_tokens if cfg.family == "vlm" else 0)
    toks = rng.integers(0, cfg.vocab_size, (B, n_text)).astype(np.int32)
    rb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        pe = (rng.standard_normal((B, cfg.num_patch_tokens, cfg.d_model))
              * 0.5).astype(np.float32)
        rb["patch_embeds"] = jnp.asarray(pe)
        pb["patch_embeds"] = torch.from_numpy(pe)
    if cfg.family == "encdec":
        af = (rng.standard_normal((B, cfg.num_audio_frames, cfg.d_model))
              * 0.5).astype(np.float32)
        rb["audio_frames"] = jnp.asarray(af)
        pb["audio_frames"] = torch.from_numpy(af)
    return rb, pb


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _state_leaves(ref_state, port_state):
    """(path, reference leaf, port leaf) for every leaf of the state."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_state):
        t = port_state
        for k in path:
            t = t[k.key if hasattr(k, "key") else k.idx]
        yield "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path), leaf, t


def _assert_close(got, want, dtype, what, state=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "f32":
        tol = F32_TOL
    elif state:
        tol = BF16_STATE_REL * max(float(np.max(np.abs(want))), 1e-6)
    else:
        tol = BF16_LOGIT_TOL
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol, f"{what}: max |port - reference| {err:.3g} > {tol:.3g}"


def _assert_states(ref_state, port_state, dtype, when):
    n = 0
    for path, want, got in _state_leaves(ref_state, port_state):
        if path == "pos":
            assert int(got) == int(want), (when, int(got), int(want))
            assert got.dtype == torch.int32 and got.dim() == 0
        else:
            _assert_close(got, want, dtype, f"{when} state {path}",
                          state=True)
        n += 1
    assert n == len(jax.tree.leaves(ref_state)) > 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, dtype):
    ref, params, port = _pair(arch, dtype)
    rb, pb = _batch(ref.cfg)
    r_logits, r_state = jax.jit(
        lambda p, b: ref.prefill(p, b, pad_to=S + PAD))(params, rb)
    p_logits, p_state = port.prefill(pb, pad_to=S + PAD)
    assert p_logits.dtype == torch.float32
    _assert_close(p_logits, r_logits, dtype, "prefill logits")
    _assert_states(r_state, p_state, dtype, "prefill")
    step = jax.jit(ref.decode_step)
    for i in range(3):
        tok = np.argmax(np.asarray(r_logits), -1).astype(np.int32)
        r_logits, r_state = step(params, r_state, jnp.asarray(tok))
        p_logits, p_state = port.decode_step(p_state, torch.from_numpy(tok))
        _assert_close(p_logits, r_logits, dtype, f"decode {i} logits")
    _assert_states(r_state, p_state, dtype, "decode")


def test_decode_past_the_cache_writes_its_last_row():
    """Decoding past ``pad_to`` writes at ``min(pos, Smax - 1)`` in both
    packages (no padding: the first step already overflows)."""
    ref, params, port = _pair("minitron_8b")
    rb, pb = _batch(ref.cfg, seq=8)
    r_logits, r_state = jax.jit(ref.prefill)(params, rb)
    p_logits, p_state = port.prefill(pb)
    step = jax.jit(ref.decode_step)
    for i in range(2):
        tok = np.argmax(np.asarray(r_logits), -1).astype(np.int32)
        r_logits, r_state = step(params, r_state, jnp.asarray(tok))
        p_logits, p_state = port.decode_step(p_state, torch.from_numpy(tok))
        _assert_close(p_logits, r_logits, "f32", f"decode {i} logits")
    _assert_states(r_state, p_state, "f32", "decode")


@pytest.mark.parametrize("arch", ["minitron_8b", "phi3_5_moe_42b",
                                  "zamba2_2_7b"])
def test_decode_loops_fori_and_scan_give_the_same_values(arch):
    """``decode_loop="fori"`` equals ``"scan"``, and a decode step leaves
    the state it was given untouched (it writes into one copy of the
    cache)."""
    _, _, port = _pair(arch)
    _, pb = _batch(port.cfg)
    logits, state = port.prefill(pb, pad_to=S + PAD)
    before = {k: v.clone() for k, v in state["kv"].items()}
    tok = torch.argmax(logits, -1).to(torch.int32)
    want, want_state = port.decode_step(state, tok)
    port.cfg = port.cfg.replace(decode_loop="fori")
    got, got_state = port.decode_step(state, tok)
    assert torch.equal(got, want)
    for k in ("k", "v"):
        assert torch.equal(got_state["kv"][k], want_state["kv"][k])
        assert torch.equal(state["kv"][k], before[k])


@pytest.mark.parametrize("arch", ["minitron_8b", "phi3_5_moe_42b",
                                  "mamba2_2_7b", "zamba2_2_7b",
                                  "qwen2_vl_2b"])
def test_prefill_decode_consistency(arch):
    """prefill(S-1) + decode(1) logits equal the last logits of prefill(S)
    (the reference's consistency property, f32 compute; MoE with a
    dropless capacity factor, as the reference's test has it)."""
    _, _, port = _pair(arch, capacity_factor=8.0)
    _, pb = _batch(port.cfg, seq=16)
    short = {k: v[:, :-1] if k == "tokens" else v for k, v in pb.items()}
    _, state = port.prefill(short, pad_to=16)
    got, _ = port.decode_step(state, pb["tokens"][:, -1])
    want, _ = port.prefill(pb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_generate_greedy_ids_match_the_reference(arch):
    steps = 5
    ref, params, port = _pair(arch)
    rb, pb = _batch(ref.cfg, seq=16)
    want = r_serve.generate(ref, params, rb, steps)
    got = p_serve.generate(port, pb, steps)
    assert got.dtype == torch.int32 and got.shape == (B, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_step_samples_from_its_generator():
    _, _, port = _pair("smollm_360m")
    _, pb = _batch(port.cfg, seq=8)
    logits, state = p_serve.make_prefill(port)(pb, pad_to=12)
    tok = torch.argmax(logits, -1).to(torch.int32)
    greedy = p_serve.make_serve_step(port)
    nxt, lg, _ = greedy(state, tok)
    assert torch.equal(nxt, torch.argmax(lg, -1).to(torch.int32))
    sample = p_serve.make_serve_step(port, "categorical", temperature=2.0)
    draws = [sample(state, tok, torch.Generator().manual_seed(11))[0]
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert draws[0].dtype == torch.int32 and draws[0].shape == (B,)
