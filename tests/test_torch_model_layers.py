"""The port's model layers and helpers against the reference's, on the
CPU: ``transformer_block``, ``mlp_block`` (both MLP kinds) and
``moe_block`` on one layer's carried weights, MoE routing with tokens
dropped past capacity, M-RoPE on three distinct position streams, the
analytic roofline counters, the parameter paths and the decode-state and
input specs of every config, ``init`` from a ``torch.Generator``, and what
the mesh path refuses (a plain tensor under an enabled ``MeshAxes``, a
mesh missing, a mesh without its ranks; the mesh itself is tested in
``test_torch_mesh_*.py``).  The whole-model comparisons are in ``test_torch_models.py``,
whose helpers and tolerances (stated there) these tests share.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as r_roof
from repro.configs.base import ARCH_IDS
from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import load_config as r_load
from repro.models import layers as RL
from repro.models import model as RMF
from repro.models import moe as RMOE
from repro.models.sharding import SINGLE as R_SINGLE
from repro_torch.analysis import roofline as p_roof
from repro_torch.configs.base import SHAPES as P_SHAPES
from repro_torch.configs.base import load_config as p_load
from repro_torch.models import layers as PL
from repro_torch.models import model as PMF
from repro_torch.models import moe as PMOE
from repro_torch.models import sharding as PSH
from repro_torch.models.carry import params_from_reference
from test_torch_models import (ARCHS, B, F32_TOL, S, _assert_close,
                               _assert_states, _batch, _configs, _pair,
                               _state_leaves)


def test_moe_drops_past_capacity_as_the_reference():
    """``_moe_local`` at a capacity factor that drops tokens: outputs and
    the (2,) auxiliary losses equal the reference's, and some token was
    dropped for some expert."""
    rcfg, pcfg = _configs("phi3_5_moe_42b", capacity_factor=0.5)
    rng = np.random.default_rng(3)
    T, D, E, F = 40, rcfg.d_model, rcfg.num_experts, rcfg.d_ff
    xf = rng.standard_normal((T, D)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.2
          for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    y_r, aux_r = jax.jit(lambda x, *w: RMOE._moe_local(
        x, *w, cfg=rcfg, model_axis=None, batch_axes=()))(
            jnp.asarray(xf), *map(jnp.asarray, ws))
    y_p, aux_p = PMOE._moe_local(torch.from_numpy(xf),
                                 *map(torch.from_numpy, ws), cfg=pcfg)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(aux_p.numpy(), np.asarray(aux_r),
                               rtol=F32_TOL)
    assert aux_p.shape == (2,)
    # some expert was routed more tokens than it accepts
    probs = torch.softmax(torch.from_numpy(xf) @ torch.from_numpy(ws[0]), -1)
    idx = torch.topk(probs, rcfg.experts_per_token, -1).indices
    routed = torch.bincount(idx.flatten(), minlength=E)
    assert int(routed.max()) > PMOE.capacity(pcfg, T) == \
        RMOE.capacity(rcfg, T)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_model_with_dropped_tokens_matches_the_reference(dtype):
    ref, params, port = _pair("phi3_5_moe_42b", dtype, capacity_factor=0.5)
    rb, pb = _batch(ref.cfg)
    r_logits, r_state = jax.jit(ref.prefill)(params, rb)
    p_logits, p_state = port.prefill(pb)
    _assert_close(p_logits, r_logits, dtype, "prefill logits")
    _assert_states(r_state, p_state, dtype, "prefill")


def test_mrope_angles_and_rotation_match_the_reference():
    """M-RoPE with three distinct position streams (Qwen2-VL's smoke
    sections (4, 2, 2)): each frequency is read from its stream."""
    rcfg, _ = _configs("qwen2_vl_2b")
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 50, (3, B, S)).astype(np.int32)
    sections = rcfg.mrope_sections
    want = RL.rope_angles(jnp.asarray(pos), rcfg.head_dim, rcfg.rope_theta,
                          sections)
    got = PL.rope_angles(torch.from_numpy(pos), rcfg.head_dim,
                         rcfg.rope_theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    # each section reads its own stream: not plain RoPE on any one stream
    for s in range(3):
        plain = PL.rope_angles(torch.from_numpy(pos[s]), rcfg.head_dim,
                               rcfg.rope_theta)
        assert not torch.allclose(got, plain)
    x = rng.standard_normal((B, S, rcfg.num_heads, rcfg.head_dim))
    x = x.astype(np.float32)
    np.testing.assert_allclose(
        PL.apply_rope(torch.from_numpy(x), got).numpy(),
        np.asarray(RL.apply_rope(jnp.asarray(x), want)), atol=1e-5)
    with pytest.raises(ValueError, match="M-RoPE"):
        PL.rope_angles(torch.from_numpy(pos[0]), rcfg.head_dim,
                       rcfg.rope_theta, sections)


@pytest.mark.parametrize("mlp_kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blocks_match_the_reference(mlp_kind, dtype):
    """``transformer_block`` (with a query-chunked attention), ``moe_block``
    and ``mlp_block`` in both MLP kinds (``jax.nn.gelu``'s tanh form) on one
    layer's carried weights."""
    ref, params, port = _pair("qwen3_8b", dtype, mlp_kind=mlp_kind,
                              attn_q_chunk=8)
    rcfg, pcfg = ref.cfg, port.cfg
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    xr, xp = jnp.asarray(x, rcfg.compute_dtype), torch.from_numpy(x).to(
        pcfg.compute_dtype)
    lr = jax.tree.map(lambda a: a[0], params["layers"])
    lp = PL.tree_unbind(port["layers"], port.cfg.num_layers)[0]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    ar = RL.rope_angles(jnp.asarray(pos), rcfg.head_dim, rcfg.rope_theta)
    ap = PL.rope_angles(torch.from_numpy(pos.copy()), pcfg.head_dim,
                        pcfg.rope_theta)
    block = jax.jit(lambda x, p, a: RL.transformer_block(x, p, rcfg,
                                                          R_SINGLE, a))
    _assert_close(PL.transformer_block(xp, lp, pcfg, PSH.SINGLE, ap),
                  block(xr, lr, ar), dtype, "transformer_block", state=True)
    mlp = jax.jit(lambda x, p: RL.mlp_block(x, p, rcfg, R_SINGLE))
    _assert_close(PL.mlp_block(xp, lp["mlp"], pcfg, PSH.SINGLE),
                  mlp(xr, lr["mlp"]), dtype, "mlp_block", state=True)
    m_ref, m_params, m_port = _pair("phi3_5_moe_42b", dtype,
                                    capacity_factor=0.5)
    mr = jax.tree.map(lambda a: a[0], m_params["layers"])
    mp = PL.tree_unbind(m_port["layers"], m_port.cfg.num_layers)[0]
    mcfg_r, mcfg_p = m_ref.cfg, m_port.cfg
    xm = x[..., :mcfg_r.d_model]
    ar = RL.rope_angles(jnp.asarray(pos), mcfg_r.head_dim, 1e4)
    ap = PL.rope_angles(torch.from_numpy(pos.copy()), mcfg_p.head_dim, 1e4)
    y_r, aux_r = jax.jit(lambda x, p, a: RMOE.moe_block(
        x, p, mcfg_r, R_SINGLE, a))(jnp.asarray(xm, mcfg_r.compute_dtype), mr,
                                    ar)
    y_p, aux_p = PMOE.moe_block(torch.from_numpy(xm.copy()).to(
        mcfg_p.compute_dtype), mp, mcfg_p, PSH.SINGLE, ap)
    _assert_close(y_p, y_r, dtype, "moe_block", state=True)
    # the router reads the normed bf16 activations, which differ by bf16
    # ulps in bf16 compute (see test_torch_models.py)
    np.testing.assert_allclose(aux_p.numpy(), np.asarray(aux_r),
                               rtol=F32_TOL if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_counters_equal_the_reference(arch):
    rcfg, pcfg = r_load(arch), p_load(arch)
    for name, shape in R_SHAPES.items():
        pshape = P_SHAPES[name]
        for fn in ("model_flops", "decode_state_bytes", "model_bytes"):
            assert getattr(p_roof, fn)(pcfg, pshape) == \
                getattr(r_roof, fn)(rcfg, shape), (fn, name)
        assert p_roof.attn_flops_forward(pcfg, 3, 1000) == \
            r_roof.attn_flops_forward(rcfg, 3, 1000)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_parameter_paths_equal_the_reference(arch):
    """Parameter paths and shapes, decode-state specs and input specs
    (``meta`` tensors) have the reference's shapes and dtypes."""
    rcfg, pcfg = r_load(arch), p_load(arch)
    ref, port = RMF.build_model(rcfg), PMF.build_model(pcfg, device="meta")
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    want = {"/".join(k.key for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {n.replace(".", "/"): tuple(p.shape)
           for n, p in port.named_parameters()}
    assert got == want
    assert all(p.dtype == torch.float32 and p.is_meta
               for p in port.parameters())
    r_specs = ref.decode_state_specs(3, 40)
    p_specs = port.decode_state_specs(3, 40)
    for path, want_leaf, got_leaf in _state_leaves(r_specs, p_specs):
        assert tuple(got_leaf.shape) == want_leaf.shape, path
        assert str(got_leaf.dtype).split(".")[-1] == \
            str(want_leaf.dtype), path
    for name, shape in R_SHAPES.items():
        r_in = RMF.input_specs(rcfg, shape)
        p_in = PMF.input_specs(pcfg, P_SHAPES[name])
        assert set(p_in) == set(r_in)
        for k in r_in:
            assert tuple(p_in[k].shape) == r_in[k].shape, (name, k)
            assert p_in[k].is_meta


def test_init_draws_from_the_generator():
    cfg = p_load("zamba2_2_7b", smoke=True)
    a = PMF.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    b = PMF.build_model(cfg, device="meta").init(
        torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(a.named_parameters(),
                                 b.named_parameters()):
        assert torch.equal(p, q), name
        assert p.device.type == "cpu" and p.dtype == cfg.param_dtype
    assert a["ssm_layers"]["wz"].shape[:2] == (2, cfg.attn_every)
    assert float(a["ssm_layers"]["dt_bias"].flatten()[0]) == -2.0


def test_what_waits_for_later_slices_raises():
    """Nothing of the mesh path waits for a later slice any more; what
    raises now is its misuse: a plain tensor under an enabled
    ``MeshAxes`` (it escaped the mesh), an enabled ``MeshAxes`` without
    its mesh, the int8 sum outside a mesh, a mesh without its ranks."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import compression as PCOMP
    sharded = PSH.MeshAxes(batch=("data",), model="model", enabled=True)
    with pytest.raises(TypeError, match="DTensor"):
        PSH.sc(torch.zeros(2), sharded, "batch")
    _, pcfg = _configs("phi3_5_moe_42b")
    moe = PL.ParamTree(PMOE.moe_params(torch.Generator().manual_seed(0),
                                       pcfg))
    with pytest.raises(TypeError, match="DTensor"):
        PMOE.moe_ffn(torch.zeros(1, 2, pcfg.d_model), moe, pcfg, sharded)
    with pytest.raises(ValueError, match="mesh"):
        PMF.build_model(p_load("minitron_8b", smoke=True), sharded,
                        device="meta")
    with pytest.raises(RuntimeError, match="no current mesh"):
        PCOMP.psum_int8(torch.ones(3), "pod")
    with pytest.raises(RuntimeError, match="no current mesh"):
        PCOMP.compressed_psum_tree({"g": torch.ones(3)}, "pod")
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(2, 2, device_type="cpu")
    x = torch.ones(3)
    assert PSH.sc(x, PSH.SINGLE, "batch") is x


def test_build_model_and_carry_default_to_the_card():
    """Both place the parameters on ``cuda`` unless asked for another
    device, and raise where there is no card."""
    cfg = p_load("smollm_360m", smoke=True)
    ref = RMF.build_model(r_load("smollm_360m", smoke=True))
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    if torch.cuda.is_available():
        assert PMF.build_model(cfg).device.type == "cuda"
        assert params_from_reference(cfg, tree).device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        PMF.build_model(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        params_from_reference(cfg, tree)


def test_carry_rejects_a_tree_that_is_not_the_model():
    cfg = p_load("smollm_360m", smoke=True)
    ref = RMF.build_model(r_load("smollm_360m", smoke=True))
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    bad = dict(tree, layers=dict(tree["layers"], extra=np.zeros(3)))
    with pytest.raises(RuntimeError, match="extra"):
        params_from_reference(cfg, bad, device="cpu")
    bad = dict(tree, ln_f=tree["ln_f"][:-1])
    with pytest.raises(RuntimeError, match="size mismatch"):
        params_from_reference(cfg, bad, device="cpu")
    bad = dict(tree, ln_f=tree["ln_f"].astype(np.float64))
    with pytest.raises(ValueError, match="dtype"):
        params_from_reference(cfg, bad, device="cpu")
