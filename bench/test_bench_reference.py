"""The plain references against the program at the configurations'
``SMOKE_CONFIG`` sizes on the CPU: in float32 the two are the same
mathematics (prefill logits and decode state, the loss and every
gradient); in the configured bfloat16 the program stays within the
comparison's limits, and the lower-precision control fails them."""
import pytest
import torch

from bench import smoke

smoke.program_path()

from bench import control  # noqa: E402
from bench.reference import common as C  # noqa: E402
from bench.reference import ssm  # noqa: E402

FAMILIES = {"mamba2-2.7b": ssm}


def _program(name: str, dtype):
    from repro_torch.models.model import build_model
    from bench import harness
    cfg_json = smoke.config(name)
    cfg = harness.program_config({"module": "mamba2_2_7b",
                                  "config": cfg_json,
                                  "reduced": list(cfg_json)})
    cfg = cfg.replace(compute_dtype=dtype)
    weights = C.make_weights(FAMILIES[name].leaf_specs(cfg_json), 5, "cpu")
    model = build_model(cfg, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    return model, cfg_json, weights


def _rel(a, b):
    return float((a.float() - b).norm() / b.norm())


@pytest.mark.parametrize("name", sorted(FAMILIES))
@pytest.mark.parametrize("B,S", [(2, 40), (1, 64)])
def test_prefill_equals_reference_in_float32(name, B, S):
    model, cfg, w = _program(name, torch.float32)
    toks = torch.randint(0, cfg["vocab_size"], (B, S),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    logits, state = model.prefill({"tokens": toks}, pad_to=S + 8)
    r_logits, r_state = FAMILIES[name].prefill(C.nest(w), toks, cfg,
                                               pad_to=S + 8)
    assert _rel(logits, r_logits) < 1e-5
    flat = {"ssm": (state["ssm"], r_state["ssm"]),
            "conv": (state["conv"], r_state["conv"])}
    for key, (p, r) in flat.items():
        assert p.shape == r.shape, key
        assert _rel(p, r) < 1e-5, key


@pytest.mark.parametrize("name", sorted(FAMILIES))
@pytest.mark.parametrize("B,S", [(2, 32), (1, 72)])
def test_loss_and_gradients_equal_reference_in_float32(name, B, S):
    model, cfg, w = _program(name, torch.float32)
    model.requires_grad_(True)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg["vocab_size"], (B, S), generator=g,
                         dtype=torch.int32)
    lbl = torch.randint(0, cfg["vocab_size"], (B, S), generator=g,
                        dtype=torch.int32)
    loss, _ = model.loss({"tokens": toks, "labels": lbl})
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    ref_w = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    r_loss = FAMILIES[name].loss_sum(C.nest(ref_w), toks, lbl, cfg) / toks.numel()
    r_loss.backward()
    assert abs(float(loss.detach()) - float(r_loss.detach())) < 1e-5 * abs(
        float(r_loss.detach()))
    for n, gp in zip(names, grads):
        gr = ref_w[n].grad
        assert _rel(gp, gr) < 1e-4, n


@pytest.mark.parametrize("workload", ["mamba2-2.7b.prefill_4k",
                                      "mamba2-2.7b.train_4k"])
def test_program_within_limits_and_control_outside(workload):
    """The program (bfloat16; for the training cell make_train_step's
    check steps and late step) within every small-size limit; the control,
    and for training half of each batch left out, past at least one."""
    kind = "train" if "train" in workload else "prefill"
    sides = ["program", "control"] + (["half"] if kind == "train" else [])
    limits = smoke.LIMITS[kind]
    conf = workload.split(".prefill")[0].split(".train")[0]
    r = control.readings(workload, 2**31 + 11, sides, device="cpu",
                         config_override=smoke.config(conf),
                         traffic_override=smoke.TRAFFIC[kind])
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    for side in sides[1:]:
        assert any(r[side][k] > v for k, v in limits.items()), (side, r)


def test_lowered_rounds_to_fp8_and_bfloat16():
    x = torch.linspace(-3, 3, 1001)
    lo = C.Lowered()
    fp8 = lo.gemm(x)
    assert 0 < float((fp8 - x).abs().max()) <= 3 / 16 + 1e-6
    assert float((lo.scan(x) - x).abs().max()) <= 3 / 256 + 1e-6
    assert torch.equal(C.EXACT.gemm(x), x)


def test_ssd_matches_sequential_recurrence():
    g = torch.Generator().manual_seed(3)
    b, s, h, p, n = 2, 37, 4, 8, 6
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g) * 0.3
    A = -torch.rand(h, generator=g) * 4
    B = torch.randn(b, s, 1, n, generator=g)
    Cm = torch.randn(b, s, 1, n, generator=g)
    y, final = C.ssd(x, dt, A, B, Cm, 16, C.EXACT)
    st = torch.zeros(b, h, p, n)
    for t in range(s):
        st = (st * torch.exp(dt[:, t] * A)[..., None, None]
              + (x[:, t] * dt[:, t, :, None])[..., None] * B[:, t, :, None])
        yt = torch.einsum("bhpn,bn->bhp", st, Cm[:, t, 0])
        assert torch.allclose(y[:, t], yt, atol=1e-4, rtol=1e-4)
    assert torch.allclose(final, st, atol=1e-4, rtol=1e-4)


def test_weights_are_a_function_of_the_seed():
    specs = ssm.leaf_specs(smoke.config("mamba2-2.7b"))
    a = C.make_weights(specs, 2**31 + 5, "cpu")
    b = C.make_weights(specs, 2**31 + 5, "cpu")
    c = C.make_weights(specs, 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in specs)
    assert not torch.equal(a["layers.wz"], c["layers.wz"])
    assert torch.equal(C.make_leaf(specs, "layers.out", 2**31 + 5, "cpu"),
                       a["layers.out"])
    assert bool((torch.exp(a["layers.A_log"]) >= 1).all())
