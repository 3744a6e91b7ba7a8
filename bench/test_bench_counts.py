"""``bench/counts.py`` against ``torch.utils.flop_counter.FlopCounterMode``
on the program's plain forward at the ``SMOKE_CONFIG`` sizes of the repo's
Mamba2 and hybrid configs: the weight products (the hybrid's shared block
at each application), attention and the SSD's einsums.  The program
computes the masked attention square and C·Bᵀ on every head, so those two
terms are counted as executed here."""
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import counts, smoke

smoke.program_path()

MODULES = ["mamba2_2_7b", "zamba2_2_7b"]
KEYS = json.loads((smoke.ROOT / "bench/configs/mamba2-2.7b.json")
                  .read_text())["config"]


@pytest.mark.parametrize("module", MODULES)
@pytest.mark.parametrize("B,S", [(2, 64), (1, 40)])
def test_forward_count_equals_flop_counter(module, B, S):
    from bench import harness
    from repro_torch.models.model import build_model
    cfg = smoke.module_config(module, KEYS)
    model = build_model(harness.program_config(
        {"module": module, "config": cfg, "reduced": list(cfg)}),
        device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    toks = torch.zeros((B, S), dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        model.prefill({"tokens": toks})
    executed = counts.forward_terms(cfg, B, S, head_rows=B, causal=False,
                                    cb_per_head=True)
    assert fc.get_total_flops() == sum(executed.values())


def test_needed_count_takes_causal_pairs_and_groups():
    cfg = smoke.module_config("zamba2_2_7b", KEYS)
    full = counts.forward_terms(cfg, 2, 64, 2, causal=False, cb_per_head=True)
    need = counts.forward_terms(cfg, 2, 64, 2)
    assert need["attention"] * 2 * 64 == full["attention"] * 65
    assert need["ssd"] < full["ssd"]
    assert counts.prefill_flops(cfg, 2, 64) == sum(need.values())


def test_train_count_is_three_forwards_over_every_position():
    cfg = smoke.config("mamba2-2.7b")
    fwd = counts.forward_terms(cfg, 4, 64, head_rows=4 * 64)
    assert counts.train_flops(cfg, 4, 64) == 3 * sum(fwd.values())


def test_shared_block_counted_at_each_application():
    """The repo's Zamba2-2.7B config: the shared block's ~105M parameters
    run 9 times a token, which a count of parameters touched once
    misses."""
    cfg = smoke.module_config("zamba2_2_7b", KEYS, smoke=False)
    apps = cfg["num_layers"] // cfg["attn_every"]
    terms = counts.forward_terms(cfg, 1, 1, head_rows=1)
    d, f = cfg["d_model"], cfg["d_ff"]
    shared = 4 * d * d + 3 * d * f
    assert apps == 9
    assert terms["shared_proj"] == 2 * apps * shared
