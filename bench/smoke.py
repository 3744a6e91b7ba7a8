"""Small sizes of the benchmark's cells for the CPU tests: each
configuration at its repo module's ``SMOKE_CONFIG`` and a few short
prompts or rows, with the limits the comparison holds there (set, as the
cells' limits are, between the program's readings at these sizes and the
lower-precision control's: ``PERF.md``)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

TRAFFIC = {
    "prefill": {"batch": 4, "prompt_len": 64, "pad_to": 80,
                "pool_batches": 4, "check_batches": 2, "trace_units": 2},
    "train": {"batch": 4, "seq_len": 64, "check_steps": 2,
              "trace_units": 1},
}

# program / control (/ half batch) over 8 seeds at these sizes, the
# largest program and the smallest control reading: prefill token_gap
# 0.0123 / 0.0332 (no upper reading at this size: the control fails the
# other three), logit_err 0.178 / 0.732, logit_rms_err 0.0533 / 0.247,
# state_err 0.0963 / 0.290; train loss_gap 7.6e-5 / 1.3e-5 / 9.8e-4,
# grad_gap 0.0068 / 0.0324 / 0.066, change_gap 0.0037 / 0.0066 / 0.0227;
# the late step over 8 more seeds: late_loss_gap 3.8e-5 / 8.6e-6 / 6.8e-4,
# late_change_gap 0.0019 / 0.0035 / 0.011
LIMITS = {
    "prefill": {"token_gap": 0.1, "logit_err": 0.3,
                "logit_rms_err": 0.09, "state_err": 0.17},
    "train": {"loss_gap": 2.5e-4, "grad_gap": 0.013, "change_gap": 0.01,
              "late_loss_gap": 2.5e-4, "late_change_gap": 0.003},
}


def program_path():
    """``src`` and the checkout root on ``sys.path``."""
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def module_config(module: str, keys, smoke: bool = True) -> dict:
    """A ``config`` block (``keys``) of the repo's config ``module``, at
    its ``SMOKE_CONFIG`` sizes or its own."""
    import torch

    from repro_torch.configs.base import load_config
    cfg = load_config(module, smoke=smoke)
    out = {}
    for k in keys:
        v = getattr(cfg, k)
        out[k] = str(v).split(".")[-1] if isinstance(v, torch.dtype) else v
    return out


def config(name: str, root: Path = ROOT) -> dict:
    """The ``config`` block of configuration ``name`` at its module's
    ``SMOKE_CONFIG`` sizes."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == name)
    cfg_file = json.loads((root / entry["file"]).read_text())
    return module_config(cfg_file["module"], cfg_file["config"])


def kwargs(workload: str, root: Path = ROOT) -> dict:
    """``harness.run``'s small-size arguments for a cell."""
    work = json.loads((root / "bench" / "workloads" /
                       f"{workload}.json").read_text())
    return {"device": "cpu", "root": root,
            "config_override": config(work["config"], root),
            "traffic_override": TRAFFIC[work["kind"]],
            "limits_override": LIMITS[work["kind"]]}
