"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell; everything else is found by name under
``bench/``:

* ``configs/<config>.json``: the configuration as it is run (its
  ``config`` block), the repo module it is built from (``module``), its
  source, what was ``reduced`` and ``assumed``;
* ``workloads/<cell>.json``: the ``kind`` of work (a module
  ``kinds/<kind>.py``), its ``traffic`` parameters and the ``limits`` of
  the numbers that decide ``correct``;
* ``metrics/<metric>.py``, or else ``metrics/<stem>.py`` for a metric
  named ``<stem>.<suffix>`` (``mfu.train`` and ``mfu.prefill`` share
  ``mfu.py``): one reader a quantity, ``read(ctx)`` returning a number, or
  None where the run has nothing for it to read;
* ``reference/<family>.py``: the plain float32 reference of a model
  family.

The program under test is ``src/repro_torch`` of the same checkout, and
nothing else of the repository is imported.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """The run cannot give a result (no card, a missing file, a reader
    that returned nothing for an end-to-end metric)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise RunError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The reader of metric ``name``: its own file, or else its stem's."""
    own = root / "bench" / "metrics" / f"{name}.py"
    path = own if own.is_file() else own.with_name(
        name.split(".")[0] + ".py")
    return load_module(path, f"bench.metrics.{path.stem}")


def verdict(win: dict, checks: dict) -> bool:
    """``correct``: no unit of the window failed, and every number
    compared is finite and within its limit."""
    return win["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())


def cell_spec(spec: dict, name: str, root: Path = ROOT) -> dict:
    """The cell's entries: its workload and configuration entries, the
    two files, and the metrics it reports traced and untraced."""
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    ce = next(c for c in spec["configs"] if c["name"] == wl["config"])
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return {"workload": wl, "config": ce,
            "config_file": load_json(root / ce["file"]),
            "work": load_json(root / "bench" / "workloads" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": layer}


def forbidden_modules() -> list:
    """JAX and the JAX package among the loaded modules, by whole
    top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: Path):
    """Every build and kernel cache at a fixed path inside the checkout, and
    the process's allocator setting; before torch is imported."""
    build = root / "build"
    os.environ.update({
        "REPRO_TORCH_BUILD_DIR": str(build / "repro_torch"),
        "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
        "TRITON_CACHE_DIR": str(build / "triton"),
        "USE_FLAX": "0",
        # the allocator grows segments in place instead of leaving freed
        # blocks of one size unusable for another (the training step's
        # AdamW update otherwise fails on ~7 GiB reserved but unallocated)
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
    })


def program_config(cfg_file: dict):
    """The program's ``ModelConfig``: the repo module's, with the file's
    ``config`` block laid over it; a key that differs from the module's and
    is not in ``reduced`` is refused."""
    import torch

    from repro_torch.configs.base import load_config
    base = load_config(cfg_file["module"])
    over = {}
    for k, v in cfg_file["config"].items():
        if isinstance(v, str) and v in ("float32", "bfloat16", "float16"):
            v = getattr(torch, v)
        if getattr(base, k) != v:
            if k not in cfg_file["reduced"]:
                raise RunError(f"config key {k} differs from "
                               f"{cfg_file['module']} and is not reduced")
            over[k] = v
    return base.replace(**over)


class Cell:
    """The state of one run, shared by the kind's functions; a kind sets
    what it needs on it (``step``, ``pool``, ``opt_state`` ...)."""

    def __init__(self, **fields):
        self.weights = self.model = None
        self.__dict__.update(fields)

    def sync(self):
        import torch
        if self.device != "cpu":
            torch.cuda.synchronize()

    def free_program(self):
        """Drop the program's objects (model, step, optimizer state, data)
        before the reference runs."""
        import torch
        self.model = None
        for key in ("step", "opt_state", "data"):
            self.__dict__.pop(key, None)
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()


def build(cs: dict, seed: int, *, root: Path = ROOT, device: str = "cuda",
          config_override: dict | None = None,
          traffic_override: dict | None = None) -> Cell:
    """The cell (``cell_spec``'s) as a :class:`Cell` with its weights and
    the program's model loaded with them."""
    name = cs["workload"]["name"]
    cfg_file = dict(cs["config_file"])
    if config_override:
        cfg_file["config"] = {**cfg_file["config"], **config_override}
        cfg_file["reduced"] = list(cfg_file["config"])
    work = cs["work"]
    traffic = {**work["traffic"], **(traffic_override or {})}
    from repro_torch.models.model import build_model
    cfg = program_config(cfg_file)
    fam = load_module(root / "bench" / "reference" /
                      f"{cfg_file['config']['family']}.py",
                      f"bench.reference.{cfg_file['config']['family']}")
    specs = fam.leaf_specs(cfg_file["config"])
    from bench.reference import common as C
    cell = Cell(name=name, seed=seed, device=device, cfg=cfg,
                cfg_json=cfg_file["config"], traffic=traffic, reference=fam,
                specs=specs)
    cell.weights = C.make_weights(specs, seed, device)
    cell.model = build_model(cfg, device="meta")
    cell.model.load_state_dict(cell.weights, strict=True, assign=True)
    return cell


def _device_info(device: str, chips: int) -> dict:
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(name: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, root: Path = ROOT, device: str = "cuda",
        config_override: dict | None = None,
        traffic_override: dict | None = None,
        limits_override: dict | None = None) -> tuple:
    """One run: set-up, the window, the traced sub-window (``traced``),
    the check.  Returns (the result's dict, the lines of numbers compared
    with their limits).  The overrides are for tests at small sizes on
    the CPU (``device="cpu"``)."""
    import torch

    from bench import counts
    spec = load_json(root / "BENCHMARK.json")
    cs = cell_spec(spec, name, root)
    chips = cs["workload"]["chips"]
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise RunError(f"{torch.cuda.device_count()} cards, the cell "
                           f"needs {chips}")
    work = cs["work"]
    kind = load_module(root / "bench" / "kinds" / f"{work['kind']}.py",
                       f"bench.kinds.{work['kind']}")
    wanted = cs["per_layer"] if traced else cs["end_to_end"]
    readers = {m["name"]: metric_reader(m["name"], root) for m in wanted}
    cell = build(cs, seed, root=root, device=device,
                 config_override=config_override,
                 traffic_override=traffic_override)
    kind.setup(cell)
    cell.sync()
    setup_s = time.perf_counter() - t_start
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    win = kind.window(cell, seconds)
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    trace = None
    if traced:
        from bench import trace as TR
        trace = TR.profile(lambda: kind.unit(cell),
                           cell.traffic["trace_units"], cell.sync)
        if device != "cpu" and not trace["busy_s"] > 0:
            raise RunError("the profiler recorded no device time")
    t_check = time.perf_counter()
    numbers = kind.check(cell)
    check_s = time.perf_counter() - t_check
    limits = {**work["limits"], **(limits_override or {})}
    ctx = {"kind": work["kind"], "window": win, "trace": trace,
           "setup_s": setup_s, "memory_peak_bytes": peak,
           "peak_flops": counts.PEAKS["bf16_flops"]}
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(ctx)
        if v is None:
            if not traced:
                raise RunError(f"no value for end-to-end {m['name']}")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = verdict(win, checks)
    dev = _device_info(device, chips)
    dev["memory_peak_bytes"] = int(peak)
    if device != "cpu":
        dev["power"] = power_limit()
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = trace["breakdown"]
    result["checks"] = checks
    lines = [f"bench: setup {setup_s:.1f} s, window {win['seconds']:.1f} s "
             f"({win['units']} units), reference check {check_s:.1f} s"]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return result, lines
