"""The harness loads neither JAX nor the JAX package, and gives no result
where it cannot measure: without a card, or without the program."""
import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from bench import smoke

ROOT = smoke.ROOT

POISON = textwrap.dedent("""
    import importlib.abc, pathlib, sys
    BLOCKED = {"jax", "jaxlib", "flax", "repro"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    for m in list(sys.modules):
        if m.split(".")[0] in BLOCKED:
            del sys.modules[m]
    sys.meta_path.insert(0, Block())
    root = pathlib.Path(sys.argv[1])
    sys.path[:0] = [str(root / "src"), str(root)]
    import importlib.util
    names = []
    for path in sorted((root / "bench").rglob("*.py")):
        if path.name.startswith("test_") or path.name == "conftest.py":
            continue
        rel = path.relative_to(root).with_suffix("")
        name = ".".join(rel.parts)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        names.append(name)
    # the program modules the kinds reach
    for m in ("repro_torch.models.model", "repro_torch.train.serve",
              "repro_torch.train.train_loop", "repro_torch.optim.adamw",
              "repro_torch.data.pipeline"):
        importlib.import_module(m)
    bad = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print("LOADED", len(names), "BAD", bad)
""")


def test_every_bench_module_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", POISON, str(ROOT)],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.endswith("BAD []"), last
    assert int(last.split()[1]) >= 20


def test_forbidden_names_are_compared_whole():
    from bench import harness
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = sys
        sys.modules["jaxlike.sub"] = sys
        assert harness.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved} & set(harness.FORBIDDEN))
        sys.modules["jax.numpy"] = sys
        assert "jax" in harness.forbidden_modules()
    finally:
        for m in ("repro_torch_like", "jaxlike.sub", "jax.numpy"):
            sys.modules.pop(m, None)


def _run(root, *extra):
    return subprocess.run(
        [sys.executable, str(root / "bench" / "run.py"), "--workload",
         "mamba2-2.7b.prefill_4k", "--seed", str(2**31 + 3), "--seconds",
         "1", "--trace", "0", *extra], cwd=root, capture_output=True,
        text=True, timeout=240)


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            assert "metrics" not in json.loads(line)
        except ValueError:
            pass


def test_run_without_a_card_exits_nonzero_with_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert "is_available() is false" in out.stderr
    _no_result(out)


def test_run_without_the_program_exits_nonzero_with_no_result(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "not in this checkout" in out.stderr
    _no_result(out)
