"""The PyTorch port stands alone and runs on the card unless asked not to:
it imports with ``jax`` and ``repro`` unavailable, its entry points
default to the ``cuda`` backend on ``cuda:0``, and asking for the card
where there is none raises instead of running on the CPU."""
import inspect
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core.batch_sim import BatchSimMachine
from repro_torch.core.device_mesh import (dispatch_lock, partition,
                                          resolve_devices)
from repro_torch.core.isa import TEST_ISA
from repro_torch.core.machine import RegPool, independent_seq
from repro_torch.core.simulator import SimMachine
from repro_torch.core.uarch import SIM_SKL
from repro_torch.kernels import wave_dispatch as wd

SRC = Path(__file__).resolve().parent.parent / "src"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_package_has_the_slice_modules():
    mods = set(_modules())
    for name in ("core.isa", "core.uarch", "core.simulator",
                 "core.uarch_compile", "core.device_mesh", "core.batch_sim",
                 "core.engine", "core.plan", "core.machine", "core.blocking",
                 "core.port_usage", "core.lp", "core.latency",
                 "core.throughput", "core.characterize", "core.model_io",
                 "core.carry", "obs.tracer", "obs.metrics", "faults.plan",
                 "faults.tolerance", "kernels.wave_dispatch"):
        assert f"repro_torch.{name}" in mods, name


def test_imports_with_jax_and_repro_poisoned():
    """Every module of the port imports in a process where ``import jax``
    and ``import repro`` fail."""
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None "
        "and (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sources_never_mention_the_reference_package_in_imports():
    root = SRC / "repro_torch"
    for path in root.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not s.startswith(("import jax", "from jax",
                                         "import repro ", "from repro.",
                                         "from repro ", "import repro.")), \
                    (path, s)


def test_defaults_are_the_card():
    params = inspect.signature(BatchSimMachine).parameters
    assert params["backend"].default == "cuda"
    assert params["device"].default == "cuda"
    assert resolve_devices() == (torch.device("cuda:0"),)


def test_simmachine_backend_env_default_is_cuda(monkeypatch):
    monkeypatch.delenv("REPRO_SIM_BACKEND", raising=False)
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    m = SimMachine(SIM_SKL, TEST_ISA)
    body = independent_seq(TEST_ISA["ADD_R64_R64"], RegPool(), 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.run_batch([body * 10, body * 110, body * 20, body * 30])
    assert m._batch is None       # nothing ran anywhere else


def test_cuda_backend_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchSimMachine(SIM_SKL, TEST_ISA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchSimMachine(SIM_SKL, TEST_ISA, backend="cuda", device="cuda:0")
    with pytest.raises(ValueError, match="CUDA device"):
        BatchSimMachine(SIM_SKL, TEST_ISA, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        BatchSimMachine(SIM_SKL, TEST_ISA, backend="numpy", device="cpu")


def test_wrapper_runs_the_plain_version_only_for_cpu_tensors():
    S, E, R, M, P = 3, 2, 1, 1, 2
    z = torch.zeros((S, E), dtype=torch.int32)
    args = (z, z, z + 1, z + 1, torch.ones((S, E), dtype=torch.bool),
            torch.full((S, E, R), -1, dtype=torch.int32),
            torch.zeros((S, E, R), dtype=torch.int32),
            torch.ones((M, P), dtype=torch.bool))
    before = wd.launches
    done, counts = wd.wave_dispatch(*args)
    assert wd.launches == before          # the plain version is no launch
    ref_done, ref_counts = wd.wave_dispatch_ref(*args)
    assert torch.equal(done, ref_done) and torch.equal(counts, ref_counts)
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        wd.wave_dispatch(*meta)
    with pytest.raises(TypeError, match="int32"):
        wd.wave_dispatch(z.long(), *args[1:])
    with pytest.raises(ValueError, match="must be"):
        wd.wave_dispatch(z[:2], *args[1:])


def test_placement_helpers():
    devs = resolve_devices("cuda:0,cuda:1")
    assert devs == (torch.device("cuda:0"), torch.device("cuda:1"))
    assert partition(devs[:1], 3) == [devs[:1]] * 3
    assert partition(devs, 2) == [devs[:1], devs[1:]]
    assert partition((), 2) == [(), ()]
    assert dispatch_lock(devs[:1]) is dispatch_lock((torch.device("cuda:0"),))
    assert dispatch_lock(devs[:1]) is not dispatch_lock(devs[1:])
    # a CPU machine keeps the CPU under a card placement
    m = BatchSimMachine(SIM_SKL, TEST_ISA, backend="torch", device="cpu")
    m.set_devices(devs[:1])
    assert m.device == torch.device("cpu")
