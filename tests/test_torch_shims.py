"""The port's two deprecated shims re-export the objects of the modules
that replaced them, as the reference's do: ``ops.corpus`` (the jitted-op
corpus, ``corpus.jit_ops``) and ``runtime.fault_tolerance`` (the
fault-tolerance objects, ``faults.tolerance``, with a
``DeprecationWarning`` on import); and the two packages now hold the same
module paths."""
import importlib
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"


def test_ops_corpus_names_are_jit_ops_objects():
    from repro_torch.corpus import jit_ops
    from repro_torch.ops import corpus
    assert corpus.__all__ == ["build_corpus", "build_jit_corpus"]
    for name in corpus.__all__:
        assert getattr(corpus, name) is getattr(jit_ops, name)


def test_fault_tolerance_names_are_the_faults_objects():
    from repro_torch.faults import tolerance
    sys.modules.pop("repro_torch.runtime.fault_tolerance", None)
    with pytest.warns(DeprecationWarning, match="faults.tolerance"):
        shim = importlib.import_module("repro_torch.runtime.fault_tolerance")
    assert shim.__all__ == ["FleetMonitor", "StepTimer", "StragglerDetector"]
    for name in shim.__all__:
        assert getattr(shim, name) is getattr(tolerance, name)


def test_every_reference_module_has_a_port():
    ref = {p.relative_to(SRC / "repro") for p in
           (SRC / "repro").rglob("*.py")}
    port = {p.relative_to(SRC / "repro_torch") for p in
            (SRC / "repro_torch").rglob("*.py")}
    assert not ref - port, sorted(map(str, ref - port))
