"""The port's CUDA kernel on the card, against its plain version and the
reference package.  Marked ``cuda``: each test skips without a GPU and
runs on one with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernel is built from ``src/repro_torch/csrc`` with nvcc at first use.
Tolerance 0: every quantity is an integer."""
import pytest
import torch
from conftest import CHAR_SUBSET
from test_torch_batch_sim import (_interesting_wave, _port_codes,
                                  _random_wave, _sim, _tie_pair)

from repro.core import batch_sim as r_bs
from repro.core import model_io as r_io
from repro.core.characterize import characterize as r_characterize
from repro.core.engine import MeasurementEngine as REngine
from repro.core.isa import TEST_ISA as R_ISA
from repro.core.simulator import SimMachine as RSim
from repro.core.uarch import SIM_SKL as R_SKL
from repro_torch.core import batch_sim as p_bs
from repro_torch.core import model_io as p_io
from repro_torch.core.characterize import characterize as p_characterize
from repro_torch.core.engine import MeasurementEngine as PEngine
from repro_torch.core.isa import TEST_ISA as P_ISA
from repro_torch.core.simulator import SimMachine as PSim
from repro_torch.core.uarch import SIM_SKL as P_SKL
from repro_torch.kernels import wave_dispatch as wd

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _waves():
    yield "sim_skl", _sim("sim_skl"), _interesting_wave(R_ISA)
    yield "sim_snb", _sim("sim_snb"), _interesting_wave(R_ISA)
    yield "tie18", *_tie_pair([f"p{i:02d}" for i in range(18)])
    yield "random3", *_random_wave(3, 103)


@pytest.mark.parametrize("case", ["sim_skl", "sim_snb", "tie18", "random3"])
def test_kernel_equals_plain_version_and_reference(card, case):
    label, pair, codes = next(w for w in _waves() if w[0] == case)
    ra, ri, pa, pi = pair
    m = p_bs.BatchSimMachine(pa, pi, backend="cuda", device=card,
                             min_lanes=1)
    m.launched_args = []
    before = wd.launches
    got = m.run_batch(_port_codes(codes))
    assert wd.launches - before == m.device_stats()["kernel_calls"] > 0
    assert len(m.launched_args) == m.device_stats()["kernel_calls"]
    ref = r_bs.BatchSimMachine(ra, ri, backend="numpy",
                               min_lanes=1).run_batch(codes)
    assert [(c.cycles, c.port_uops) for c in got] == \
        [(c.cycles, c.port_uops) for c in ref]
    for args in m.launched_args:
        assert args[0].is_cuda
        done, counts = wd.wave_dispatch(*args)
        ref_done, ref_counts = wd.wave_dispatch_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(done, ref_done) and torch.equal(counts,
                                                           ref_counts)


def test_characterize_on_the_card_equals_reference(card):
    ref = r_characterize(REngine(RSim(R_SKL, R_ISA, backend="numpy")),
                         R_ISA, CHAR_SUBSET)
    m = PSim(P_SKL, P_ISA, backend="cuda", device=card)
    port = p_characterize(PEngine(m), P_ISA, CHAR_SUBSET)
    assert p_io.to_xml(port, P_ISA) == r_io.to_xml(ref, R_ISA)
    ref.run_seconds = port.run_seconds = 0.0
    assert p_io.to_json(port) == r_io.to_json(ref)
    assert m.device_stats()["backend"] == "cuda"
    assert m.device_stats()["kernel_calls"] > 0


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    S, E = 4, 3
    z = torch.zeros((S, E), dtype=torch.int32, device=card)
    args = [z, z, z, z, torch.ones((S, E), dtype=torch.bool, device=card),
            torch.full((S, E, 1), -1, dtype=torch.int32, device=card),
            torch.zeros((S, E, 1), dtype=torch.int32, device=card),
            torch.ones((2, 33), dtype=torch.bool, device=card)]
    with pytest.raises(ValueError, match="ports"):
        wd.wave_dispatch(*args)
    args[7] = torch.ones((2, 8), dtype=torch.bool, device=card)
    args[0] = torch.zeros((E, S), dtype=torch.int32, device=card).t()
    with pytest.raises(ValueError, match="contiguous"):
        wd.wave_dispatch(*args)
    args[0] = z.cpu()
    with pytest.raises(ValueError, match="is on"):
        wd.wave_dispatch(*args)
