"""The wave-dispatch wrapper on the card: what the kernel does not take
raises before any launch.

Marked ``cuda``: each test skips without a GPU.  The file imports neither
jax nor the reference package, so a GPU host without jax collects and runs
it:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card_*.py

The kernel against its plain version and the reference stays in
``tests/test_torch_cuda.py``, which needs jax."""
import pytest
import torch

from repro_torch.kernels import wave_dispatch as wd

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


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
