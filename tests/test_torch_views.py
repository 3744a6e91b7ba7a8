"""``kernels._build.aligned``, the helper every public op and blocker
wrapper passes its CUDA inputs through before a launch: the kernels read
rows with 16-byte loads, so a view that is not contiguous or does not
start on a 16-byte boundary is copied, and any other tensor is used in
place.  Checked here on CPU tensors (the helper looks only at layout and
address); the wrappers on the card are held on views in
``tests/test_torch_card_*.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels._build import aligned, card_inputs


def _tensor(shape, dtype=torch.float32):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contiguous_aligned_input_is_used_in_place(dtype):
    x = _tensor((4, 16, 8, 64), dtype)
    assert x.data_ptr() % 16 == 0
    assert aligned(x) is x
    assert aligned(x).data_ptr() == x.data_ptr()


VIEWS = {
    # q made (B, S, H, D) and passed as (B, H, S, D)
    "transposed q": lambda: _tensor((2, 96, 4, 64)).transpose(1, 2),
    # contiguous, but 84 bytes past a 16-byte boundary
    "x[1:] of f32 (rows, 21)": lambda: _tensor((33, 21))[1:],
    "strided slice": lambda: _tensor((40, 128))[:, ::2],
    "bf16 x[1:] of (rows, 21)": lambda: _tensor((9, 21), torch.bfloat16)[1:],
    "column split of a projection":
        lambda: _tensor((2, 64, 1, 256))[..., 128:],
}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_view_input_becomes_an_equal_contiguous_aligned_copy(view):
    x = VIEWS[view]()
    assert not (x.is_contiguous() and x.data_ptr() % 16 == 0)
    y = aligned(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == 0
    assert y.shape == x.shape and y.dtype == x.dtype
    assert y.data_ptr() != x.data_ptr()
    assert torch.equal(y, x)
    assert aligned(y) is y


def test_empty_input_is_used_in_place():
    x = torch.empty((0, 21))
    assert aligned(x) is x


def test_card_inputs_leave_cpu_tensors_to_the_plain_version():
    """On the CPU a view is not copied: the plain version takes any
    layout."""
    x, w = _tensor((33, 21))[1:], _tensor((21,))
    card, (x2, w2) = card_inputs("rmsnorm", x, w)
    assert card is False
    assert x2 is x and w2 is w


def test_card_inputs_raise_on_another_device():
    with pytest.raises(ValueError, match="cuda or cpu"):
        card_inputs("rmsnorm", torch.empty((4, 21), device="meta"))
