"""The port's chip-side tools on the CPU: the variants they build stay tied
to the kernel sources they measure.

``repro_torch.tools.port_bound_ablation`` and ``ssd_ablation`` make each
variant of their kernel by exact text replacement, and stop if a replaced
text is gone; these tests find that before a chip run does."""
import pytest

from repro_torch.tools import port_bound_ablation as pba
from repro_torch.tools import ssd_ablation as sda

PB_SOURCE = pba.KEPT.read_text()
SSD_SOURCE = sda.KEPT.read_text()


@pytest.mark.parametrize("name", sorted(pba.VARIANTS))
def test_each_port_bound_patch_applies(name):
    for old, _ in pba.VARIANTS[name]:
        assert PB_SOURCE.count(old) == 1, old[:70]
    assert pba.variant_source(PB_SOURCE, pba.VARIANTS[name]) != PB_SOURCE


@pytest.mark.parametrize("name", sorted(sda.VARIANTS))
def test_each_ssd_patch_applies(name):
    assert sda.VARIANTS[name](SSD_SOURCE) != SSD_SOURCE


def test_a_missing_text_stops_the_port_bound_ablation():
    with pytest.raises(SystemExit, match="not in the source once"):
        pba.variant_source(PB_SOURCE, [("no such text", "")])
