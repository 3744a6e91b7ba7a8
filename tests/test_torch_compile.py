"""The port's compiled μop tables and carried ground truths equal the
reference package's: ``compile_uarch`` array for array on every
simulated uarch, the TPU-unit model and seeded random uarches, and
``carry`` round-trips the reference's uarch and ISA objects."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import isa as r_isa
from repro.core import uarch as r_uarch
from repro.core.uarch_compile import compile_uarch as r_compile
from repro_torch.core import carry
from repro_torch.core import isa as p_isa
from repro_torch.core import uarch as p_uarch
from repro_torch.core.uarch_compile import compile_uarch as p_compile

RANDOM_SEEDS = (0, 1, 2, 7, 31)


def _wide_machines(isa_mod, uarch_mod):
    """The 18-port machine of the reference's batch tests."""
    ports = tuple(f"p{i:02d}" for i in range(18))
    b = {"WADD": uarch_mod.beh(uarch_mod.uop(frozenset(ports), ("op2",),
                                             ("op1",)))}
    ua = uarch_mod.UArch("sim_wide", ports, 8, b, overhead_cycles=0)
    isa = isa_mod.ISA([isa_mod.InstrSpec(
        "WADD", "WADD", (isa_mod.op("op1", isa_mod.GPR, "w"),
                         isa_mod.op("op2", isa_mod.GPR, "r")))])
    return ua, isa


def _pair(kind):
    """(reference uarch, reference isa, port uarch, port isa) built by
    each package's own constructors."""
    if kind in r_uarch.SIM_UARCHES:
        return (r_uarch.SIM_UARCHES[kind], r_isa.TEST_ISA,
                p_uarch.SIM_UARCHES[kind], p_isa.TEST_ISA)
    if kind == "tpu":
        ra, ri, _ = r_uarch.make_tpu_sim()
        pa, pi, _ = p_uarch.make_tpu_sim()
        return ra, ri, pa, pi
    if kind == "wide":
        return _wide_machines(r_isa, r_uarch) + _wide_machines(p_isa,
                                                              p_uarch)
    seed = int(kind.split(":")[1])
    ra, ri, _ = r_uarch.random_uarch_and_isa(seed)
    pa, pi, _ = p_uarch.random_uarch_and_isa(seed)
    return ra, ri, pa, pi


KINDS = sorted(r_uarch.SIM_UARCHES) + ["tpu", "wide"] + [
    f"random:{s}" for s in RANDOM_SEEDS]


def _assert_tables_equal(a, b):
    assert a.ports == b.ports and a.port_pos == b.port_pos
    for name in ("issue_width", "overhead_cycles", "partial_stall_penalty",
                 "store_forward_latency"):
        assert getattr(a, name) == getattr(b, name), name
    n_arrays = 0
    for f in dataclasses.fields(a):
        va = getattr(a, f.name)
        if isinstance(va, np.ndarray):
            vb = getattr(b, f.name)
            assert isinstance(vb, np.ndarray), f.name
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
            n_arrays += 1
    assert n_arrays >= 15
    assert [list(s) for s in a.syms] == [list(s) for s in b.syms]
    assert a.index.names == b.index.names
    assert [dataclasses.astuple(s) for s in a.index.specs] == \
        [dataclasses.astuple(s) for s in b.index.specs]


@pytest.mark.parametrize("kind", KINDS)
def test_compiled_tables_equal_reference(kind):
    ra, ri, pa, pi = _pair(kind)
    _assert_tables_equal(r_compile(ra, ri), p_compile(pa, pi))


@pytest.mark.parametrize("kind", KINDS)
def test_seeded_ground_truths_equal(kind):
    ra, ri, pa, pi = _pair(kind)
    assert dataclasses.asdict(ra) == dataclasses.asdict(pa)
    assert [dataclasses.asdict(s) for s in ri] == \
        [dataclasses.asdict(s) for s in pi]


@pytest.mark.parametrize("kind", KINDS)
def test_carry_round_trips_reference_objects(kind):
    ra, ri, _, _ = _pair(kind)
    ua = carry.uarch_from_plain(dataclasses.asdict(ra))
    isa = carry.isa_from_plain([dataclasses.asdict(s) for s in ri])
    assert isinstance(ua, p_uarch.UArch) and isinstance(isa, p_isa.ISA)
    assert dataclasses.asdict(ua) == dataclasses.asdict(ra)
    assert [dataclasses.asdict(s) for s in isa] == \
        [dataclasses.asdict(s) for s in ri]
    assert isa.names() == ri.names()
    # the carried machine compiles to the reference's tables
    _assert_tables_equal(r_compile(ra, ri), p_compile(ua, isa))


def test_carry_takes_numpy_scalars():
    d = dataclasses.asdict(r_uarch.SIM_SKL)
    d["issue_width"] = np.int64(d["issue_width"])
    d["ports"] = np.array(d["ports"])
    d["overhead_cycles"] = np.int32(d["overhead_cycles"])
    ua = carry.uarch_from_plain(d)
    assert type(ua.issue_width) is int and type(ua.overhead_cycles) is int
    assert ua.ports == r_uarch.SIM_SKL.ports
    assert dataclasses.asdict(ua) == dataclasses.asdict(r_uarch.SIM_SKL)


@pytest.mark.parametrize("kind", ["sim_skl", "wide"])
def test_device_mask_table_is_memoized_per_device(kind):
    _, _, pa, pi = _pair(kind)
    comp = p_compile(pa, pi)
    lut = comp.device_mask_table("cpu")
    assert lut.dtype == torch.bool and lut.device.type == "cpu"
    np.testing.assert_array_equal(lut.numpy(), comp.mask_table)
    assert comp.device_mask_table(torch.device("cpu")) is lut
