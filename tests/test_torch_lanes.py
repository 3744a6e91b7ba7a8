"""The lane mesh: one machine's waves split into per-device lane blocks,
held against the reference package on the CPU.

PyTorch has one ``cpu`` device, so the port's N-device placement here is
``("cpu",) * N``: each entry is one logical device and one lane block, as
each of the reference's ``--xla_force_host_platform_device_count=N`` host
devices is (``tests/test_multidevice.py``).  The port runs its ``torch``
backend (the wave kernel's plain version); the reference runs its
``numpy`` backend and scalar oracle, in process.  Covered:

* placement: ``resolve_devices`` spellings and ``REPRO_SIM_DEVICES``,
  ``partition`` against the reference's, ``dispatch_lock`` identity,
  ``lane_mesh`` memoized, ``set_devices`` rebuilding the executor,
  ``SimMachine``/``simulate_batch``/``evaluate_corpus`` taking
  ``devices=``, and the engine's device telemetry;
* waves bit-identical to the reference at N = 1, 2, 4 on its ragged
  41-sequence wave; the per-block crossover (``mesh_width``) and the
  mesh bucket arithmetic equal to the reference's;
* characterize -> XML byte-identical to the reference's scalar oracle for
  every simulated uarch at N = 1, 2, 4; a two-machine ``Campaign`` over
  four logical devices; the corpus artifact at N = 2;
* traced waves: one ``wave.kernel`` span a lane block, summing to
  ``kernel_ns``.

Everything is an integer: tolerance 0."""
import itertools
import json
import random
from types import SimpleNamespace

import pytest
import torch

import repro.corpus as R
from repro.core import batch_sim as r_bs
from repro.core import model_io as r_io
from repro.core.characterize import characterize as r_characterize
from repro.core.device_mesh import partition as r_partition
from repro.core.engine import MeasurementEngine as RMeasurementEngine
from repro.core.isa import TEST_ISA as R_ISA
from repro.core.machine import RegPool as RRegPool
from repro.core.machine import independent_seq as r_independent_seq
from repro.core.simulator import SimMachine as RSim
from repro.core.uarch import SIM_UARCHES as R_UARCHES
import repro_torch.corpus as P
from repro_torch.core import model_io
from repro_torch.core.batch_sim import BatchSimMachine, _DeviceExec
from repro_torch.core.characterize import PerfModel, characterize
from repro_torch.core.device_mesh import (ENV_DEVICES, LaneMesh,
                                          cuda_devices, dispatch_lock,
                                          lane_mesh, partition,
                                          resolve_devices)
from repro_torch.core.engine import Campaign, Experiment, MeasurementEngine
from repro_torch.core.isa import TEST_ISA
from repro_torch.core.machine import RegPool, independent_seq
from repro_torch.core.simulator import SimMachine
from repro_torch.core.uarch import SIM_HSW, SIM_SKL, SIM_UARCHES
from repro_torch.corpus.store import load_manifest, read_shard
from repro_torch.obs import tracer as obs
from repro_torch.service.batch_predictor import BatchPredictor
from repro_torch.service.protocol import parse_block

CPU = torch.device("cpu")
SUBSET = ["ADD_R64_R64", "ADC_R64_R64", "MUL_R64", "SHLD_R64_R64_I8",
          "MOV_M64_R64", "PADDD_X_X"]


def _cpus(n):
    return (CPU,) * n


def _counters(res):
    return [(c.cycles, dict(c.port_uops)) for c in res]


def _ragged_wave(isa, regpool, seq, seed=0):
    """The reference's ragged wave (``tests/test_multidevice.py``): 40
    unrolled bodies of random length and one empty sequence, built in
    either package from the same seed."""
    rng = random.Random(seed)
    specs = ["ADD_R64_R64", "IMUL_R64_R64", "MOV_R64_R64", "PADDD_X_X",
             "DIV_R64", "MULPS_X_X", "ADC_R64_R64"]
    codes = []
    for _ in range(40):
        body = seq(isa[rng.choice(specs)], regpool(), rng.randint(3, 9))
        codes.append(body * rng.randint(2, 6))
    codes.append([])
    return codes


def _wave(n=12, seed=0):
    rng = random.Random(seed)
    specs = ["ADD_R64_R64", "IMUL_R64_R64", "MULPS_X_X", "DIV_R64"]
    return [independent_seq(TEST_ISA[rng.choice(specs)], RegPool(),
                            rng.randint(3, 8)) * rng.randint(2, 5)
            for _ in range(n)]


def _ref_wave(n=12, seed=0):
    rng = random.Random(seed)
    specs = ["ADD_R64_R64", "IMUL_R64_R64", "MULPS_X_X", "DIV_R64"]
    return [r_independent_seq(R_ISA[rng.choice(specs)], RRegPool(),
                              rng.randint(3, 8)) * rng.randint(2, 5)
            for _ in range(n)]


@pytest.fixture(scope="module")
def ref_ragged():
    codes = _ragged_wave(R_ISA, RRegPool, r_independent_seq)
    base = r_bs.BatchSimMachine(R_UARCHES["sim_skl"], R_ISA,
                                backend="numpy")
    return _counters(base.run_batch(codes))


# ---------------------------------------------------------------------------
# placement: resolution, partition, locks, meshes
# ---------------------------------------------------------------------------


def test_resolve_devices_spellings(monkeypatch):
    monkeypatch.delenv(ENV_DEVICES, raising=False)
    cards = cuda_devices()
    assert all(d.type == "cuda" for d in cards)
    if not torch.cuda.is_available():
        assert cards == ()
    have = cards or (torch.device("cuda:0"),)   # never the CPU instead
    assert resolve_devices(None) == have         # default: every card
    assert resolve_devices("all") == have
    assert resolve_devices(len(have)) == have
    assert resolve_devices(str(len(have))) == have
    assert resolve_devices(1) == have[:1]
    assert resolve_devices(64) == have           # clamped to the host
    assert resolve_devices(0) == have[:1]        # clamped up to 1
    # names, devices and sequences pass through, repeats included
    assert resolve_devices("cpu,cpu") == _cpus(2)
    assert resolve_devices(CPU) == _cpus(1)
    assert resolve_devices(["cpu", CPU, "cuda:1"]) == (
        CPU, CPU, torch.device("cuda:1"))


def test_resolve_devices_env(monkeypatch):
    monkeypatch.setenv(ENV_DEVICES, "cpu,cpu,cpu")
    assert resolve_devices(None) == _cpus(3)
    monkeypatch.setenv(ENV_DEVICES, "1")
    assert resolve_devices(None) == (cuda_devices() or
                                     (torch.device("cuda:0"),))[:1]
    # the environment only fills in for spec=None
    assert resolve_devices("cpu") == _cpus(1)


@pytest.mark.parametrize("d,n", [(4, 2), (4, 3), (4, 4), (2, 5), (0, 3),
                                 (4, 0), (5, 2)])
def test_partition_equals_reference(d, n):
    assert partition(list(range(d)), n) == r_partition(list(range(d)), n)
    cpus = partition(_cpus(d), n)
    assert [len(g) for g in cpus] == [len(g) for g in
                                      r_partition(list(range(d)), n)]


def test_dispatch_lock_identity():
    c0, c1 = torch.device("cuda:0"), torch.device("cuda:1")
    a = dispatch_lock((c0,))
    assert dispatch_lock(("cuda:0",)) is a        # same subset, same lock
    assert dispatch_lock((c1,)) is not a          # no card needed
    assert dispatch_lock((c1, c0)) is dispatch_lock((c0, c1))   # sorted
    assert dispatch_lock(_cpus(2)) is not dispatch_lock(_cpus(1))
    assert dispatch_lock(()) is dispatch_lock(())   # the host lock
    assert dispatch_lock(()) is not a


def test_lane_mesh_memoized():
    tr = obs.Tracer(enabled=True)
    old = obs.set_tracer(tr)
    try:
        m = lane_mesh(("cpu", "cpu", "cpu"))
        assert lane_mesh(_cpus(3)) is m
    finally:
        obs.set_tracer(old)
    assert isinstance(m, LaneMesh)
    assert m.n == 3 and m.key == ("cpu",) * 3 and m.devices == _cpus(3)
    assert m.streams() == (None,) * 3
    assert repr(m) == "<LaneMesh lanes=3 devices=['cpu', 'cpu', 'cpu']>"
    builds = [e for e in tr.events() if e["name"] == "mesh.build"]
    assert len(builds) <= 1                       # built once, if at all
    card = lane_mesh((torch.device("cuda"), "cuda:1"))
    assert card.key == ("cuda:0", "cuda:1")       # no card needed


# ---------------------------------------------------------------------------
# entry points: devices= and set_devices
# ---------------------------------------------------------------------------


def test_device_and_devices_together_raise(tmp_path):
    with pytest.raises(ValueError, match="not both"):
        BatchSimMachine(SIM_SKL, TEST_ISA, backend="torch", device="cpu",
                        devices=_cpus(2))
    with pytest.raises(ValueError, match="not both"):
        SimMachine(SIM_SKL, TEST_ISA, backend="torch", device="cpu",
                   devices=_cpus(2))
    with pytest.raises(ValueError, match="not both"):
        P.evaluate_corpus(tmp_path, backend="torch", device="cpu",
                          devices=_cpus(2))
    with pytest.raises(ValueError, match="at least one"):
        BatchSimMachine(SIM_SKL, TEST_ISA, backend="torch", devices=())


def test_cuda_backend_checks_every_entry():
    with pytest.raises(ValueError, match="CUDA device"):
        BatchSimMachine(SIM_SKL, TEST_ISA, backend="cuda",
                        devices=("cuda:0", "cpu"))
    if torch.cuda.is_available():
        return
    for spec in (("cuda:0", "cuda:0"), 2, "all"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchSimMachine(SIM_SKL, TEST_ISA, backend="cuda", devices=spec)


def test_set_devices_rebuilds_the_executor():
    codes = _wave(12)
    m = BatchSimMachine(SIM_SKL, TEST_ISA, backend="torch", devices=_cpus(1),
                        min_lanes=1)
    first = _counters(m.run_batch(codes))
    assert m.device_stats()["mesh"] is False
    m.set_devices(("cpu", "cpu"))
    assert m.devices == ("cpu", "cpu")
    assert m.device_stats() == {}        # executor dropped, rebuilt lazily
    assert _counters(m.run_batch(codes)) == first
    st = m.device_stats()
    assert st["mesh"] is True and st["devices"] == ["cpu", "cpu"]
    # a placement of another device type leaves a CPU machine where it is
    for spec in ("all", 2, ("cuda:0", "cuda:1"), ("cpu", "cuda:0")):
        m.set_devices(spec)
        assert m.devices == ("cpu", "cpu") and m.device == CPU
        assert m.device_stats() == st


def test_sim_machine_forwards_devices():
    codes = _wave(8)
    sm = SimMachine(SIM_SKL, TEST_ISA, backend="torch", min_lanes=1,
                    devices=_cpus(2))
    got = _counters(sm.run_batch(codes))
    assert sm._batch.devices == _cpus(2)
    assert sm.device_stats()["devices"] == ["cpu", "cpu"]
    sm.set_devices(_cpus(1))
    assert sm.devices == _cpus(1) and sm._batch.devices == _cpus(1)
    assert _counters(sm.run_batch(codes)) == got
    assert sm.device_stats()["mesh"] is False
    ref = RSim(R_UARCHES["sim_skl"], R_ISA).run_batch(_ref_wave(8))
    assert got == _counters(ref)
    # a placement given before the first wave applies at build time
    late = SimMachine(SIM_SKL, TEST_ISA, backend="torch", min_lanes=1,
                      device="cpu")
    late.set_devices(_cpus(4))
    assert _counters(late.run_batch(codes)) == got
    assert late.device_stats()["devices"] == ["cpu"] * 4


def test_simulate_batch_devices_knob():
    blocks = _wave(6)
    got = []
    for devices in (None, _cpus(2)):
        sm = SimMachine(SIM_SKL, TEST_ISA, backend="torch", min_lanes=1,
                        devices=_cpus(1))
        bp = BatchPredictor(PerfModel("sim_skl"), TEST_ISA,
                            backend="numpy", machine=sm)
        got.append(bp.simulate_batch(blocks, devices=devices))
        assert sm.devices == (devices or _cpus(1))
        st = sm.device_stats()
        assert st["mesh"] is (devices is not None)
        assert st["devices"] == ["cpu"] * len(devices or _cpus(1))
    assert got[0] == got[1]


def test_engine_stats_surface_device_telemetry():
    sm = SimMachine(SIM_SKL, TEST_ISA, backend="torch", min_lanes=1,
                    devices=_cpus(2))
    eng = MeasurementEngine(sm)
    eng.submit([Experiment.of(c) for c in _wave(6)])
    d = eng.stats.as_dict()["device"]
    assert d["backend"] == "torch" and d["kernel_calls"] >= 1
    assert d["mesh"] is True and d["devices"] == ["cpu", "cpu"]
    assert set(d["per_device"]) == {"cpu"}
    # every chunk launched two blocks, both on "cpu"
    assert d["per_device"]["cpu"]["kernel_calls"] == 2 * d["kernel_calls"]


# ---------------------------------------------------------------------------
# waves at N = 1, 2, 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_ragged_wave_bit_identical_across_device_counts(nd, ref_ragged):
    codes = _ragged_wave(TEST_ISA, RegPool, independent_seq)
    m = BatchSimMachine(SIM_SKL, TEST_ISA, backend="torch",
                        devices=_cpus(nd))
    assert _counters(m.run_batch(codes)) == ref_ragged
    st = m.device_stats()
    assert st["mesh"] == (nd > 1)
    assert st["devices"] == ["cpu"] * nd
    assert sum(c["lanes"] for c in st["per_device"].values()) >= 40
    c0 = st["compiles"]
    assert _counters(m.run_batch(codes)) == ref_ragged   # warm wave
    assert m.device_stats()["compiles"] == c0            # no library load
    assert m.run_batch([]) == []


def test_lane_blocks_are_the_chunks_contiguous_lanes():
    """Each launch is one lane block of ``e_dev`` lanes (a multiple of 4);
    the blocks' outputs, joined along the lanes, equal the one-device
    launch of the same chunk on its real lanes."""
    codes = _ragged_wave(TEST_ISA, RegPool, independent_seq)[:40]
    one = BatchSimMachine(SIM_SKL, TEST_ISA, backend="torch", device="cpu",
                          min_lanes=1)
    two = BatchSimMachine(SIM_SKL, TEST_ISA, backend="torch",
                          devices=_cpus(2), min_lanes=1)
    one.launched_args, two.launched_args = [], []
    assert _counters(one.run_batch(codes)) == _counters(two.run_batch(codes))
    st = two.device_stats()
    assert len(two.launched_args) == st["per_device"]["cpu"]["kernel_calls"]
    assert len(two.launched_args) == 2 * len(one.launched_args)
    assert st["per_device"]["cpu"]["lanes"] == \
        one.device_stats()["per_device"]["cpu"]["lanes"]
    from repro_torch.kernels import wave_dispatch as wd
    for k, whole in enumerate(one.launched_args):
        blocks = two.launched_args[2 * k:2 * k + 2]
        assert all(b[0].shape[1] % 4 == 0 for b in blocks)
        assert blocks[0][0].shape == blocks[1][0].shape
        lanes = int(whole[4].any(0).sum())
        done, counts = wd.wave_dispatch(*whole)
        outs = [wd.wave_dispatch(*b) for b in blocks]
        joined_done = torch.cat([o[0] for o in outs], dim=1)
        joined_counts = torch.cat([o[1] for o in outs], dim=0)
        rows = done.shape[0]
        assert torch.equal(joined_done[:rows, :lanes], done[:, :lanes])
        assert torch.equal(joined_counts[:lanes], counts[:lanes])


def test_per_block_crossover_and_slot_widths():
    """8 lanes at ``min_lanes=4`` on four devices run as two blocks (each
    keeps ``min_lanes``), and the slot keys carry the width."""
    m = BatchSimMachine(SIM_SKL, TEST_ISA, backend="torch",
                        devices=_cpus(4), min_lanes=4)
    thin = [independent_seq(TEST_ISA["ADD_R64_R64"], RegPool(), 4) * 4] * 8
    ref = r_bs.BatchSimMachine(R_UARCHES["sim_skl"], R_ISA, backend="numpy")
    rthin = [r_independent_seq(R_ISA["ADD_R64_R64"], RRegPool(), 4) * 4] * 8
    assert _counters(m.run_batch(thin)) == _counters(ref.run_batch(rthin))
    d = m._device
    assert d.mesh_width(8) == 2 and d.mesh_width(64) == 4
    assert d.mesh_width(3) == 1
    assert {k[3] for k in d._rings} == {2}
    assert m.device_stats()["per_device"]["cpu"]["kernel_calls"] == 2


@pytest.mark.parametrize("n_use", [1, 2, 3, 4])
def test_mesh_bucket_and_width_equal_reference(n_use):
    for S0, E0, R0 in itertools.product((1, 31, 33, 200, 3000),
                                        (1, 7, 8, 9, 41, 300, 2048),
                                        (1, 3, 4, 5)):
        assert _DeviceExec._mesh_bucket(S0, E0, R0, n_use) == \
            r_bs._DeviceExec._mesh_bucket(None, S0, E0, R0, n_use)
    dev = _DeviceExec(BatchSimMachine(SIM_SKL, TEST_ISA, backend="torch",
                                      device="cpu")._comp, "torch",
                      _cpus(n_use), min_lanes=4)
    ref = SimpleNamespace(n_mesh=n_use if n_use > 1 else 1, min_lanes=4)
    for E0 in range(0, 70):
        assert dev.mesh_width(E0) == r_bs._DeviceExec.mesh_width(ref, E0)


# ---------------------------------------------------------------------------
# characterize -> XML, Campaign placement, the corpus
# ---------------------------------------------------------------------------

_ORACLE_XML: dict = {}


def _oracle_xml(name):
    if name not in _ORACLE_XML:
        oracle = RSim(R_UARCHES[name], R_ISA)
        _ORACLE_XML[name] = r_io.to_xml(r_characterize(
            RMeasurementEngine(oracle), R_ISA, SUBSET), R_ISA)
    return _ORACLE_XML[name]


# N = 1 is the one-device path, held against the reference on every uarch in
# tests/test_torch_characterize.py; N = 4 on one uarch keeps this file cheap
@pytest.mark.parametrize("name, nd", [("sim_hsw", 2), ("sim_skl", 2),
                                      ("sim_skl", 4), ("sim_snb", 2)])
def test_characterize_xml_identical_across_device_counts(name, nd):
    m = SimMachine(SIM_UARCHES[name], TEST_ISA, backend="torch",
                   devices=_cpus(nd))
    got = model_io.to_xml(characterize(MeasurementEngine(m), TEST_ISA,
                                       SUBSET), TEST_ISA)
    assert got == _oracle_xml(name)
    assert m.device_stats()["mesh"] == (nd > 1)


def test_campaign_places_each_machine_on_its_device_group(monkeypatch):
    monkeypatch.setenv(ENV_DEVICES, "cpu,cpu,cpu,cpu")
    subset = ["ADD_R64_R64", "MUL_R64", "PADDD_X_X"]
    machines = [SimMachine(SIM_SKL, TEST_ISA, backend="torch", min_lanes=1),
                SimMachine(SIM_HSW, TEST_ISA, backend="torch", min_lanes=1)]
    res = Campaign(instr_names=subset).run(machines, TEST_ISA)
    assert [m.devices for m in machines] == [_cpus(2), _cpus(2)]
    for m in machines:
        st = res.stats[m.name]["device"]
        assert st["mesh"] is True and st["devices"] == ["cpu", "cpu"]
        assert st["kernel_calls"] >= 1
        solo = r_io.to_xml(r_characterize(
            RMeasurementEngine(RSim(R_UARCHES[m.name], R_ISA)), R_ISA,
            subset), R_ISA)
        assert model_io.to_xml(res.models[m.name], TEST_ISA) == solo, m.name


def test_evaluate_corpus_on_two_devices_equals_reference(tmp_path):
    """Both packages evaluate one generated corpus with the same model (the
    reference's characterization over the corpus's variants, loaded by
    each from one XML): the port's ground-truth waves on two logical
    devices give the reference's artifact byte for byte."""
    fams = ("dep_chain", "divider", "idiom")
    spec = dict(seed=7, blocks_per_uarch=32, uarches=("sim_skl",),
                shard_size=16, min_len=2, max_len=8,
                family_mix=tuple((f, 1.0 + i) for i, f in enumerate(fams)))
    corpus = tmp_path / "corpus"
    R.generate_corpus(corpus, R.CorpusSpec(**spec))
    used = sorted({ins.spec for s in load_manifest(corpus)["shards"]
                   for r in read_shard(corpus, s)
                   for ins in parse_block(r["block"])})
    xml = r_io.to_xml(r_characterize(RMeasurementEngine(
        RSim(R_UARCHES["sim_skl"], R_ISA)), R_ISA, used), R_ISA)
    want = R.evaluate_corpus(corpus, backend="numpy", wave_width=32,
                             models={"sim_skl": r_io.load_xml(xml)},
                             out_dir=tmp_path / "ref")
    got = P.evaluate_corpus(corpus, backend="torch", devices=_cpus(2),
                            predict_backend="numpy", wave_width=32,
                            models={"sim_skl": model_io.load_xml(xml)},
                            out_dir=tmp_path / "port")
    assert json.dumps(P.score_results(got), sort_keys=True) == \
        json.dumps(R.score_results(want), sort_keys=True)
    assert got["wave_stats"]["max_wave_width"] == 32


# ---------------------------------------------------------------------------
# traced waves
# ---------------------------------------------------------------------------


def test_traced_waves_give_one_kernel_span_a_block():
    m = BatchSimMachine(SIM_SKL, TEST_ISA, backend="torch", devices=_cpus(2),
                        min_lanes=1)
    codes = _wave(20, seed=3)
    tr = obs.Tracer(enabled=True)
    old = obs.set_tracer(tr)
    try:
        for n in (len(codes), 5, len(codes)):
            m.run_batch(codes[:n])
            st = m.device_stats()
            spans = [e for e in tr.events() if e["name"] == "wave.kernel"]
            per = st["per_device"]["cpu"]
            assert {e["tid"] for e in spans} == {"device:cpu"}
            assert len(spans) == per["kernel_calls"] > st["kernel_calls"]
            assert sum(e["dur"] for e in spans) == \
                st["kernel_ns"]["device:cpu"]
            assert sum(e["args"]["lanes"] for e in spans) == per["lanes"]
            assert "device:cpu" in json.dumps(st["stragglers"])
    finally:
        obs.set_tracer(old)
