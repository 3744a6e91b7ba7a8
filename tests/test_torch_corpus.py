"""The port's block corpus (``repro_torch.corpus``) against the
reference's (``repro.corpus``).

* Generation: the same :class:`CorpusSpec` writes shard files and a
  ``manifest.json`` byte-identical to the reference's, on several seeds
  and all three simulated uarches.
* Scoring: ``mape``, ``kendall_tau``, ``error_buckets``, ``score_pairs``,
  ``score_results`` and ``format_report`` equal the reference's, bit for
  bit, on seeded numpy inputs with ties.
* Evaluation: on the reference tests' corpus (``tests/test_corpus.py``'s
  spec), ``evaluate_corpus`` then ``score_results`` gives an accuracy
  artifact (``json.dumps(..., sort_keys=True)``, ``wave_stats`` and
  ``engine_stats`` included) byte-identical to the reference's ``numpy``
  backend, with the port's ``torch`` wave backend on ``device="cpu"`` and
  either predict backend; so does the served path on both wires, the port
  client against the reference server and the reference client against
  the port server included.  A resumed run skips finished shards and
  gives the same scores; the ``corpus.shard_write`` fault site behaves as
  in the reference's ``tests/test_faults.py``."""
import json

import numpy as np
import pytest

import repro.corpus as R
from repro.core import model_io as r_io
from repro.core.isa import TEST_ISA as R_ISA
from repro.corpus import evaluate as r_evaluate
from repro.service.client import ServiceClient as RClient
from repro.service.registry import ModelRegistry as RRegistry
from repro.service.server import PredictionServer as RServer
from repro.service.server import PredictionService as RService
import repro_torch.corpus as P
from repro_torch.core import model_io
from repro_torch.core.characterize import PerfModel, characterize
from repro_torch.core.isa import TEST_ISA
from repro_torch.core.simulator import SimMachine
from repro_torch.core.uarch import SIM_SKL, SIM_UARCHES
from repro_torch.corpus.evaluate import _load_resumed, _write_rows
from repro_torch.corpus.store import load_manifest, read_shard
from repro_torch.faults import plan as fplan
from repro_torch.faults.plan import FaultPlan
from repro_torch.service.client import ServiceClient
from repro_torch.service.protocol import parse_block
from repro_torch.service.registry import ModelRegistry
from repro_torch.service.server import PredictionServer, PredictionService

SPEC = dict(seed=7, blocks_per_uarch=48, uarches=("sim_skl",),
            shard_size=16, min_len=2, max_len=8)
CPU = {"backend": "torch", "device": "cpu"}


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _artifact(results) -> str:
    return json.dumps(P.score_results(results), sort_keys=True)


def _ref_artifact(results) -> str:
    return json.dumps(R.score_results(results), sort_keys=True)


# -- generation --------------------------------------------------------------

@pytest.mark.parametrize("seed,blocks,shard,lens,fams", [
    (0, 64, 24, (2, 12), None),
    (7, 48, 16, (2, 8), None),
    (123, 40, 40, (1, 5), ("dep_chain", "divider", "idiom")),
])
def test_generation_byte_identical_to_reference(tmp_path, seed, blocks,
                                                shard, lens, fams):
    kw = dict(seed=seed, blocks_per_uarch=blocks,
              uarches=tuple(sorted(SIM_UARCHES)), shard_size=shard,
              min_len=lens[0], max_len=lens[1])
    if fams is not None:
        kw["family_mix"] = tuple((f, 1.0 + i) for i, f in enumerate(fams))
    got = P.generate_corpus(tmp_path / "port", P.CorpusSpec(**kw))
    want = R.generate_corpus(tmp_path / "ref", R.CorpusSpec(**kw))
    assert got == want
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "ref")
    assert len(files) == 1 + len(got["shards"])
    assert {s["uarch"] for s in got["shards"]} == set(SIM_UARCHES)


def test_spec_defaults_and_families_match_reference():
    assert P.FAMILIES == R.FAMILIES
    assert P.CorpusSpec().as_dict() == R.CorpusSpec().as_dict()
    assert P.CorpusSpec().blocks_per_uarch == 10_000
    assert P.CorpusSpec(**SPEC).as_dict() == R.CorpusSpec(**SPEC).as_dict()
    for ua in sorted(SIM_UARCHES):
        from repro.corpus.generate import variant_pool as r_pool
        from repro_torch.corpus.generate import variant_pool as p_pool
        assert p_pool(ua, TEST_ISA) == r_pool(ua, R_ISA)


def test_unknown_family_raises_like_reference():
    bad = dict(SPEC, family_mix=(("dep_chain", 1.0), ("bogus", 1.0)))
    with pytest.raises(ValueError, match="unknown corpus families"):
        P.generate_blocks("sim_skl", P.CorpusSpec(**bad))
    with pytest.raises(ValueError, match="unknown corpus families"):
        R.generate_blocks("sim_skl", R.CorpusSpec(**bad))


# -- scoring -----------------------------------------------------------------

def _pairs(seed, n):
    """Predicted/measured cycles with many ties and some zero measured."""
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 12, n).astype(np.float64) * 0.5
    pred = true + rng.integers(-3, 4, n) * 0.25
    pred[rng.random(n) < 0.2] = 2.0
    return pred, true


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 37), (3, 300),
                                    (4, 1031)])
def test_score_math_equals_reference(seed, n):
    pred, true = _pairs(seed, n)
    assert P.mape(pred, true) == R.mape(pred, true)
    for chunk in (7, 256, 2048):
        assert P.kendall_tau(pred, true, chunk=chunk) == \
            R.kendall_tau(pred, true, chunk=chunk)
    assert P.kendall_tau(pred, true) == R.kendall_tau(pred, true)
    assert P.error_buckets(pred, true) == R.error_buckets(pred, true)
    fams = [("a", "b", "c")[i % 3] for i in range(n)]
    recs = [{"id": f"x-{i}", "family": f, "block": "CMC"}
            for i, f in enumerate(fams)]
    assert P.score_pairs(pred, true, families=fams, records=recs,
                         worst_k=4) == \
        R.score_pairs(pred, true, families=fams, records=recs, worst_k=4)


def test_score_math_edge_cases_equal_reference():
    for pred, true in (([1, 2], [0, 0]), ([0, 0], [0, 0]), ([3, 3], [3, 3]),
                       ([1, 2, 3], [3, 2, 1]), ([5], [4]), ([], [])):
        assert P.mape(pred, true) == R.mape(pred, true)
        assert P.kendall_tau(pred, true) == R.kendall_tau(pred, true)
        assert P.error_buckets(pred, true) == R.error_buckets(pred, true)
    with pytest.raises(ValueError, match="shape mismatch"):
        P.mape([1, 2], [1])
    with pytest.raises(ValueError, match="shape mismatch"):
        P.kendall_tau([1, 2], [1])


def test_score_results_and_report_equal_reference():
    pred, true = _pairs(9, 90)
    rows = [{"id": f"sim_skl-{i:06d}", "family": ("mixed", "idiom")[i % 2],
             "block": "CMC", "predicted": float(p), "measured": float(t)}
            for i, (p, t) in enumerate(zip(pred, true))]
    results = {"corpus_id": "ab" * 32, "spec": {"seed": 1},
               "uarches": {"sim_skl": rows, "sim_hsw": rows[:40]},
               "wave_stats": {"waves": 2, "blocks": 130,
                              "mean_wave_width": 65.0,
                              "max_wave_width": 90},
               "engine_stats": {"requests": 130, "executions": 99}}
    assert _artifact(results) == _ref_artifact(results)
    rep = P.score_results(results, worst_k=3)
    assert P.format_report(rep) == R.format_report(
        R.score_results(results, worst_k=3))


# -- evaluation --------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("corpus")
    R.generate_corpus(out, R.CorpusSpec(**SPEC))
    return out


@pytest.fixture(scope="module")
def ref_results(corpus_dir, tmp_path_factory):
    """The reference's whole path: characterization inside evaluate_corpus,
    then ground truth and prediction on its ``numpy`` backend."""
    return R.evaluate_corpus(corpus_dir, backend="numpy", wave_width=32,
                             out_dir=tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def corpus_models(corpus_dir, tmp_path_factory):
    """A model over exactly the variants the corpus uses, as XML in a
    model directory; loaded by each package from the same bytes."""
    man = load_manifest(corpus_dir)
    used = sorted({ins.spec for s in man["shards"]
                   for r in read_shard(corpus_dir, s)
                   for ins in parse_block(r["block"])})
    model = characterize(SimMachine(SIM_SKL, TEST_ISA, **CPU), TEST_ISA,
                         used)
    xml = model_io.to_xml(model, TEST_ISA)
    out = tmp_path_factory.mktemp("models")
    (out / "sim_skl.xml").write_text(xml)
    return out, model_io.load_xml(xml), r_io.load_xml(xml)


@pytest.mark.parametrize("predict_backend", ["torch", "numpy"])
def test_artifact_byte_identical_to_reference(corpus_dir, ref_results,
                                              tmp_path, predict_backend):
    got = P.evaluate_corpus(corpus_dir, wave_width=32,
                            predict_backend=predict_backend,
                            out_dir=tmp_path, **CPU)
    assert _artifact(got) == _ref_artifact(ref_results)
    assert got["wave_stats"]["max_wave_width"] >= 32
    assert got["engine_stats"]["machine_runs"] > 0
    assert got["engine_stats"]["quarantined"] == 0


def test_result_files_byte_identical_to_reference(corpus_dir, corpus_models,
                                                  tmp_path):
    _, p_model, r_model = corpus_models
    P.evaluate_corpus(corpus_dir, models={"sim_skl": p_model},
                      wave_width=20, out_dir=tmp_path / "p",
                      predict_backend="numpy", **CPU)
    R.evaluate_corpus(corpus_dir, models={"sim_skl": r_model},
                      backend="numpy", wave_width=20,
                      out_dir=tmp_path / "r")
    files = _files(tmp_path / "p")
    assert files == _files(tmp_path / "r")
    assert len(files) == len(load_manifest(corpus_dir)["shards"])


def test_resume_skips_done_shards(corpus_dir, corpus_models, ref_served,
                                  tmp_path):
    models = {"sim_skl": corpus_models[1]}
    first = P.evaluate_corpus(corpus_dir, models=models, wave_width=32,
                              out_dir=tmp_path, **CPU,
                              predict_backend="torch")
    assert _artifact(first) == ref_served
    again = P.evaluate_corpus(corpus_dir, models=models, wave_width=32,
                              out_dir=tmp_path, **CPU,
                              predict_backend="torch")
    assert again["wave_stats"]["waves"] == 0      # all shards resumed
    assert again["engine_stats"] == {}
    assert again["uarches"] == first["uarches"]
    scores = json.dumps(P.score_results(again)["uarches"], sort_keys=True)
    assert scores == json.dumps(json.loads(ref_served)["uarches"],
                                sort_keys=True)
    # one shard's results gone: only that shard is measured again
    man = load_manifest(corpus_dir)
    (tmp_path / (man["shards"][1]["name"] + ".json")).unlink()
    part = P.evaluate_corpus(corpus_dir, models=models, wave_width=32,
                             out_dir=tmp_path, **CPU,
                             predict_backend="torch")
    assert part["wave_stats"] == {"waves": 1, "blocks": SPEC["shard_size"],
                                  "mean_wave_width": 16.0,
                                  "max_wave_width": 16}
    assert part["uarches"] == first["uarches"]


def test_no_resume_and_uarch_filter(corpus_dir, corpus_models, tmp_path):
    models = {"sim_skl": corpus_models[1]}
    P.evaluate_corpus(corpus_dir, models=models, wave_width=32,
                      out_dir=tmp_path, predict_backend="numpy", **CPU)
    cold = P.evaluate_corpus(corpus_dir, models=models, wave_width=32,
                             out_dir=tmp_path, predict_backend="numpy",
                             resume=False, **CPU)
    assert cold["wave_stats"]["waves"] == 2
    none = P.evaluate_corpus(corpus_dir, uarches=["sim_hsw"],
                             out_dir=tmp_path, **CPU)
    assert none["uarches"] == {} and none["wave_stats"]["waves"] == 0


def test_evaluate_asks_for_the_card_by_default(corpus_dir, tmp_path,
                                               monkeypatch):
    """Without a device evaluate_corpus places its waves and its predictor on
    ``cuda:0``; on a host without a card that raises and nothing runs on
    the CPU instead."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    monkeypatch.delenv("REPRO_SIM_DEVICES", raising=False)
    monkeypatch.delenv("REPRO_SIM_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_PREDICT_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.evaluate_corpus(corpus_dir, wave_width=32, out_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.evaluate_corpus(corpus_dir, wave_width=32, out_dir=tmp_path,
                          backend="torch", predict_backend="torch")
    with pytest.raises(ValueError, match="CUDA device"):
        P.evaluate_corpus(corpus_dir, wave_width=32, out_dir=tmp_path,
                          backend="torch", device="cpu",
                          models={"sim_skl": PerfModel("sim_skl")})
    assert not list(tmp_path.iterdir())       # no shard was finished


def test_predict_fn_width_mismatch_raises(corpus_dir, corpus_models,
                                          tmp_path):
    with pytest.raises(ValueError, match="predict_fn returned"):
        P.evaluate_corpus(corpus_dir, models={"sim_skl": corpus_models[1]},
                          wave_width=32, out_dir=tmp_path,
                          predict_backend="numpy",
                          predict_fn=lambda ua, blocks: [1.0], **CPU)


# -- served path -------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_served(corpus_dir, corpus_models, tmp_path_factory):
    _, _, r_model = corpus_models
    return _ref_artifact(R.evaluate_corpus(
        corpus_dir, models={"sim_skl": r_model}, backend="numpy",
        wave_width=32, out_dir=tmp_path_factory.mktemp("ref_served")))


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_served_artifact_byte_identical(corpus_dir, corpus_models,
                                        ref_served, tmp_path, wire):
    """``client_predict_fn`` over the port server, the port client over
    the reference server and the reference client over the port server:
    each gives the reference's in-process artifact, byte for byte."""
    models_dir, p_model, _ = corpus_models

    def run(name, predict_fn):
        return _artifact(P.evaluate_corpus(
            corpus_dir, models={"sim_skl": p_model}, wave_width=32,
            out_dir=tmp_path / name, predict_backend="numpy",
            predict_fn=predict_fn, **CPU))

    assert run("inproc", None) == ref_served
    svc = PredictionService(ModelRegistry(models_dir),
                            predict_backend="torch", predict_device="cpu")
    with PredictionServer(svc) as server, \
            RServer(RService(RRegistry(models_dir))) as ref_server:
        with ServiceClient(server.host, server.port, wire=wire) as c:
            assert c.wire == wire
            assert run("port", P.client_predict_fn(c, shard_size=16)) \
                == ref_served
        with ServiceClient(ref_server.host, ref_server.port,
                           wire=wire) as c:
            assert run("port_to_ref", P.client_predict_fn(
                c, shard_size=16)) == ref_served
        with RClient(server.host, server.port, wire=wire) as rc:
            assert run("ref_to_port", R.client_predict_fn(
                rc, shard_size=16)) == ref_served
        st = svc.stats()["predictor"]
        assert st["device_fallbacks"] == 0


def test_served_missing_model_raises_typed(corpus_dir, corpus_models,
                                           tmp_path):
    """A shard the server cannot answer raises: corpus scoring needs every
    block."""
    from repro_torch.service.client import ServiceError
    models_dir, p_model, _ = corpus_models
    empty = tmp_path / "empty"
    empty.mkdir()
    svc = PredictionService(ModelRegistry(empty), predict_backend="numpy")
    with PredictionServer(svc) as server, \
            ServiceClient(server.host, server.port) as c:
        with pytest.raises(ServiceError):
            P.evaluate_corpus(corpus_dir, models={"sim_skl": p_model},
                              wave_width=32, out_dir=tmp_path / "r",
                              predict_backend="numpy",
                              predict_fn=P.client_predict_fn(c), **CPU)


# -- the corpus.shard_write fault site ----------------------------------------

@pytest.fixture
def no_plan():
    yield
    fplan.set_plan(None)


def test_shard_result_write_fault_warns_and_continues(tmp_path, no_plan):
    shard = {"name": "sim_skl-00000.jsonl", "sha256": "cafe"}
    rows = [{"id": 0, "family": "f", "block": "b",
             "predicted": 1.0, "measured": 1.0}]
    fplan.set_plan(FaultPlan.from_spec("corpus.shard_write:raise"))
    with pytest.warns(UserWarning, match="rows kept in memory"):
        _write_rows(tmp_path, shard, rows)
    assert _load_resumed(tmp_path, shard) is None  # cold resume
    # torn write: file lands but is rejected on resume, not trusted
    fplan.set_plan(FaultPlan.from_spec("corpus.shard_write:torn"))
    _write_rows(tmp_path, shard, rows)
    assert _load_resumed(tmp_path, shard) is None
    fplan.set_plan(None)
    _write_rows(tmp_path, shard, rows)
    assert _load_resumed(tmp_path, shard) == rows
    # the reference reads the port's result file back, and the bytes agree
    assert r_evaluate._load_resumed(tmp_path, shard) == rows


def test_corpus_shard_corruption_detected(tmp_path, no_plan):
    spec = P.CorpusSpec(uarches=("sim_skl",), blocks_per_uarch=16,
                        shard_size=8, seed=5)
    fplan.set_plan(FaultPlan.from_spec("corpus.shard_write:corrupt:"
                                       "match=.jsonl"))
    P.generate_corpus(tmp_path, spec)
    fplan.set_plan(None)
    manifest = load_manifest(tmp_path)
    with pytest.raises(ValueError, match="does not match manifest"):
        for sh in manifest["shards"]:
            read_shard(tmp_path, sh)


def test_corpus_shard_write_raise_leaves_no_shard(tmp_path, no_plan):
    spec = P.CorpusSpec(uarches=("sim_skl",), blocks_per_uarch=16,
                        shard_size=8, seed=5)
    fplan.set_plan(FaultPlan.from_spec("corpus.shard_write:raise"))
    with pytest.raises(fplan.InjectedFault):
        P.generate_corpus(tmp_path, spec)
    assert not (tmp_path / "manifest.json").exists()
    assert not list((tmp_path / "shards").glob("*.jsonl"))


def test_load_manifest_missing_names_the_port_cli(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match="python -m repro_torch.corpus generate"):
        load_manifest(tmp_path)
