"""The port's serving tier (``repro_torch.service``) against the
reference's, over one model directory.

* The registry discovers, validates (stale fingerprints are refused) and
  hot-reloads exported models as the reference's does.
* The port's protocol encodes every frame to the reference's bytes and
  decodes the reference's frames.
* The port server (``predict_backend="torch", predict_device="cpu"``) and
  the reference server answer the same requests with byte-identical
  payloads, trace ids dropped as ``tests/test_wire_binary.py``'s
  ``_canon`` drops them, on the JSON and binary wires, error envelopes
  included; the port client talks to the reference server and the
  reference client to the port server.
* health / drain, the typed ``Overloaded`` shed and malformed frames
  behave as in the reference's tests.

The model directory holds XML from the port's ``Campaign`` over the
reference tests' ``NAMES`` subset, byte-identical to the reference's."""
import json
import os
import random
import socket
import threading

import pytest

from repro.core import model_io as r_io
from repro.core.engine import Campaign as RCampaign
from repro.core.isa import TEST_ISA as R_ISA
from repro.core.simulator import SimMachine as RSim
from repro.core.uarch import SIM_UARCHES as R_UARCHES
from repro.service import protocol as r_protocol
from repro.service.client import ServiceClient as RClient
from repro.service.registry import ModelRegistry as RRegistry
from repro.service.server import PredictionServer as RServer
from repro.service.server import PredictionService as RService
from repro_torch.core import model_io
from repro_torch.core.engine import Campaign
from repro_torch.core.isa import TEST_ISA
from repro_torch.core.predictor import predict
from repro_torch.core.simulator import Instr, SimMachine
from repro_torch.core.uarch import SIM_UARCHES
from repro_torch.service import protocol
from repro_torch.service.client import (ServiceClient, ServiceError,
                                        ServiceOverloaded,
                                        ServiceUnavailable, local_service)
from repro_torch.service.loadgen import run_load
from repro_torch.service.registry import (ModelNotFoundError, ModelRegistry,
                                          StaleModelError)
from repro_torch.service.server import (AdmissionController,
                                        PredictionServer, PredictionService,
                                        ShardedLRU, ThreadedPredictionServer,
                                        start_server)
from repro_torch.service.workload import random_blocks

NAMES = ["ADD_R64_R64", "IMUL_R64_R64", "MUL_R64", "ADC_R64_R64", "CMC",
         "TEST_R64_R64", "SHLD_R64_R64_I8", "MOVQ2DQ_X_X", "AESDEC_X_X",
         "PSHUFD_X_X", "PADDD_X_X", "MOV_R64_M64"]
UARCHES = sorted(SIM_UARCHES)
CPU = {"predict_backend": "torch", "predict_device": "cpu"}
BLOCK = "IMUL_R64_R64 op1=R0 op2=R1\nADD_R64_R64 op1=R0 op2=R2"
BAD = [Instr("DIV_R64", {"op1": "R0", "op2": "R1", "hi": "R2"})]


@pytest.fixture(scope="module")
def models():
    port = Campaign(instr_names=NAMES).run(
        [SimMachine(ua, TEST_ISA, backend="torch", device="cpu")
         for ua in SIM_UARCHES.values()], TEST_ISA).models
    ref = RCampaign(instr_names=NAMES).run(
        [RSim(ua, R_ISA) for ua in R_UARCHES.values()], R_ISA).models
    for n in UARCHES:
        assert model_io.to_xml(port[n], TEST_ISA) == \
            r_io.to_xml(ref[n], R_ISA)
    return port


@pytest.fixture(scope="module")
def model_dir(models, tmp_path_factory):
    out = tmp_path_factory.mktemp("models")
    for name, model in models.items():
        (out / f"{name}.xml").write_text(model_io.to_xml(model, TEST_ISA))
    return out


def _canon(envs):
    return json.dumps([{k: v for k, v in e.items() if k != "trace_id"}
                       for e in envs], sort_keys=True)


def _waves(models):
    """Per uarch: random blocks with an uncharacterized one among them, at
    a width that takes the device path (>= 32 closed-form rows)."""
    out = {}
    for ua in UARCHES:
        blocks = random_blocks(models[ua], TEST_ISA, 48, seed=29, max_len=8)
        blocks.insert(5, BAD)
        out[ua] = blocks
    return out


def _session(client, waves):
    """Everything one client asks, as canonical JSON per request."""
    out = [json.dumps(client.uarches())]
    for ua, blocks in waves.items():
        out.append(_canon(client.predict_batch(ua, blocks)))
        out.append(_canon([client.predict(ua, BLOCK, raw=True)]))
        out.append(json.dumps(client.validate(ua, "CMC\nDIV_R64 op1=R0 "
                                              "op2=R1 hi=R2")))
    out.append(_canon(client.predict_batch("sim_icl", [[Instr("CMC", {})]])))
    out.append(_canon([client.predict("sim_icl", "CMC", raw=True)]))
    shards, summary = client.predict_corpus("sim_skl",
                                            [waves["sim_skl"][:7], [BAD]])
    out.append(json.dumps([json.loads(_canon(s)) for s in shards]
                          + [summary], sort_keys=True))
    return out


# ------------------------------------------------------------- registry

def test_registry_serves_all_sim_uarches(model_dir, models):
    reg = ModelRegistry(model_dir)
    ref = RRegistry(model_dir)
    assert reg.uarches() == ref.uarches() == UARCHES
    for name in UARCHES:
        h = reg.get(name)
        assert h.model.fingerprint == models[name].fingerprint == \
            ref.get(name).model.fingerprint
        assert set(h.model.instructions) == set(NAMES)
    v = reg.get("sim_skl").version
    assert reg.get("sim_skl").version == v and reg.hot_reloads == 0
    with pytest.raises(ModelNotFoundError) as ei:
        reg.get("sim_icl")
    assert "sim_skl" in str(ei.value)


def test_registry_rejects_stale_fingerprint(model_dir):
    reg = ModelRegistry(model_dir,
                        expected_fingerprints={"sim_skl": "deadbeef"})
    with pytest.raises(StaleModelError):
        reg.get("sim_skl")
    reg2 = ModelRegistry(model_dir, validate=False,
                         expected_fingerprints={"sim_skl": "deadbeef"})
    assert reg2.get("sim_skl").model.uarch == "sim_skl"


def test_registry_hot_reload(model_dir, models):
    reg = ModelRegistry(model_dir)
    h1 = reg.get("sim_hsw")
    pruned = model_io.load_xml(model_io.to_xml(models["sim_hsw"], TEST_ISA))
    del pruned.instructions["CMC"]
    path = model_dir / "sim_hsw.xml"
    path.write_text(model_io.to_xml(pruned, TEST_ISA))
    os.utime(path, ns=(h1.mtime_ns + 10**9, h1.mtime_ns + 10**9))
    h2 = reg.get("sim_hsw")
    assert h2.version > h1.version and reg.hot_reloads == 1
    assert "CMC" not in h2.model.instructions
    path.write_text(model_io.to_xml(models["sim_hsw"], TEST_ISA))


# ------------------------------------------------------------- protocol

def _random_value(rng, depth=0):
    kinds = ["none", "bool", "int", "float", "str", "bytes"]
    if depth < 3:
        kinds += ["list", "dict"]
    k = rng.choice(kinds)
    if k == "none":
        return None
    if k == "bool":
        return rng.random() < 0.5
    if k == "int":
        return rng.choice([0, -1, rng.randrange(-2**40, 2**40), 2**63 - 1])
    if k == "float":
        return rng.choice([0.0, -0.0, 1.5, float("inf"),
                           rng.uniform(-1e12, 1e12)])
    if k == "str":
        return "".join(rng.choice("abπ∞\n\"\\x") for _ in range(
            rng.randrange(8)))
    if k == "bytes":
        return bytes(rng.randrange(256) for _ in range(rng.randrange(8)))
    if k == "list":
        return [_random_value(rng, depth + 1) for _ in range(rng.randrange(4))]
    return {f"k{j}": _random_value(rng, depth + 1)
            for j in range(rng.randrange(4))}


def test_value_codec_matches_the_reference():
    rng = random.Random(7)
    for _ in range(300):
        v = _random_value(rng)
        raw = protocol.pack_value(v)
        assert raw == r_protocol.pack_value(v)
        assert protocol.unpack_value(raw) == v


def test_frame_codecs_match_the_reference(models):
    rng = random.Random(13)
    model = models["sim_skl"]
    for trial in range(20):
        blocks = random_blocks(model, TEST_ISA, rng.randrange(1, 12),
                               seed=trial)
        packed = tuple(protocol.instrs_to_packed(b) for b in blocks)
        budget = rng.choice([0, 1, 2500, 10**7])
        payload = protocol.encode_predict_batch("sim_skl", packed, budget)
        assert payload == r_protocol.encode_predict_batch("sim_skl", packed,
                                                          budget)
        assert protocol.decode_predict_batch(payload) == \
            ("sim_skl", budget, packed)
        for b, pb in zip(blocks, packed):
            assert protocol.packed_to_instrs(pb) == b
    envs = [{"ok": True, "uarch": "sim_skl",
             "result": protocol.prediction_to_dict(predict(model, TEST_ISA,
                                                           b))}
            for b in random_blocks(model, TEST_ISA, 6, seed=3)]
    err = {"ok": False, "error": {"type": "UnknownInstructionError",
                                  "message": "nope", "missing": ["X"]}}
    names = sorted({p for e in envs for p in e["result"]["port_pressure"]})
    pidx = {p: i for i, p in enumerate(names)}
    chunks = [protocol.encode_pred_chunk(e, pidx) for e in envs]
    assert chunks == [r_protocol.encode_pred_chunk(e, pidx) for e in envs]
    chunks.append(protocol.encode_error_chunk(err))
    payload = protocol.encode_predict_batch_resp("a" * 16, "sim_skl", names,
                                                 chunks)
    out = protocol.decode_predict_batch_resp(payload)
    assert out == r_protocol.decode_predict_batch_resp(payload)
    assert out[-1] == {**err, "trace_id": "a" * 16}
    text = protocol.format_block(blocks[0])
    assert text == r_protocol.format_block(
        r_protocol.parse_block(text, R_ISA))
    assert protocol.parse_block(text) == blocks[0]


# ----------------------------------------- the two servers, both wires

@pytest.mark.parametrize("wire", ["json", "auto"])
def test_port_server_equals_reference_server(model_dir, models, wire):
    waves = _waves(models)
    svc = PredictionService(ModelRegistry(model_dir), **CPU)
    ref_svc = RService(RRegistry(model_dir))
    with PredictionServer(svc) as server, RServer(ref_svc) as ref_server:
        with ServiceClient(server.host, server.port, wire=wire) as c, \
                RClient(ref_server.host, ref_server.port, wire=wire) as rc:
            assert c.wire == rc.wire == ("json" if wire == "json"
                                         else "binary")
            for _ in range(2):          # cold, then from the caches
                assert _session(c, waves) == _session(rc, waves)
        st = svc.stats()["predictor"]
        assert st["backend"] == "torch"
        assert st["device_waves"] >= len(UARCHES)
        assert st["device_fallbacks"] == 0


@pytest.mark.parametrize("wire", ["json", "auto"])
def test_clients_cross_the_packages(model_dir, models, wire):
    """The port client against the reference server, and the reference
    client against the port server: the same answers as either pair of
    one package."""
    waves = _waves(models)
    with PredictionServer(PredictionService(ModelRegistry(model_dir),
                                            **CPU)) as server, \
            RServer(RService(RRegistry(model_dir))) as ref_server:
        with ServiceClient(server.host, server.port, wire=wire) as own:
            want = _session(own, waves)
        with ServiceClient(ref_server.host, ref_server.port,
                           wire=wire) as c:
            assert _session(c, waves) == want
        with RClient(server.host, server.port, wire=wire) as rc:
            assert _session(rc, waves) == want


def test_served_predictions_identical_to_in_memory(model_dir, models):
    with local_service(model_dir, **CPU) as client:
        assert client.wire == "binary"
        for ua in UARCHES:
            blocks = random_blocks(models[ua], TEST_ISA, 40, seed=23)
            for code, env in zip(blocks, client.predict_batch(ua, blocks)):
                assert env["ok"], env
                assert env["result"] == protocol.prediction_to_dict(
                    predict(models[ua], TEST_ISA, code))
        res = client.predict("sim_skl", "IMUL_R64_R64 op1=R0 op2=R1")
        assert res["cycles"] == pytest.approx(3.0)
        assert res["bottleneck"] == "latency"
        st = client.stats()
        assert st["predictor"]["device_waves"] >= len(UARCHES)
        assert st["predictor"]["device_compiles"] == len(UARCHES)


def test_service_default_is_the_card(model_dir):
    """Without a backend the service's predictors ask for the card: on a
    host without one each request comes back as a structured error."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    svc = PredictionService(ModelRegistry(model_dir), start=False)
    env = svc.predict_batch("sim_skl", [[Instr("CMC", {})]])[0]
    assert env["ok"] is False and "no CUDA device" in env["error"]["message"]
    svc.close()


# ----------------------------------------------- health, drain, shedding

def test_health_op(model_dir):
    with local_service(model_dir, **CPU) as client:
        h = client.health()
        assert h["status"] == "ok" and h["draining"] is False
        assert h["workers"]["alive"] == h["workers"]["configured"] > 0
        assert h["workers"]["crashed"] == 0
        assert h["queue_depth"] >= 0 and h["registry"]


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_drain_refuses_work_keeps_introspection(model_dir, wire):
    from repro_torch.service.client import ServiceDraining
    with local_service(model_dir, wire=wire, **CPU) as client:
        assert client.predict("sim_skl", BLOCK)["cycles"] > 0
        d = client.drain()
        assert d["draining"] is True and d["was_draining"] is False
        with pytest.raises(ServiceDraining) as ei:
            client.predict("sim_skl", BLOCK)
        assert ei.value.error["retry_after_ms"] > 0
        with pytest.raises(ServiceDraining):
            client.predict_batch("sim_skl", [BLOCK, BLOCK])
        with pytest.raises(ServiceDraining):
            client.predict_corpus("sim_skl", [[BLOCK]])
        assert client.ping()
        assert client.health()["status"] == "draining"
        assert client.stats() is not None
        assert client.drain()["was_draining"] is True


def test_admission_controller_sheds_bounded():
    ac = AdmissionController(workers=1, max_queue=0)
    assert ac.try_admit() is None
    assert ac.try_admit() == "queue_full"
    env = ac.overloaded_env("queue_full")
    assert env["error"]["type"] == "Overloaded"
    assert env["error"]["retry_after_ms"] > 0
    ac.release(0.002)
    assert ac.try_admit() is None
    st = ac.stats()
    assert st["shed_queue_full"] == 1 and st["admitted"] == 2
    ac2 = AdmissionController(workers=1, max_queue=10, budget_us=1.0)
    assert ac2.try_admit() is None and ac2.try_admit() is None
    assert ac2.try_admit() == "budget"


def test_server_sheds_typed_overloaded(model_dir):
    svc = PredictionService(ModelRegistry(model_dir), **CPU)
    with PredictionServer(svc, workers=1, max_queue=0) as server:
        shed = threading.Semaphore(0)
        errors = []

        def hammer(seed):
            rng = random.Random(seed)
            try:
                with ServiceClient(server.host, server.port,
                                   wire="json") as c:
                    for i in range(12):
                        blocks = [[Instr("IMUL_R64_R64",
                                         {"op1": f"R{rng.randrange(16)}",
                                          "op2": f"R{i}"})]
                                  for _ in range(40)]
                        try:
                            c.predict_batch("sim_skl", blocks)
                        except ServiceOverloaded as e:
                            assert e.error["reason"] == "queue_full"
                            shed.release()
            except Exception as e:  # pragma: no cover - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors
        adm = server.admission.stats()
        assert shed.acquire(blocking=False), adm
        assert adm["peak_inflight"] <= adm["workers"] + adm["max_queue"]
        with ServiceClient(server.host, server.port) as c:
            assert c.ping()


def test_malformed_frames_keep_connection(model_dir):
    with PredictionServer(PredictionService(ModelRegistry(model_dir),
                                            **CPU)) as server:
        sock = socket.create_connection((server.host, server.port),
                                        timeout=10)
        rfile = sock.makefile("rb")
        sock.sendall(protocol.hello_frame())
        assert protocol.read_frame(rfile)[0] == protocol.K_HELLO_ACK
        sock.sendall(protocol.frame(protocol.K_PREDICT_BATCH, b"\xff\xff"))
        env = protocol.unpack_value(protocol.read_frame(rfile)[1])
        assert env["error"]["type"] == "BinaryProtocolError"
        sock.sendall(protocol.frame(
            protocol.K_MSG, protocol.pack_value({"op": "ping"})))
        pong = protocol.unpack_value(protocol.read_frame(rfile)[1])
        assert pong["ok"] is True and pong["result"] == "pong"
        rfile.close()
        sock.close()
        assert server.wire_counts["bad_frames"] >= 1


def test_threaded_server_and_hot_reload(model_dir, models):
    blocks = random_blocks(models["sim_skl"], TEST_ISA, 8, seed=31)
    with ThreadedPredictionServer(PredictionService(
            ModelRegistry(model_dir), **CPU)) as server:
        with ServiceClient(server.host, server.port, wire="auto") as c:
            assert c.wire == "json"
            assert all(e["ok"] for e in c.predict_batch("sim_skl", blocks))
        with pytest.raises(ServiceUnavailable):
            ServiceClient(server.host, server.port, wire="binary")
    server = start_server(model_dir, **CPU)
    try:
        with ServiceClient(server.host, server.port, wire="binary") as c:
            first = _canon(c.predict_batch("sim_skl", blocks))
            path = model_dir / "sim_skl.xml"
            st = path.stat()
            path.write_text(model_io.to_xml(models["sim_skl"], TEST_ISA))
            os.utime(path, ns=(st.st_mtime_ns + 10**9,
                               st.st_mtime_ns + 10**9))
            assert "sim_skl" in c.reload("sim_skl")
            assert _canon(c.predict_batch("sim_skl", blocks)) == first
            assert c.stats()["registry"]["hot_reloads"] >= 1
            with pytest.raises(ServiceError):
                c.reload("sim_icl")
    finally:
        server.close()


def test_loadgen_against_the_port_server(model_dir, models):
    blocks = random_blocks(models["sim_skl"], TEST_ISA, 40, seed=3)
    server = start_server(model_dir, **CPU)
    try:
        row = run_load(server.host, server.port, "sim_skl", blocks, conns=2,
                       duration_s=0.3)
    finally:
        server.close()
    assert row["ok"] > 0 and row["errors"] == 0


def test_sharded_lru_semantics():
    lru = ShardedLRU(capacity=16, shards=4)
    for i in range(40):
        lru.put(("k", i), i)
    assert len(lru) <= 16 + 3
    got = lru.get_many([("k", i) for i in range(40)])
    assert sum(1 for g in got if g is not None) == len(lru)
    st = lru.stats()
    assert sum(s["hits"] for s in st["shards"]) == st["hits"]


def test_analyze_torch_script(model_dir, tmp_path, capsys, monkeypatch):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "analyze_torch.py"
    spec = importlib.util.spec_from_file_location("analyze_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    block = tmp_path / "block.txt"
    block.write_text(BLOCK + "\n")
    monkeypatch.setenv("REPRO_PREDICT_BACKEND", "numpy")
    assert mod.main([str(block), "--models", str(model_dir)]) == 0
    out = capsys.readouterr().out
    for ua in UARCHES:
        assert f"{ua}: " in out and "cycles/iter" in out
    assert mod.main([str(block), "--models", str(model_dir), "--json",
                     "--uarch", "sim_skl"]) == 0
    resp = json.loads(capsys.readouterr().out)
    assert resp["sim_skl"]["ok"] is True
    with pytest.raises(SystemExit):
        mod.main([str(block), "--trace-report", "x"])
