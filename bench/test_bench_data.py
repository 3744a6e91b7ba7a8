"""The harness is driven by data: a copy of ``bench/`` with one more
workload file and one more metric reader runs the new cell and reports
the new metric, with no file that was there changed.  The result line has
the contract's keys, and every name and unit of ``BENCHMARK.json`` its
characters."""
import hashlib
import json
import re
import shutil
import time

from bench import smoke

smoke.program_path()

from bench import harness  # noqa: E402

ROOT = smoke.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    work = json.loads((tmp_path / "bench/workloads/"
                       "mamba2-2.7b.prefill_4k.json").read_text())
    work["traffic"] = {**work["traffic"], "batch": 2, "prompt_len": 256}
    new = "mamba2-2.7b.prefill_256"
    (tmp_path / f"bench/workloads/{new}.json").write_text(json.dumps(work))
    # found by its stem: one reader for ``batch_ms_p50.<any suffix>``
    (tmp_path / "bench/metrics/batch_ms_p50.py").write_text(
        "import statistics\n\n\ndef read(ctx):\n"
        "    if ctx['kind'] != 'prefill':\n        return None\n"
        "    return 1e3 * statistics.median(ctx['window']['latencies_s'])\n")
    spec["workloads"].append({"name": new, "config": "mamba2-2.7b",
                              "traffic": "prefill_256", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "mamba2-2.7b.prefill_4k" in m["workloads"]:
            m["workloads"].append(new)
    spec["per_layer"].append({
        "name": "batch_ms_p50.prefill", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "entry: train/serve.py",
        "moves": "prefill_tokens_per_s", "workloads": [new]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    kw = smoke.kwargs(new, tmp_path)
    for traced in (False, True):
        res, lines = harness.run(new, 2**31 + 21, 0.3, traced,
                                 t_start=time.perf_counter(), **kw)
        assert list(res) == KEYS + (["breakdown"] if traced else []) + [
            "checks"]
        assert res["correct"] is True, lines
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"} \
            if traced else True
        assert lines[-len(res["checks"]):] == [
            f"check {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in res["checks"].items()]
        for m, v in res["metrics"].items():
            assert isinstance(v["value"], float) and UNIT.match(v["unit"])
    assert "batch_ms_p50.prefill" in res["metrics"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
    after = _digests(tmp_path)
    changed = [p for p, d in before.items() if after[p] != d]
    assert changed == [__import__("pathlib").Path("BENCHMARK.json")]


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert spec["command"][1].startswith(spec["paths"][0] + "/")
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"]
        names.add(c["name"])
    used = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / f"bench/workloads/{w['name']}.json").is_file()
        used.add(w["config"])
        names.add(w["name"])
        names.add(w["traffic"])
    assert used == {c["name"] for c in spec["configs"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
        assert harness.metric_reader(m["name"]).read
        names.add(m["name"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert all(NAME.match(n) for n in names), names
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
