"""The port's entry scripts against the reference's, each in a process of
its own.

* ``examples/quickstart_torch.py`` (``REPRO_SIM_BACKEND=torch
  REPRO_SIM_DEVICES=cpu``) prints what ``examples/quickstart.py`` prints,
  line for line, and writes the same model XML.
* ``examples/export_models_torch.py`` writes model XML byte-identical to
  ``examples/export_models.py``'s and JSON equal with ``run_seconds`` set
  to 0.  The two measurement caches hold the same entries (the bytes
  differ only in the order of the port keys inside an entry), and a warm
  start of either script from the other's cache replays every experiment
  and exports the same XML and JSON.  Every process runs under one
  string-hash seed: the JSON's LP throughputs follow, in their last bit,
  the order in which a frozenset of port names iterates, in the reference
  as in the port.
* ``scripts/analyze_torch.py --corpus-report`` prints what
  ``scripts/analyze.py --corpus-report`` prints.
* ``examples/serve_batched_torch.py --device cpu`` runs at its reduced
  default dims and prints the reference script's model and memory-floor
  lines (its times and token ids are its own: other weights, another
  device).

The port's scripts run with ``jax``, ``jaxlib`` and ``repro`` poisoned in
``sys.modules``.  Both export scripts write next to themselves
(``experiments/models`` beside their ``examples/``), so each runs as a
copy under the test's temporary directory and never writes into the
repository."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import repro.corpus as R

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
UARCHES = ("sim_hsw", "sim_skl", "sim_snb")
POISON = ("import runpy, sys\n"
          "for name in ('jax', 'jaxlib', 'repro'):\n"
          "    sys.modules[name] = None\n"
          "sys.argv = sys.argv[1:]\n"
          "runpy.run_path(sys.argv[0], run_name='__main__')\n")
CPU_ENV = {"REPRO_SIM_BACKEND": "torch", "REPRO_SIM_DEVICES": "cpu",
           "REPRO_PREDICT_BACKEND": "numpy"}


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_")}
    # one string-hash seed for every process: a model's JSON holds LP
    # results whose last bit follows the iteration order of a frozenset of
    # port names (the reference's core/lp.py:_scipy_lp)
    env.update(PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", PYTHONHASHSEED="0",
               **extra)
    return env


def _run_ref(script, *args, **env):
    proc = subprocess.run([sys.executable, str(script), *map(str, args)],
                          env=_env(**env), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _run_port(script, *args, **env):
    proc = subprocess.run(
        [sys.executable, "-c", POISON, str(script), *map(str, args)],
        env=_env(**CPU_ENV, **env), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _copy(script, root):
    """``script`` under ``root/examples/``, so that it writes under
    ``root``."""
    (root / "examples").mkdir(parents=True, exist_ok=True)
    return Path(shutil.copy(ROOT / script, root / "examples"))


def test_quickstart_prints_the_reference_lines(tmp_path):
    # the reference writes its model to a fixed /tmp path; its copy here
    # writes where the port's script does under TMPDIR=tmp_path
    out = tmp_path / "quickstart_model.xml"
    text = (ROOT / "examples" / "quickstart.py").read_text()
    assert text.count('Path("/tmp/quickstart_model.xml")') == 1
    ref_script = tmp_path / "ref" / "quickstart.py"
    ref_script.parent.mkdir()
    ref_script.write_text(text.replace('Path("/tmp/quickstart_model.xml")',
                                       f"Path({str(out)!r})"))
    want = _run_ref(ref_script)
    want_xml = out.read_bytes()
    out.unlink()
    got = _run_port(ROOT / "examples" / "quickstart_torch.py",
                    TMPDIR=str(tmp_path))
    assert got.splitlines() == want.splitlines()
    assert out.read_bytes() == want_xml
    assert "machine:   3.00 cyc/iter" in got


def _exported(root):
    models = root / "experiments" / "models"
    xml = {ua: (models / f"{ua}.xml").read_bytes() for ua in UARCHES}
    js = {}
    for ua in UARCHES:
        d = json.loads((models / f"{ua}.json").read_text())
        d["run_seconds"] = 0
        js[ua] = d
    cache = {ua: json.loads((models / "cache" / f"{ua}.meas.json")
                            .read_text()) for ua in UARCHES}
    return xml, js, cache


def _hit_rates(stdout):
    return [line.rsplit("cache hit rate ", 1)[1].rstrip(")")
            for line in stdout.splitlines() if "cache hit rate" in line]


def test_export_models_equals_reference_and_shares_its_cache(tmp_path):
    ref = _copy("examples/export_models.py", tmp_path / "ref")
    port = _copy("examples/export_models_torch.py", tmp_path / "port")
    _run_ref(ref)
    out = _run_port(port)
    want_xml, want_json, want_cache = _exported(tmp_path / "ref")
    xml, js, cache = _exported(tmp_path / "port")
    assert xml == want_xml
    assert js == want_json
    # the same entries under the same keys, in the same order; only the
    # port keys inside an entry come in another order
    assert cache == want_cache
    assert [list(c["entries"]) for c in cache.values()] == \
        [list(c["entries"]) for c in want_cache.values()]
    assert _hit_rates(out) and "100.0%" not in _hit_rates(out)
    # a warm start from the other package's cache replays everything
    for src, script, run in ((tmp_path / "ref", "export_models_torch.py",
                              _run_port),
                             (tmp_path / "port", "export_models.py",
                              _run_ref)):
        warm = tmp_path / f"warm_{script}"
        shutil.copytree(src / "experiments" / "models" / "cache",
                        warm / "experiments" / "models" / "cache")
        stdout = run(_copy(f"examples/{script}", warm))
        assert _hit_rates(stdout) == ["100.0%"] * len(UARCHES), stdout
        assert _exported(warm)[:2] == (want_xml, want_json)


def test_corpus_report_prints_the_reference_tables(tmp_path):
    rows = [{"id": f"sim_skl-{i:06d}", "family": ("mixed", "idiom")[i % 2],
             "block": "CMC", "predicted": 1.0 + (i % 5) * 0.25,
             "measured": 1.0 + (i % 3) * 0.5} for i in range(40)]
    results = {"corpus_id": "cd" * 32, "spec": {"seed": 3},
               "uarches": {"sim_skl": rows, "sim_snb": rows[:17]},
               "wave_stats": {"waves": 1, "blocks": 57,
                              "mean_wave_width": 57.0, "max_wave_width": 57},
               "engine_stats": {"requests": 57}}
    artifact = tmp_path / "corpus_accuracy.json"
    artifact.write_text(json.dumps(R.score_results(results), sort_keys=True,
                                   indent=1))
    outs = []
    for extra in ((), ("--json",)):
        want = _run_ref(ROOT / "scripts" / "analyze.py", "--corpus-report",
                        artifact, *extra)
        got = _run_port(ROOT / "scripts" / "analyze_torch.py",
                        "--corpus-report", artifact, *extra)
        assert got == want
        outs.append(got)
    assert "sim_skl by family:" in outs[0]
    assert json.loads(outs[1]) == json.loads(artifact.read_text())


def test_analyze_without_a_block_names_the_corpus_report():
    proc = subprocess.run(
        [sys.executable, "-c", POISON,
         str(ROOT / "scripts" / "analyze_torch.py")],
        env=_env(**CPU_ENV), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "--corpus-report" in proc.stderr


def test_serve_batched_prints_the_reference_memory_floor():
    want = _run_ref(ROOT / "examples" / "serve_batched.py").splitlines()
    got = _run_port(ROOT / "examples" / "serve_batched_torch.py",
                    "--device", "cpu").splitlines()
    assert len(got) == len(want) == 5
    for g, w, head in zip(got, want, ("model:", "prefill: 8x128 tokens in ",
                                      "decode: 63 steps x8 in ",
                                      "memory floor per decode step: ",
                                      "sample continuation token ids: ")):
        assert g.startswith(head) and w.startswith(head), (g, w)
    assert got[0] == want[0]
    assert got[3] == want[3]
    ids = got[4].split(": ", 1)[1]
    assert len(json.loads(ids)) == 16
