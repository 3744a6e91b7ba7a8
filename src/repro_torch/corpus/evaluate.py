"""Ground truth at corpus scale: fused mega-waves with per-shard resume.

The port of the reference package's ``repro/corpus/evaluate.py``.  For
each uarch in the corpus manifest this evaluator

1. builds the simulated machine on ``devices`` (``backend``, default
   ``REPRO_SIM_BACKEND``, selects the wave backend: the CUDA wave-dispatch
   kernel on the card, or its plain torch version) and characterizes
   exactly the variants the corpus uses — through the *same* measurement
   engine the ground-truth waves run on, so characterization experiments
   and corpus blocks share one content-addressed cache;
2. packs pending shards into **mega-waves**: shards accumulate until the
   wave-width target (default 2048 blocks) is met, then one
   ``BatchPredictor.simulate_batch`` call measures the whole wave — the
   engine dedups across shards and the batched backend executes the miss
   set device-resident — and one ``predict_batch`` call predicts it on
   the placement's first device (``predict_backend``, default
   ``REPRO_PREDICT_BACKEND``, else the port-bound CUDA kernel);
3. writes one result file per shard (atomic tmp+rename, keyed by the
   shard's manifest sha256) so a killed run resumes warm: shards with a
   matching result file are skipped entirely, and re-executed blocks hit
   the engine cache.

The placement defaults to ``REPRO_SIM_DEVICES``, else every card (at
least ``cuda:0``); asking for the card on a host without one raises,
nothing moves to the CPU unless the caller asks for it.

The returned results dict feeds
:func:`repro_torch.corpus.score.score_results`; ``wave_stats`` /
``engine_stats`` carry the fused-wave telemetry (``max_wave_width`` is the
acceptance probe that mega-waves actually formed).  Observability:
``corpus.evaluate`` → ``corpus.uarch`` → ``corpus.wave`` spans thread
through generation → simulate → score when ``REPRO_TRACE=1``.
"""
from __future__ import annotations

import json
import os
import warnings
from pathlib import Path

from repro_torch.core.characterize import characterize
from repro_torch.core.device_mesh import resolve_device, resolve_devices
from repro_torch.core.engine import as_engine
from repro_torch.core.isa import TEST_ISA
from repro_torch.core.simulator import SimMachine
from repro_torch.core.uarch import SIM_UARCHES
from repro_torch.corpus.store import load_manifest, read_shard
from repro_torch.faults import plan as faults
from repro_torch.faults.plan import InjectedFault
from repro_torch.obs import tracer as obs
from repro_torch.service.batch_predictor import BatchPredictor

RESULT_DIR = "results"


def _result_path(results_dir: Path, shard: dict) -> Path:
    return results_dir / (shard["name"] + ".json")


def _load_resumed(results_dir: Path, shard: dict):
    """Previously-written rows for this shard, or None if absent/stale."""
    path = _result_path(results_dir, shard)
    if not path.exists():
        return None
    try:
        rec = json.loads(path.read_text())
    except ValueError:
        return None  # torn write from a kill without the atomic rename
    if rec.get("sha256") != shard["sha256"]:
        return None  # corpus regenerated under the results dir
    return rec["rows"]


def _write_rows(results_dir: Path, shard: dict, rows: list) -> None:
    """Atomic per-shard result write.  Failures — including injected
    ``corpus.shard_write`` faults — degrade to a warning: the rows are
    already in memory for scoring, so evaluation completes and only warm
    resume for this shard is lost; a *torn* write (injected or from a
    kill) is rejected by ``_load_resumed`` on the next run."""
    path = _result_path(results_dir, shard)
    data = json.dumps({"shard": shard["name"],
                       "sha256": shard["sha256"], "rows": rows},
                      sort_keys=True, separators=(",", ":")).encode()
    try:
        if faults.active():
            faults.check("corpus.shard_write",
                         key=f"rows:{shard['name']}")
            data = faults.filter_bytes("corpus.shard_write", data,
                                       key=f"rows:{shard['name']}")
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_bytes(data)
        os.replace(tmp, path)
    except (OSError, InjectedFault) as e:
        warnings.warn(f"result write failed for shard {shard['name']} "
                      f"({type(e).__name__}: {e}); rows kept in memory, "
                      "resume for this shard is cold", stacklevel=2)


def _used_variants(shard_blocks) -> list[str]:
    return sorted({ins.spec for _, code in shard_blocks for ins in code})


class _WaveStats:
    def __init__(self):
        self.widths: list[int] = []

    def add(self, width: int) -> None:
        self.widths.append(width)

    def as_dict(self) -> dict:
        w = self.widths
        return {"waves": len(w), "blocks": sum(w),
                "mean_wave_width": round(sum(w) / max(1, len(w)), 2),
                "max_wave_width": max(w, default=0)}


def evaluate_corpus(corpus_dir, *, uarches=None, isa=None,
                    backend: str | None = None, device=None,
                    predict_backend: str | None = None,
                    wave_width: int = 2048, out_dir=None,
                    resume: bool = True, models: dict | None = None,
                    predict_fn=None, kernel_lock=None,
                    devices=None) -> dict:
    """Evaluate a generated corpus end to end; returns the results dict
    consumed by :func:`repro_torch.corpus.score.score_results`.

    ``devices`` places the machine's waves (an integer count, ``"all"``,
    device names or a sequence of devices: each wide enough chunk split
    into per-device lane blocks, see :mod:`repro_torch.core.device_mesh`;
    default ``REPRO_SIM_DEVICES``, else every card) and the predictor
    runs on its first device; ``device`` is the one-device spelling, and
    giving both raises.  ``backend`` is the machine's wave backend and
    ``predict_backend`` the predictor's (see
    :class:`~repro_torch.service.batch_predictor.BatchPredictor`).

    ``models`` optionally maps uarch name → :class:`PerfModel` (skip the
    characterization inside the evaluation); ``predict_fn(uarch, blocks)
    -> cycles`` overrides the in-process closed-form predictions — the served-corpus
    path passes a ``ServiceClient``-backed callable here, and the scores
    must come out byte-identical."""
    isa = isa if isa is not None else TEST_ISA
    if device is not None and devices is not None:
        raise ValueError("give device= or devices=, not both")
    devices = resolve_devices(devices if device is None else device)
    resolve_device(devices[0])   # a card asked for and none there raises
    manifest = load_manifest(corpus_dir)
    results_dir = Path(out_dir if out_dir is not None
                       else Path(corpus_dir) / RESULT_DIR)
    results_dir.mkdir(parents=True, exist_ok=True)
    wanted = set(uarches) if uarches is not None else None
    by_uarch: dict[str, list[dict]] = {}
    waves = _WaveStats()
    agg_engine: dict[str, int] = {}
    with obs.span("corpus.evaluate", corpus=manifest["corpus_id"][:12],
                  shards=len(manifest["shards"])):
        for ua in sorted({s["uarch"] for s in manifest["shards"]}):
            if wanted is not None and ua not in wanted:
                continue
            shards = [s for s in manifest["shards"] if s["uarch"] == ua]
            by_uarch[ua] = _evaluate_uarch(
                corpus_dir, ua, shards, isa, backend, devices,
                predict_backend, wave_width, results_dir, resume,
                (models or {}).get(ua), predict_fn, kernel_lock, waves,
                agg_engine)
    return {"corpus_id": manifest["corpus_id"], "spec": manifest["spec"],
            "uarches": by_uarch, "wave_stats": waves.as_dict(),
            "engine_stats": agg_engine}


def _evaluate_uarch(corpus_dir, ua, shards, isa, backend, devices,
                    predict_backend, wave_width, results_dir, resume, model,
                    predict_fn, kernel_lock, waves, agg_engine
                    ) -> list[dict]:
    from repro_torch.service.protocol import parse_block  # noqa: PLC0415

    rows_by_shard: dict[str, list] = {}
    pending = []  # (shard, records, blocks) awaiting ground truth
    for shard in shards:
        cached = _load_resumed(results_dir, shard) if resume else None
        if cached is not None:
            rows_by_shard[shard["name"]] = cached
            continue
        records = read_shard(corpus_dir, shard)
        blocks = [parse_block(r["block"]) for r in records]
        pending.append((shard, records, blocks))
    if pending:
        machine = SimMachine(SIM_UARCHES[ua], isa, backend=backend,
                             devices=devices)
        engine = as_engine(machine)
        with obs.span("corpus.uarch", uarch=ua, shards=len(pending)):
            if model is None:
                used = sorted({ins.spec for _, _, blocks in pending
                               for code in blocks for ins in code})
                # same engine as the ground-truth waves: the cache is
                # shared, so characterization experiments never rerun
                model = characterize(engine, isa, used)
            bp = BatchPredictor(model, isa, machine=machine,
                                backend=predict_backend, device=devices[0])
            stats0 = {k: v for k, v in engine.stats.as_dict().items()
                      if isinstance(v, (int, float)) and k != "hit_rate"}
            _run_waves(ua, bp, pending, wave_width, predict_fn,
                       kernel_lock, results_dir, rows_by_shard, waves)
            for k, v0 in stats0.items():
                d = engine.stats.as_dict()[k] - v0
                agg_engine[k] = agg_engine.get(k, 0) + d
    # submission order == manifest order, resumed or not
    return [row for shard in shards for row in rows_by_shard[shard["name"]]]


def _run_waves(ua, bp, pending, wave_width, predict_fn, kernel_lock,
               results_dir, rows_by_shard, waves) -> None:
    """Pack pending shards into ≥wave_width fused waves, measure + predict
    each wave once, then split results back per shard and persist."""
    group: list = []
    n_blocks = 0
    for item in pending:
        group.append(item)
        n_blocks += len(item[2])
        if n_blocks >= wave_width:
            _flush(ua, bp, group, predict_fn, kernel_lock, results_dir,
                   rows_by_shard, waves)
            group, n_blocks = [], 0
    if group:
        _flush(ua, bp, group, predict_fn, kernel_lock, results_dir,
               rows_by_shard, waves)


def client_predict_fn(client, *, shard_size: int = 512,
                      budget_us: float | None = None):
    """Adapt a :class:`repro_torch.service.client.ServiceClient` into the
    ``predict_fn(uarch, blocks) -> cycles`` hook of
    :func:`evaluate_corpus`: each wave is cut into ``shard_size`` shards
    and pushed through the streaming bulk ``predict_corpus`` op, so
    corpus scoring runs against a live server — and, because the server
    answers from the same closed-form predictor, comes out byte-identical
    to the in-process path. A shed or failed shard raises (typed
    ``Overloaded``/``ServiceError``): corpus scoring needs every block."""
    from repro_torch.service.client import ServiceError  # noqa: PLC0415
    from repro_torch.service.protocol import format_block  # noqa: PLC0415

    def predict(uarch: str, blocks) -> list[float]:
        texts = [format_block(code) for code in blocks]
        shards = [texts[i:i + shard_size]
                  for i in range(0, len(texts), shard_size)]
        per_shard, _summary = client.predict_corpus(uarch, shards,
                                                    budget_us=budget_us)
        cycles: list[float] = []
        for envs in per_shard:
            for env in envs:
                if not env.get("ok", True):
                    err = env.get("error") or {}
                    if err.get("type") == "Overloaded":
                        from repro_torch.service.client import (  # noqa
                            ServiceOverloaded)
                        raise ServiceOverloaded(err)
                    raise ServiceError(err)
                cycles.append(float(env["result"]["cycles"]))
        return cycles

    return predict


def _flush(ua, bp, group, predict_fn, kernel_lock, results_dir,
           rows_by_shard, waves) -> None:
    blocks = [code for _, _, shard_blocks in group for code in shard_blocks]
    waves.add(len(blocks))
    with obs.span("corpus.wave", uarch=ua, wave=len(blocks),
                  shards=len(group)):
        measured = bp.simulate_batch(blocks, kernel_lock=kernel_lock)
        if predict_fn is not None:
            predicted = list(predict_fn(ua, blocks))
        else:
            predicted = [p.cycles for p in bp.predict_batch(blocks)]
    if len(predicted) != len(blocks):
        raise ValueError(f"predict_fn returned {len(predicted)} cycles "
                         f"for a {len(blocks)}-block wave")
    off = 0
    for shard, records, shard_blocks in group:
        n = len(shard_blocks)
        rows = [{"id": r["id"], "family": r["family"], "block": r["block"],
                 "predicted": float(p), "measured": float(m)}
                for r, p, m in zip(records, predicted[off:off + n],
                                   measured[off:off + n])]
        off += n
        rows_by_shard[shard["name"]] = rows
        _write_rows(results_dir, shard, rows)
