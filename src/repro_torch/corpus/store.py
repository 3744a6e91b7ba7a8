"""Sharded JSONL corpus storage with a content-addressed manifest.

The port of the reference package's ``repro/corpus/store.py``
(framework-free; the same bytes).

Layout under a corpus directory::

    manifest.json                     # spec + per-shard sha256 + corpus id
    shards/<uarch>-00000.jsonl        # one JSON record per line
    shards/<uarch>-00001.jsonl
    ...

Every shard line is ``{"block", "family", "id", "uarch"}`` serialized with
sorted keys and compact separators, so a shard's bytes are a pure function
of its records. The manifest carries each shard's sha256 and a corpus id
(sha256 over the ordered shard hashes): two generation runs agree iff
their manifests are byte-identical, and an evaluator can verify a shard
before trusting cached results for it. Writes are atomic
(tmp + ``os.replace``, the checkpoint module's convention) so a killed
generation never leaves a torn shard behind.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

MANIFEST = "manifest.json"
SHARD_DIR = "shards"
MANIFEST_VERSION = 1


def _dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def shard_records(records: list[dict]) -> bytes:
    """Canonical shard bytes for a record list."""
    return "".join(_dumps(r) + "\n" for r in records).encode()


def _atomic_write(path: Path, data: bytes) -> None:
    """tmp + rename; the ``corpus.shard_write`` injection point lives on
    the tmp-file bytes, so an injected torn write is caught by the
    manifest hash check (``read_shard``) instead of silently trusted."""
    from repro_torch.faults import plan as faults  # noqa: PLC0415
    if faults.active():
        faults.check("corpus.shard_write", key=path.name)
        data = faults.filter_bytes("corpus.shard_write", data,
                                   key=path.name)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def corpus_id(shard_hashes: list[str]) -> str:
    h = hashlib.sha256()
    for s in shard_hashes:
        h.update(s.encode())
    return h.hexdigest()


def write_corpus(out_dir, by_uarch: dict, spec) -> dict:
    """Persist per-uarch record lists as fixed-size shards + manifest.
    Returns the manifest dict (what ``load_manifest`` reads back)."""
    out = Path(out_dir)
    (out / SHARD_DIR).mkdir(parents=True, exist_ok=True)
    shards = []
    for uarch in sorted(by_uarch):
        records = by_uarch[uarch]
        for si in range(0, max(1, len(records)), spec.shard_size):
            chunk = records[si:si + spec.shard_size]
            name = f"{uarch}-{si // spec.shard_size:05d}.jsonl"
            data = shard_records(chunk)
            _atomic_write(out / SHARD_DIR / name, data)
            fams: dict[str, int] = {}
            for r in chunk:
                fams[r["family"]] = fams.get(r["family"], 0) + 1
            shards.append({"name": name, "uarch": uarch,
                           "n_blocks": len(chunk), "families": fams,
                           "sha256": hashlib.sha256(data).hexdigest()})
    manifest = {"version": MANIFEST_VERSION, "spec": spec.as_dict(),
                "shards": shards,
                "total_blocks": sum(s["n_blocks"] for s in shards),
                "corpus_id": corpus_id([s["sha256"] for s in shards])}
    _atomic_write(out / MANIFEST,
                  json.dumps(manifest, sort_keys=True, indent=1).encode())
    return manifest


def load_manifest(corpus_dir) -> dict:
    path = Path(corpus_dir) / MANIFEST
    if not path.exists():
        raise FileNotFoundError(f"no corpus manifest at {path} — run "
                                f"python -m repro_torch.corpus generate first")
    return json.loads(path.read_text())


def read_shard(corpus_dir, shard: dict, *, verify: bool = True) -> list[dict]:
    """One shard's records; with ``verify`` the bytes are checked against
    the manifest hash (a mismatch means the corpus was edited or torn)."""
    data = (Path(corpus_dir) / SHARD_DIR / shard["name"]).read_bytes()
    if verify:
        got = hashlib.sha256(data).hexdigest()
        if got != shard["sha256"]:
            raise ValueError(f"shard {shard['name']} content hash {got[:12]} "
                             f"does not match manifest "
                             f"{shard['sha256'][:12]}")
    return [json.loads(line) for line in data.splitlines() if line]


def iter_shard_blocks(corpus_dir, shard: dict, *, verify: bool = True):
    """Yield ``(record, parsed block)`` pairs for one shard."""
    from repro_torch.service.protocol import parse_block  # noqa: PLC0415

    for rec in read_shard(corpus_dir, shard, verify=verify):
        yield rec, parse_block(rec["block"])
