"""BHive-style basic-block corpus of the PyTorch port: generation, ground
truth, scoring — and the op corpus of the hardware path.

The port of the reference package's ``repro.corpus``, module for module:

* :mod:`repro_torch.corpus.generate` — the seeded, stratified block
  generator (dependency-chain-heavy, port-pressure-heavy, mixed,
  divider-heavy and elimination/zero-idiom families, sampled per uarch
  from the variants the uarch actually implements).  Deterministic: one
  seed → a corpus byte-identical to the reference's.
* :mod:`repro_torch.corpus.store` — the sharded JSONL corpus format plus
  a content-addressed ``manifest.json`` (per-shard sha256, corpus id over
  the shard hashes).
* :mod:`repro_torch.corpus.evaluate` — the ground-truth evaluator: corpus
  shards stream through ``BatchPredictor.simulate_batch`` as fused
  mega-waves (the CUDA wave-dispatch kernel on the card), and each wave is
  predicted by the closed form (the port-bound CUDA kernel), with
  per-shard result files written atomically so a killed run resumes warm.
* :mod:`repro_torch.corpus.score` — per-uarch MAPE, Kendall-τ (tau-b,
  exact) and relative-error bucket drill-downs.
* :mod:`repro_torch.corpus.jit_ops` — the op corpus that the hardware
  characterization path (``core/hardware.py``) measures.

``python -m repro_torch.corpus generate|evaluate|report`` drives the
pipeline from the command line; ``scripts/analyze_torch.py
--corpus-report`` renders the accuracy artifact.
"""
from repro_torch.corpus.evaluate import client_predict_fn, evaluate_corpus
from repro_torch.corpus.generate import (FAMILIES, CorpusSpec,
                                         generate_blocks, generate_corpus)
from repro_torch.corpus.jit_ops import build_jit_corpus
from repro_torch.corpus.score import (error_buckets, format_report,
                                      kendall_tau, mape, score_pairs,
                                      score_results)
from repro_torch.corpus.store import (corpus_id, iter_shard_blocks,
                                      load_manifest, shard_records,
                                      write_corpus)

__all__ = [
    "FAMILIES", "CorpusSpec", "generate_blocks", "generate_corpus",
    "build_jit_corpus", "client_predict_fn", "error_buckets",
    "evaluate_corpus", "format_report",
    "kendall_tau", "mape", "score_pairs", "score_results", "corpus_id",
    "iter_shard_blocks", "load_manifest", "shard_records", "write_corpus",
]
