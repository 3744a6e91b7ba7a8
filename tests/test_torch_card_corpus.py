"""Corpus evaluation on the card: ground truth through the wave-dispatch
kernel and predictions through the port-bound kernel give the rows and
the accuracy artifact of the CPU ``torch`` backend, bit for bit; and a
traced wave on the card reports its kernel time.

Marked ``cuda``: each test skips without a GPU.  The file imports neither
jax nor the reference package, so a GPU host without jax runs it
(``chip_smoke.py``'s ``[card-tests]`` phase):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card_corpus.py

Rows are compared as the float64 bits of ``measured`` and ``predicted``:
tolerance 0."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import batch_sim
from repro_torch.core.isa import TEST_ISA
from repro_torch.core.machine import RegPool, independent_seq
from repro_torch.core.uarch import SIM_SKL
from repro_torch.corpus import (CorpusSpec, evaluate_corpus, generate_corpus,
                                score_results)
from repro_torch.kernels import port_bound as pb
from repro_torch.kernels import wave_dispatch as wd
from repro_torch.obs import tracer as obs

pytestmark = pytest.mark.cuda

SPEC = CorpusSpec(seed=11, blocks_per_uarch=96, uarches=("sim_skl",
                                                         "sim_snb"),
                  shard_size=32, min_len=2, max_len=10)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda:0")


def _bits(results):
    return {ua: np.array([[r["measured"], r["predicted"]] for r in rows],
                         dtype=np.float64).view(np.int64)
            for ua, rows in results["uarches"].items()}


def test_corpus_on_the_card_equals_the_cpu(card, tmp_path):
    generate_corpus(tmp_path / "corpus", SPEC)
    before = wd.launches, pb.launches
    got = evaluate_corpus(tmp_path / "corpus", backend="cuda", device=card,
                          predict_backend="cuda", wave_width=64,
                          out_dir=tmp_path / "card")
    launched = wd.launches - before[0], pb.launches - before[1]
    want = evaluate_corpus(tmp_path / "corpus", backend="torch",
                           device="cpu", predict_backend="torch",
                           wave_width=64, out_dir=tmp_path / "cpu")
    assert launched[0] > 0 and launched[1] > 0, launched
    assert (wd.launches, pb.launches) == \
        (before[0] + launched[0], before[1] + launched[1])
    for ua, bits in _bits(want).items():
        assert np.array_equal(_bits(got)[ua], bits), ua
    assert json.dumps(score_results(got), sort_keys=True) == \
        json.dumps(score_results(want), sort_keys=True)
    assert got["engine_stats"]["quarantined"] == 0
    assert got["engine_stats"]["degraded_chunks"] == 0


def test_traced_card_wave_reports_kernel_time(card):
    m = batch_sim.BatchSimMachine(SIM_SKL, TEST_ISA, backend="cuda",
                                  device=card, min_lanes=1)
    codes = [independent_seq(TEST_ISA[s], RegPool(), 3) * n
             for s in ("ADD_R64_R64", "IMUL_R64_R64", "DIV_R64", "CMC")
             for n in (10, 110)]
    old = obs.get_tracer()
    try:
        obs.set_tracer(obs.Tracer(enabled=False))
        m.run_batch(codes)
        assert not {"kernel_ns", "stragglers"} & set(m.device_stats())
        obs.set_tracer(obs.Tracer(enabled=True))
        m.run_batch(codes)
    finally:
        obs.set_tracer(old)
    st = m.device_stats()
    assert list(st["kernel_ns"]) == ["device:cuda:0"]
    ns = st["kernel_ns"]["device:cuda:0"]
    assert isinstance(ns, int) and ns > 0
    assert list(st["stragglers"]["ewma_s"]) == ["device:cuda:0"]
    assert st["stragglers"]["flagged"] == []
