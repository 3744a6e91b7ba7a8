"""The one traffic generator: every input of a cell drawn from its seed
and the parameters of its workload file.

* ``prompts``: a pool of prompt batches, token ids uniform over the
  vocabulary, drawn on the device from one generator in one call; batch
  ``k`` of a run is ``pool[k % len(pool)]``.
* ``synthetic_batch``: the training rows of step ``step``, the plain copy
  of the program's synthetic stream (``data/pipeline.py``: a hash of the
  global row index, then tokens in arithmetic progressions), so the
  reference is fed rows that the benchmark made itself.
"""
from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed of its own for each use of a run's seed."""
    return (seed * 6_364_136_223 + stream * 1_442_695_041 + 1) % (1 << 63)


def prompts(traffic: dict, seed: int, vocab: int, device):
    """(pool_batches, batch, prompt_len) int32 token ids."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 1))
    shape = (traffic["pool_batches"], traffic["batch"], traffic["prompt_len"])
    return torch.randint(0, vocab, shape, generator=gen, device=device,
                         dtype=torch.int32)


def synthetic_batch(seed: int, step: int, batch: int, seq_len: int,
                    vocab: int, n_styles: int = 7) -> dict:
    """{"tokens", "labels"} (batch, seq_len) int32 of training step
    ``step`` (rows ``step * batch`` onwards of the stream)."""
    idx = np.arange(step * batch, (step + 1) * batch, dtype=np.uint64)
    h = idx * np.uint64(2654435761) + np.uint64(seed * 97 + 13)
    h ^= h >> np.uint64(16)
    style = (h % np.uint64(n_styles)).astype(np.int64)[:, None] + 1
    start = ((h >> np.uint64(8)) % np.uint64(vocab)).astype(np.int64)[:, None]
    t = np.arange(seq_len + 1, dtype=np.int64)[None, :]
    toks = (start + style * t + (t // 17) * (style + 3)) % vocab
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
