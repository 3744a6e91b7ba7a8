"""Deterministic, shard-aware synthetic data pipeline.

The port of the reference package's ``repro.data.pipeline``.  It produces
next-token-prediction batches from a synthetic corpus (a seeded
Markov-ish token stream with local structure, so small models have
something learnable), with the properties a production loader must have:

  * deterministic given (seed, step): restart-safe without state files,
  * shard-aware: each data shard draws a disjoint slice of the global batch,
  * O(1) state: the cursor IS the step number (checkpointable as one int),
  * modality stubs for the VLM / audio architectures.

``tokens``/``labels`` are the reference's integer hash, computed in numpy,
so they are bit for bit the reference's for every family, seed, step and
shard.  The modality stubs (``patch_embeds``, ``audio_frames``) are
``0.02 * N(0, 1)`` in ``compute_dtype`` as in the reference, but the
reference draws them with ``jax.random`` and the port cannot reproduce
those draws without JAX: it draws from a CPU ``torch.Generator`` seeded
with ``seed * 1000003 + step`` (the reference's key), the same shape,
dtype and scale, deterministic per (seed, step) whatever the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 512
    # synthetic structure: tok_{t+1} = (a * tok_t + drift_{block}) % V
    n_styles: int = 7


class SyntheticTokens:
    """Iterable over (step -> batch dict of tensors on ``device``).
    Stateless between calls."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 data_cfg: DataConfig | None = None,
                 shard_index: int = 0, num_shards: int = 1, *,
                 device="cuda"):
        if shape.global_batch % num_shards:
            raise ValueError(f"global batch {shape.global_batch} is not a "
                             f"multiple of {num_shards} shards")
        self.cfg = cfg
        self.shape = shape
        self.dc = data_cfg or DataConfig(vocab_size=cfg.vocab_size)
        self.local_batch = shape.global_batch // num_shards
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.device = torch.device(device)

    def _normal(self, step: int, shape):
        gen = torch.Generator().manual_seed(self.dc.seed * 1000003 + step)
        x = torch.randn(shape, generator=gen) * 0.02
        return x.to(self.cfg.compute_dtype).to(self.device)

    def batch_at(self, step: int) -> dict:
        """Global determinism: sequence i of step s is a pure function of
        (seed, s, global_index)."""
        cfg, dc = self.cfg, self.dc
        B, S = self.local_batch, self.shape.seq_len
        g0 = step * self.shape.global_batch + self.shard_index * B
        idx = np.arange(g0, g0 + B, dtype=np.uint64)
        V = min(dc.vocab_size, cfg.vocab_size)
        # deterministic integer hashing: sequence i is a pure fn of (seed, i)
        h = (idx * np.uint64(2654435761) + np.uint64(dc.seed * 97 + 13))
        h ^= h >> np.uint64(16)
        style = (h % np.uint64(dc.n_styles)).astype(np.int64)[:, None] + 1
        start = ((h >> np.uint64(8)) % np.uint64(V)).astype(np.int64)[:, None]
        t = np.arange(S + 1, dtype=np.int64)[None, :]
        toks = (start + style * t + (t // 17) * (style + 3)) % V
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        if cfg.family == "vlm":
            pt = cfg.num_patch_tokens
            tokens, labels = tokens[:, :S - pt], labels[:, :S - pt]
        batch = {"tokens": torch.from_numpy(np.ascontiguousarray(tokens)),
                 "labels": torch.from_numpy(np.ascontiguousarray(labels))}
        batch = {k: v.to(self.device) for k, v in batch.items()}
        if cfg.family == "vlm":
            batch["patch_embeds"] = self._normal(
                step, (B, cfg.num_patch_tokens, cfg.d_model))
        elif cfg.family == "encdec":
            batch["audio_frames"] = self._normal(
                step, (B, cfg.num_audio_frames, cfg.d_model))
        return batch

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
