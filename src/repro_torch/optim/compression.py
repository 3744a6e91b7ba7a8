"""Gradient compression with error feedback, the local half.

The port of the reference package's ``repro.optim.compression``: per-block
symmetric int8 quantization (``BLOCK`` values a block, one f32 scale a
block, rounding half to even as ``jnp.round`` does), its inverse, and
``ErrorFeedback`` (compress ``g + e``, keep ``e' = (g + e) - decompress``).
The quantized values and scales are bit for bit the reference's.

The reference sums the int8 payload over a mesh axis inside ``shard_map``
(``psum_int8``, ``compressed_psum_tree``: an all-gather of the payload
and its scales); those two wait for the mesh slice of the port and raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.tree_util import tree_map

BLOCK = 256

_MESH = ("psum_int8/compressed_psum_tree sum over a mesh axis (an "
         "all-gather inside shard_map): they wait for the mesh slice of the "
         "port (ROADMAP.md queue 1, item 7b)")


def quantize_int8(x, block: int = BLOCK):
    """Per-block symmetric int8 quantization. x: any shape -> (q, scales,
    meta) with q int8 (blocks, block) of x.size padded to a block
    multiple, scales f32 (blocks, 1) and meta (n, shape, dtype)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blk = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blk), dim=1, keepdim=True) / 127.0
    safe = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blk / safe), -127, 127).to(torch.int8)
    return q, scale, (n, tuple(x.shape), x.dtype)


def dequantize_int8(q, scale, meta):
    n, shape, dtype = meta
    flat = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return flat.reshape(shape).to(dtype)


def psum_int8(x, axis: str):
    """The reference's int8 all-gather sum over ``axis``: not ported."""
    raise NotImplementedError(_MESH)


def compressed_psum_tree(tree, axis: str):
    """psum_int8 over every leaf of a tree: not ported."""
    raise NotImplementedError(_MESH)


class ErrorFeedback:
    """Residual accumulator: compress(g + e); e' = (g + e) - decompress."""

    @staticmethod
    def init(tree):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        tree)

    @staticmethod
    def apply(grads, residual, compress_fn):
        """Returns (compressed-then-decompressed grads, new residual)."""
        corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads,
                             residual)
        rounded = tree_map(lambda x: dequantize_int8(*quantize_int8(x)),
                           corrected)
        transmitted = compress_fn(rounded)
        new_resid = tree_map(lambda c, r: c - r, corrected, rounded)
        return transmitted, new_resid


def roundtrip_int8(x):
    """Quantize + dequantize (for tests and the EF convergence check)."""
    return dequantize_int8(*quantize_int8(x))
