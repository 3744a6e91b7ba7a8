"""Gradient compression with error feedback for the cross-pod all-reduce.

The port of the reference package's ``repro.optim.compression``: per-block
symmetric int8 quantization (``BLOCK`` values a block, one f32 scale a
block, rounding half to even as ``jnp.round`` does), its inverse, and
``ErrorFeedback`` (compress ``g + e``, keep ``e' = (g + e) - decompress``).
The quantized values and scales are bit for bit the reference's.

``psum_int8`` sums each rank's local tensor over a mesh axis of the
current mesh (``launch.mesh.set_mesh``; the reference runs it inside
``shard_map``): the int8 payload and its f32 scales are all-gathered over
the axis's process group (~1.016 B/element on the wire against 4 B for an
f32 sum), then dequantized and summed in rank order on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch.mesh import current_mesh
from repro_torch.tree_util import tree_map

BLOCK = 256


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


def _gather(t, group, n: int):
    """The ``n`` ranks' ``t`` of ``group`` stacked in rank order."""
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.view(n, *t.shape)


def psum_int8(x, axis: str):
    """Drop-in for ``psum`` over the mesh axis ``axis`` of the current mesh:
    quantize this rank's ``x`` (its local shard, a plain tensor), all-gather
    the int8 payload (+ f32 per-block scales) over ``axis``, dequantize and
    sum in rank order.  Every rank returns the same sum; no gradient."""
    mesh = current_mesh()
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    q, scale, meta = quantize_int8(x)
    qs = _gather(q, group, n)          # (n_axis, blocks, BLOCK) int8
    ss = _gather(scale, group, n)
    total = torch.sum(qs.to(torch.float32) * ss, dim=0)
    n_el, shape, dtype = meta
    return total.reshape(-1)[:n_el].reshape(shape).to(dtype)


def compressed_psum_tree(tree, axis: str):
    """psum_int8 over every leaf of a tree."""
    return tree_map(lambda x: psum_int8(x, axis), tree)


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
