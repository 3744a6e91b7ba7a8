"""GPipe-style pipeline parallelism over a mesh axis (``pod`` by default).

The port of the reference package's ``repro.train.pipeline``.
``pipeline_apply`` runs a homogeneous layer stack split into S stages
across the axis: microbatches stream through stages, each tick's outputs
handed to the next stage by point-to-point sends (the reference's
``ppermute(i -> i+1)``, here ``batch_isend_irecv``); the bubble is the
standard (S-1)/(S-1+M) fraction. Params come stacked as
(S, layers_per_stage, ...); each rank of the axis holds one stage.

This is the composable PP building block (optional — the default multi-pod
config uses the pod axis for hierarchical data parallelism, DESIGN.md §6).
It differentiates as the reference does under ``jax.grad``: each tick's
hand-off is :class:`_Shift`, whose backward sends the cotangent from stage
i+1 back to stage i (the transpose of ``ppermute(i -> i+1)``), and the
final sum to every stage is the Megatron pair ``reduce_from`` (sum
forward, identity backward).  Gradients land on each stage's slice of the
``P(axis)`` parameter leaves; ``xs`` takes stage 0's cotangent, as a part
of a gradient summed over the axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models import sharding as SH
from repro_torch.models.sharding import P
from repro_torch.tree_util import tree_map


def _region(x, mesh, spec, partial=()):
    """``x`` (a DTensor, or the whole tensor every rank holds) as this
    rank's local shard of ``spec``."""
    if not isinstance(x, DTensor):
        x = SH.distribute(x, mesh, spec, what="pipeline input",
                          src_data_rank=None)
    return SH.to_region(x, spec, partial=partial)


def _exchange(send, send_to, recv_like, recv_from, group):
    """Send ``send`` to rank ``send_to`` and receive a tensor shaped like
    ``recv_like`` from ``recv_from`` (either None: no such half), in one
    batch; returns what was received (zeros without a sender)."""
    got = torch.zeros_like(recv_like)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), send_to, group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, got, recv_from, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


class _Shift(torch.autograd.Function):
    """One tick's hand-off, ``ppermute(i -> i+1)``: forward, ``y`` goes to
    the next stage and the previous stage's ``y`` comes back; backward, the
    received value's cotangent goes back to the previous stage and the
    next stage's comes in as ``y``'s."""

    @staticmethod
    def forward(ctx, y, nxt, prv, group):
        ctx.nxt, ctx.prv, ctx.group = nxt, prv, group
        return _exchange(y, nxt, y, prv, group)

    @staticmethod
    def backward(ctx, grad):
        gy = _exchange(grad, ctx.prv, grad, ctx.nxt, ctx.group)
        return gy, None, None, None


class _Join(torch.autograd.Function):
    """``out`` itself, with every tick's received value and this stage's
    ``xs`` as inputs (of zero gradient), so that the backward visits each
    tick's :class:`_Shift` on every stage, in the same order on all of
    them, also where a received value fed nothing (stage 0 reads ``xs``,
    and the last tick's value is unused): a stage that skipped a
    hand-off's backward would leave its peer waiting.  Likewise every
    stage's ``xs`` takes a gradient, zero but on stage 0, which the
    axis's sum completes."""

    @staticmethod
    def forward(ctx, out, xs, *received):
        ctx.xs, ctx.n = (xs.shape, xs.dtype, xs.device), len(received)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.xs
        return (grad, torch.zeros(shape, dtype=dtype, device=device),
                *([None] * ctx.n))


def pipeline_apply(stage_fn, stacked_params, xs, mesh, axis: str = "pod",
                   batch_axes: tuple = ()):
    """stage_fn(stage_params, x) -> x, applied as an S-stage pipeline.

    stacked_params leaves: (S, ...) — stage s uses leaf[s].
    xs: (n_micro, B, ...) microbatched inputs (replicated over ``axis``,
    batch possibly sharded over ``batch_axes``).  Leaves and ``xs`` may be
    DTensors on ``mesh`` or whole tensors that every rank holds.
    Returns (n_micro, B, ...) outputs as a DTensor replicated over
    ``axis`` (``P(None, batch_axes)``).
    """
    S = SH.axis_size(mesh, axis)
    group = SH.axis_groups(mesh, axis)[0]
    stage = mesh.get_local_rank(axis)
    bspec = tuple(batch_axes) if batch_axes else None
    params = tree_map(lambda a: _region(a, mesh, P(axis))[0], stacked_params)
    # only stage 0 reads xs: its gradient is a part, summed over the axis
    xs_loc = _region(xs, mesh, P(None, bspec), partial=(axis,))
    n_micro = xs_loc.shape[0]
    T = n_micro + S - 1
    nxt = (dist.get_global_rank(group, stage + 1) if stage < S - 1
           else None)
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None

    recv = torch.zeros_like(xs_loc[0])
    received, ys = [], []
    for t in range(T):
        inp = xs_loc[min(t, n_micro - 1)] if stage == 0 else recv
        y = stage_fn(params, inp)
        recv = _Shift.apply(y, nxt, prv, group)
        received.append(recv)
        if stage == S - 1 and t >= S - 1:
            ys.append(y)
    out = torch.stack(ys) if ys else torch.zeros_like(xs_loc)
    # broadcast the last stage's outputs to every stage's copy
    out = SH.reduce_from(_Join.apply(out, xs_loc, *received), [group])
    return SH.from_region(out, mesh, P(None, bspec))


def split_stages(stacked_layers, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-stacked."""
    def re(a):
        L = a.shape[0]
        if L % n_stages:
            raise AssertionError(f"{L} layers across {n_stages} stages")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])

    return tree_map(re, stacked_layers)
