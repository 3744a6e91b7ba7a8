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
It runs forward only: the sends carry no gradient, so asking for one
raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models import sharding as SH
from repro_torch.models.sharding import P
from repro_torch.tree_util import tree_leaves, tree_map


def _region(x, mesh, spec):
    """``x`` (a DTensor, or the whole tensor every rank holds) as this
    rank's local shard of ``spec``."""
    if not isinstance(x, DTensor):
        x = SH.distribute(x, mesh, spec, what="pipeline input",
                          src_data_rank=None)
    return SH.to_region(x, spec)


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*tree_leaves(stacked_params), xs)):
        raise NotImplementedError("pipeline_apply runs forward only: its "
                                  "sends between stages carry no gradient")
    S = SH.axis_size(mesh, axis)
    group = SH.axis_groups(mesh, axis)[0]
    stage = mesh.get_local_rank(axis)
    bspec = tuple(batch_axes) if batch_axes else None
    params = tree_map(lambda a: _region(a, mesh, P(axis))[0], stacked_params)
    xs_loc = _region(xs, mesh, P(None, bspec))
    n_micro = xs_loc.shape[0]
    T = n_micro + S - 1
    nxt = (dist.get_global_rank(group, stage + 1) if stage < S - 1
           else None)
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None

    recv = torch.zeros_like(xs_loc[0])
    out = torch.zeros_like(xs_loc)
    for t in range(T):
        inp = xs_loc[min(t, n_micro - 1)] if stage == 0 else recv
        y = stage_fn(params, inp)
        ops, got = [], torch.zeros_like(recv)
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prv is not None:
            ops.append(dist.P2POp(dist.irecv, got, prv, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        recv = got
        widx = t - (S - 1)
        if stage == S - 1 and widx >= 0:
            out[widx] = y
    # broadcast the last stage's outputs to every stage's copy
    out = SH.reduce_from(out if stage == S - 1 else torch.zeros_like(out),
                         [group])
    return SH.from_region(out, mesh, P(None, bspec))


def split_stages(stacked_layers, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-stacked."""
    def re(a):
        L = a.shape[0]
        if L % n_stages:
            raise AssertionError(f"{L} layers across {n_stages} stages")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])

    return tree_map(re, stacked_layers)
