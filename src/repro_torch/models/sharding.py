"""Sharding descriptors, activation constraints and the explicit regions.

The port of the reference package's ``repro.models.sharding``.  Model code
never references a concrete mesh; it gets a :class:`MeshAxes` describing
which *named axes* carry batch / model parallelism and applies activation
constraints through :func:`sc`.  With ``enabled=False`` (or empty axes)
every constraint is the identity, so the same code runs on one device.

A ``jax.sharding.PartitionSpec`` is :class:`P` here, a tuple with one entry
a tensor dimension (``None``, a mesh-axis name or a tuple of names); a
``NamedSharding`` is a ``torch.distributed`` ``DeviceMesh`` with the DTensor
placements :func:`placements` derives from a ``P``, and
``with_sharding_constraint`` is :func:`sc`, a ``redistribute`` of a
``DTensor``.

The reference's ``shard_map`` regions (MoE expert parallelism, the
vocab-parallel cross-entropy, the pipeline, the int8 sum) run on local
shards here, entered by :func:`to_region` and left by :func:`from_region`,
with the Megatron pair of collectives inside: :func:`copy_to` (identity
forward, sum backward) where a value replicated over an axis enters work
split over it, and :func:`reduce_from` (sum forward, identity backward)
where that work's parts are summed.  Their gradients are the unsharded
model's.

Conventions (see DESIGN.md §6):
  * batch dims of activations  -> ``axes.batch``  (e.g. ("pod","data"))
  * attention heads / d_ff / experts / vocab -> ``axes.model``
  * decode KV-cache sequence dim -> ``axes.model`` when kv-head sharding is
    impossible (GQA with kv_heads < |model|): flash-decoding style.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)


class P(tuple):
    """A ``PartitionSpec``: ``P(None, "data", "model")`` names the mesh
    axes that shard each tensor dimension (``None``: replicated; a tuple
    of names: sharded over those axes, major to minor); dimensions past
    its length are replicated.  A one-name tuple is kept as the name and
    an empty one as ``None``, as ``PartitionSpec`` keeps them."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


@dataclass(frozen=True)
class MeshAxes:
    batch: tuple[str, ...] = ()  # axes batch dim is sharded over
    model: str | None = None     # tensor-parallel axis name
    enabled: bool = False
    # decode-time KV partitioning: "heads" | "seq" (flash-decoding)
    kv_partition: str = "heads"

    @property
    def bspec(self):
        """Partition entry for a batch dimension."""
        return self.batch if self.batch else None

    def replace(self, **kw) -> "MeshAxes":
        return replace(self, **kw)


SINGLE = MeshAxes()  # no sharding: unit tests / single-device runs


def make_axes(mesh, *, batch_shardable: bool = True,
              kv_partition: str = "heads") -> MeshAxes:
    """Derive MeshAxes from a mesh built by launch.mesh."""
    names = mesh.mesh_dim_names
    batch = (tuple(n for n in names if n in ("pod", "data"))
             if batch_shardable else ())
    model = "model" if "model" in names else None
    return MeshAxes(batch=batch, model=model, enabled=True,
                    kv_partition=kv_partition)


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec, ndim: int | None = None) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on mesh
    dimension ``i`` when tensor dimension ``d`` names it, else
    ``Replicate()``.  A dimension sharded over several axes lists them in
    the mesh's order (the order DTensor shards in)."""
    names = list(mesh.mesh_dim_names)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"{spec!r} has more entries than the tensor's "
                         f"{ndim} dimensions")
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec!r}: axes {axes} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec!r} names mesh axis {names[i]!r} "
                                 "twice")
            out[i] = Shard(d)
    return tuple(out)


def _check_even(shape, mesh, spec, what: str):
    """The reference's ``NamedSharding`` needs every sharded dimension to
    divide evenly; DTensor would pad, so an uneven placement raises."""
    for d, entry in enumerate(spec):
        n = 1
        for a in _axes_of(entry):
            n *= mesh.size(list(mesh.mesh_dim_names).index(a))
        if shape[d] % n:
            raise ValueError(f"{what}: dimension {d} of {tuple(shape)} does "
                             f"not divide over {n} ranks ({spec!r})")


def distribute(t: torch.Tensor, mesh, spec, *, what: str = "tensor",
               src_data_rank: int | None = 0) -> DTensor:
    """``t`` (the whole tensor) placed on ``mesh`` by ``spec``
    (``jax.device_put(t, NamedSharding(mesh, spec))``).  ``src_data_rank``
    None: every rank holds the same ``t`` and keeps its own shard of it,
    with no communication; 0: rank 0's ``t`` is sent."""
    _check_even(t.shape, mesh, spec, what)
    return distribute_tensor(t, mesh, placements(mesh, spec, t.dim()),
                             src_data_rank=src_data_rank)


def resolve(dims, axes: MeshAxes) -> P:
    """The ``P`` that ``sc``'s ``dims`` name ("batch"/"model" resolved via
    ``axes``)."""
    out = []
    for d in dims:
        if d == "batch":
            out.append(axes.bspec)
        elif d == "model":
            out.append(axes.model)
        else:
            out.append(d)
    return P(*out)


def sc(x, axes: MeshAxes, *dims):
    """``with_sharding_constraint(x, P(*dims))`` if sharding is enabled:
    ``x``, a DTensor, redistributed to the placements the spec names.

    ``dims`` entries are either None, an axis name string, a tuple of axis
    names, or the sentinel strings "batch"/"model" resolved via ``axes``.
    A plain tensor under an enabled ``axes`` has escaped the mesh: that
    raises.
    """
    if not axes.enabled:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"sc: a plain {type(x).__name__} of shape "
                        f"{tuple(x.shape)} under an enabled MeshAxes; every "
                        "tensor of a sharded model is a DTensor")
    want = placements(x.device_mesh, resolve(dims, axes), x.dim())
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def replicated(t: torch.Tensor, like):
    """``t``, a value every rank computes alike (a position range, a mask,
    a zero), as a replicated DTensor on ``like``'s mesh when ``like`` is a
    DTensor; ``t`` itself otherwise."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


# ---------------------------------------------------------------------------
# explicit regions (the reference's shard_map bodies) on local shards
# ---------------------------------------------------------------------------


def axis_groups(mesh, axes) -> list:
    """The process groups of the mesh axes ``axes`` (a name or a tuple of
    names; None or () gives none)."""
    return [mesh.get_group(a) for a in _axes_of(axes)]


def axis_size(mesh, axes) -> int:
    n = 1
    for a in _axes_of(axes):
        n *= mesh.size(list(mesh.mesh_dim_names).index(a))
    return n


def _all_reduce(x, groups, op=dist.ReduceOp.SUM):
    out = x.clone()
    for g in groups:
        dist.all_reduce(out, op=op, group=g)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        return _all_reduce(x, groups) / n

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None, None


class _GradPlacedAsValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        # a redistribution along an inner dimension leaves a strided
        # local shard, which a view's backward cannot view
        return grad.contiguous()


def grad_placed_as_value(x: DTensor) -> DTensor:
    """``x`` itself; backward, its gradient redistributed to ``x``'s
    placements and made contiguous before it flows on.  For a view whose
    backward DTensor cannot run from the placement (an unflatten into
    heads that do not divide over an axis) or the strides (a local shard
    sliced along an inner dimension) the gradient arrives in."""
    return _GradPlacedAsValue.apply(x)


def copy_to(x, groups):
    """Identity forward; the gradient summed over ``groups`` backward.  For
    a value replicated over those ranks entering work split across them,
    so that its gradient is the whole of the parts' gradients on every
    rank."""
    return _CopyTo.apply(x, tuple(groups)) if groups else x


def reduce_from(x, groups):
    """The sum over ``groups`` forward (``psum``); the gradient unchanged
    backward: the sum is replicated, so each rank's part takes the sum's
    gradient as it is."""
    return _ReduceFrom.apply(x, tuple(groups)) if groups else x


def mean_over(x, groups, n: int):
    """The mean over ``groups`` (``pmean``, ``n`` ranks) of a value each
    rank computed from its own data; backward each rank's part takes
    ``1/n`` of the (replicated) mean's gradient."""
    return _MeanOver.apply(x, tuple(groups), n) if groups else x


def max_over(x, groups):
    """The maximum over ``groups`` (``pmax``), with no gradient: the
    regions use it as a numerically stabilizing shift only."""
    return _all_reduce(x.detach(), groups, dist.ReduceOp.MAX)


def to_region(x: DTensor, spec, *, partial=()) -> torch.Tensor:
    """``x`` redistributed to ``spec`` on its mesh and taken as this
    rank's local shard (a ``shard_map`` in_spec).  ``partial`` names the
    mesh axes over which the local shard's gradient is a part of the
    whole (a weight replicated over the batch axes, used on each rank's
    own tokens); over the others it is the local shard's own."""
    if not isinstance(x, DTensor):
        raise TypeError("to_region: the input is not a DTensor")
    mesh = x.device_mesh
    want = placements(mesh, spec, x.dim())
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    names = list(mesh.mesh_dim_names)
    grad = list(want)
    for a in _axes_of(partial):
        i = names.index(a)
        if not isinstance(grad[i], Replicate):
            raise ValueError(f"to_region: {spec!r} shards axis {a!r}, whose "
                             "gradient cannot be partial")
        grad[i] = Partial()
    return x.to_local(grad_placements=grad)


def from_region(t: torch.Tensor, mesh, spec, *, shape=None) -> DTensor:
    """A region's local output ``t`` as a DTensor placed by ``spec`` (a
    ``shard_map`` out_spec); ``shape``, the whole tensor's, where a shard
    may be uneven (heads that do not divide over the model axis)."""
    stride = None
    if shape is not None:   # the whole tensor's strides are contiguous
        t, shape = t.contiguous(), torch.Size(shape)
        stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, placements(mesh, spec, t.dim()),
                              run_check=False, shape=shape, stride=stride)
