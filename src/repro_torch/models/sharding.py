"""Sharding descriptors and activation-constraint helpers.

The port of the reference package's ``repro.models.sharding``.  Model code
never references a concrete mesh; it gets a :class:`MeshAxes` describing
which *named axes* carry batch / model parallelism and applies activation
constraints through :func:`sc`.  With ``enabled=False`` every constraint is
the identity, which is all this slice of the port runs: the mesh path
(``PartitionSpec`` rules, DTensor placement, ``make_axes``) waits for the
mesh slice, and asking for it raises instead of running unsharded.
"""
from __future__ import annotations

from dataclasses import dataclass

_MESH_SLICE = ("sharded model execution (PartitionSpec/mesh) is not ported "
               "yet: it waits for the mesh slice of the port (ROADMAP.md "
               "queue 1, item 7b)")


@dataclass(frozen=True)
class MeshAxes:
    batch: tuple[str, ...] = ()  # axes batch dim is sharded over
    model: str | None = None     # tensor-parallel axis name
    enabled: bool = False
    # decode-time KV partitioning: "heads" | "seq" (flash-decoding)
    kv_partition: str = "heads"


SINGLE = MeshAxes()  # no sharding: unit tests / single-device runs


def make_axes(mesh, *, batch_shardable: bool = True,
              kv_partition: str = "heads") -> MeshAxes:
    """Derive MeshAxes from a device mesh: waits for the mesh slice."""
    raise NotImplementedError(_MESH_SLICE)


def sc(x, axes: MeshAxes, *dims):
    """The activation constraint ``P(*dims)`` on ``x``: the identity while
    sharding is disabled, and not ported for an enabled ``axes``."""
    if not axes.enabled:
        return x
    raise NotImplementedError(_MESH_SLICE)
