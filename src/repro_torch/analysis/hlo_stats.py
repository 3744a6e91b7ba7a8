"""Collective statistics: parsed from compiled HLO text, or recorded from
the collectives a ``torch`` program issues.

The port of the reference package's ``repro.analysis.hlo_stats``.  The
reference has no other source of collective traffic (``cost_analysis()``
does not report it), so the roofline's collective term comes from summing
operand/result sizes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute in the (SPMD-partitioned, optimized) HLO:
:func:`parse_collectives`, framework-free text parsing kept as an exact
copy.  A ``torch`` program has no HLO; :class:`CollectiveRecorder` records
the same statistics from the collectives it issues on local shards
(DTensor's redistributions and the explicit regions' ``torch.distributed``
calls), into the same :class:`CollectiveStats` through the same formulas.

Wire-byte estimates per device use standard ring-algorithm formulas with the
replica-group size g parsed from the op:
    all-gather          R·(g-1)/g      (R = result bytes, per device)
    all-reduce          2·R·(g-1)/g
    reduce-scatter      R·(g-1)        (R is the scattered shard)
    all-to-all          R·(g-1)/g
    collective-permute  R
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "c128": 16, "s4": 1, "u4": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# e.g.:  %all-gather.3 = bf16[16,4096,256]{2,1,0} all-gather(...), ...
_OP_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([0-9,]*)\][^ ]*\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_TUPLE_OP_RE = re.compile(
    r"=\s*\(([^)]*)\)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_SOURCE_TARGET_RE = re.compile(r"source_target_pairs=")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


@dataclass
class CollectiveStats:
    count: dict = field(default_factory=lambda: defaultdict(int))
    result_bytes: dict = field(default_factory=lambda: defaultdict(int))
    wire_bytes: dict = field(default_factory=lambda: defaultdict(float))

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_result_bytes(self) -> int:
        return sum(self.result_bytes.values())

    def to_dict(self) -> dict:
        return {
            "count": dict(self.count),
            "result_bytes": dict(self.result_bytes),
            "wire_bytes": dict(self.wire_bytes),
            "total_wire_bytes": self.total_wire_bytes,
        }


def _group_size(line: str) -> int:
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip()])
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        # iota form [num_groups,group_size]<=[total]
        return int(m.group(2))
    if _SOURCE_TARGET_RE.search(line):
        return 2
    return 1


def _wire(kind: str, result_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)  # collective-permute


def parse_collectives(hlo_text: str) -> CollectiveStats:
    stats = CollectiveStats()
    seen_done = set()
    for line in hlo_text.splitlines():
        if not any(c in line for c in _COLLECTIVES):
            continue
        # skip -done ops (size counted at -start)
        if re.search(r"(all-gather|all-reduce|reduce-scatter|all-to-all|"
                     r"collective-permute)-done", line):
            continue
        kind = None
        rbytes = 0
        m = _OP_RE.search(line)
        if m:
            kind = m.group(3)
            rbytes = _shape_bytes(m.group(1), m.group(2))
        else:
            mt = _TUPLE_OP_RE.search(line)
            if mt:
                kind = mt.group(2)
                # tuple result (e.g. variadic all-gather / -start): sum parts
                for sm in _SHAPE_RE.finditer(mt.group(1)):
                    rbytes += _shape_bytes(sm.group(1), sm.group(2))
            else:
                continue
        g = _group_size(line)
        stats.count[kind] += 1
        stats.result_bytes[kind] += rbytes
        stats.wire_bytes[kind] += _wire(kind, rbytes, g)
    return stats


# ---------------------------------------------------------------------------
# the port's source of the same statistics: the collectives a program issues
# ---------------------------------------------------------------------------


def _tensor_bytes(t) -> int:
    """Bytes of a tensor or a list of them."""
    if isinstance(t, (list, tuple)):
        return sum(_tensor_bytes(x) for x in t)
    return t.numel() * t.element_size()


def _collective_ops() -> dict:
    """aten-level collective op -> (kind, where its result is: "out" or
    an argument's index, the op's process group from its arguments)."""
    fn = torch.ops._c10d_functional
    c = torch.ops.c10d

    def named(i):
        return lambda a: _resolve_process_group(a[i])

    def boxed(i):
        return lambda a: dist.ProcessGroup.unbox(a[i])

    return {
        fn.all_gather_into_tensor.default: ("all-gather", "out", named(2)),
        fn.reduce_scatter_tensor.default: ("reduce-scatter", "out",
                                           named(3)),
        fn.all_reduce.default: ("all-reduce", "out", named(2)),
        fn.all_to_all_single.default: ("all-to-all", "out", named(3)),
        c.allreduce_.default: ("all-reduce", 0, boxed(1)),
        c._allgather_base_.default: ("all-gather", 0, boxed(2)),
        c._reduce_scatter_base_.default: ("reduce-scatter", 0, boxed(2)),
        c.alltoall_base_.default: ("all-to-all", 0, boxed(2)),
        # a send/recv pair is one collective-permute, counted where the
        # value arrives (the result XLA's op yields)
        c.recv_.default: ("collective-permute", 0, boxed(1)),
    }


class CollectiveRecorder(TorchDispatchMode):
    """Counts every collective issued inside it into ``self.stats`` (a
    :class:`CollectiveStats`), per device: the kind
    (``_c10d_functional.all_gather_into_tensor`` -> ``all-gather``,
    ``reduce_scatter_tensor`` -> ``reduce-scatter``, ``all_reduce`` and
    ``c10d.allreduce_`` -> ``all-reduce``, ``all_to_all_single`` ->
    ``all-to-all``, a send/recv pair -> ``collective-permute``), the
    result's bytes on this rank, and the group size read from the op's
    group; the wire bytes by :func:`_wire`.  ``self.links`` splits the
    wire bytes by the slowest link the group crosses: ``"nvlink"`` when
    every rank of it (of a send/recv: both ends) lies in one node of
    ``node_size`` consecutive ranks, else ``"ib"``.  DTensor ops are
    handed on to DTensor (``NotImplemented``), so the mode sees the local
    collectives that DTensor's redistributions issue.  Subclasses see
    every local op through :meth:`observe`."""

    def __init__(self, node_size: int):
        super().__init__()
        self.stats = CollectiveStats()
        self.links = {"nvlink": 0.0, "ib": 0.0}
        self.node_size = node_size
        self._table = _collective_ops()

    def _link(self, func, args, pg) -> str:
        if func is torch.ops.c10d.recv_.default:
            ranks = [dist.get_rank(), dist.get_global_rank(pg, args[2])]
        else:
            ranks = dist.get_process_group_ranks(pg)
        return "nvlink" if len({r // self.node_size for r in ranks}) == 1 \
            else "ib"

    def observe(self, func, args, kwargs, out):
        """Called after every local op; counts the collectives."""
        entry = self._table.get(func)
        if entry is None:
            return
        kind, where, group = entry
        pg = group(args)
        rbytes = _tensor_bytes(out if where == "out" else args[where])
        g = 2 if kind == "collective-permute" else pg.size()
        wire = _wire(kind, rbytes, g)
        self.stats.count[kind] += 1
        self.stats.result_bytes[kind] += rbytes
        self.stats.wire_bytes[kind] += wire
        self.links[self._link(func, args, pg)] += wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.observe(func, args, kwargs, out)
        return out
