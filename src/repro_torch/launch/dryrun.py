"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake tensors.

The port of the reference package's ``repro.launch.dryrun``.  The
reference lowers and compiles each cell with XLA on 256 or 512 forced host
devices; torch has no lower/compile step and no HLO.  Here a cell runs
once, eagerly, as rank 0 of a ``fake`` process group of 256 or 512 ranks
(``torch.distributed``'s backend whose collectives move nothing) on the
``make_production_mesh`` mesh, with every tensor a ``FakeTensor``
(``torch._subclasses.FakeTensorMode``): shapes, dtypes and devices are
real, no data exists.  A dry run therefore allocates no device memory by
construction, as the reference's runs on forced host devices allocate
none, and ``device_type="cuda"`` (the default, as in every entry point of
the port) needs no card: a fake CUDA tensor is only a description.

Building a cell: the model is built on ``meta`` and each parameter becomes
a fake **local shard** (``DTensor.from_local``) of its ``param_pspecs``
placement; inputs, the decode state and the AdamW moments are fake local
shards too (the moments are ``zeros_like`` of the sharded parameters).
No rank ever holds a whole tensor that it then distributes, so what is
counted is one device's share.

  * ``train``: one ``make_train_step`` step (``train_microbatches`` in the
    ``memory`` variant, 1 in ``cost``), AdamW included;
  * ``prefill``: ``model.prefill``;
  * ``decode``: ``model.decode_step`` and the greedy argmax of
    ``make_serve_step``, taken on logits gathered over the ``model`` axis
    (replicated over it), since an argmax over a vocab-sharded dimension
    reads a value back to the host.

The port always unrolls its layer loops (``layers.xscan`` is a Python
loop), so ``memory`` and ``cost`` differ only in the microbatch count; the
collective counts are those of the reference's ``cost`` variant (XLA's
``memory`` variant keeps the scans and counts a loop body once).

The record (under ``experiments/dryrun_torch/``; the reference's file name
and keys) is counted on this rank's local ops by one
``TorchDispatchMode`` (:class:`_Account`), which lets DTensor turn each of
its ops into local ops first:

  * ``lower_s``: the fake trace's wall time; ``compile_s``: 0 (nothing is
    compiled);
  * ``memory_analysis``: ``argument_size_in_bytes``, the local shards of
    the parameters, the optimizer state and the inputs;
    ``temp_size_in_bytes``, the peak of the storages the step allocates
    above them (each live from the op that makes it until its last tensor
    is freed; CUDA sizes rounded up to the caching allocator's 512-byte
    blocks); ``output_size_in_bytes``, the local bytes of what the step
    returns, and ``alias_size_in_bytes``, those of it that are argument
    buffers updated in place (the parameters and moments of a train step:
    XLA's donated and aliased buffers);
  * ``cost_analysis``: ``flops``, per device, by ``torch.utils.
    flop_counter``'s formulas applied to the local ops (around DTensors
    ``FlopCounterMode`` counts the global shapes); ``bytes accessed``,
    every local op's operand plus result bytes, views, allocations and
    collectives excepted: the same unfused upper bound as the reference's
    CPU ``cost_analysis``;
  * ``collectives``: :class:`repro_torch.analysis.hlo_stats.
    CollectiveRecorder`'s statistics, the reference's schema; beside it
    ``collective_links``, the same wire bytes split by the slowest link
    each group crosses (NVLink inside an 8-GPU node, else InfiniBand),
    which the roofline's collective term divides by;
  * ``hlo_bytes``: dropped (there is no HLO).

A cell's exception is recorded as ``ok: false`` with ``error`` and
``traceback``, and ``main`` exits 1 if any cell failed, as in the
reference.  Run:  ``PYTHONPATH=src python -m repro_torch.launch.dryrun
--arch smollm_360m --shape decode_32k --device-type cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn as nn
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                         unset_fake_temporarily)
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.hlo_stats import CollectiveRecorder
from repro_torch.configs.base import SHAPES, ShapeSpec, load_config, runnable_cells
from repro_torch.core.uarch import H100_SXM
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as MF
from repro_torch.models.sharding import P, placements
from repro_torch.models.transformer import FAMILIES, flatten_tree
from repro_torch.optim import adamw
from repro_torch.train.train_loop import make_train_step
from repro_torch.tree_util import tree_leaves

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
_CUDA_BLOCK = 512   # the caching allocator's smallest block


def start_fake_group(world: int):
    """Rank 0 of a ``fake`` process group of ``world`` ranks (no
    communication, no other process)."""
    # a store whose reads never wait for the ranks that do not exist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


# ---------------------------------------------------------------------------
# fake local shards
# ---------------------------------------------------------------------------


def local_shard(shape, dtype, spec, mesh, device) -> DTensor:
    """A DTensor of global ``shape`` placed by ``spec`` on ``mesh`` whose
    local tensor is an uninitialised shard of this rank's size (fake
    inside a ``FakeTensorMode``)."""
    pl = placements(mesh, spec, len(shape))
    with unset_fake_temporarily():   # the helper computes on tensors
        local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                         pl)
    t = torch.empty(local, dtype=dtype, device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _shard_tree(tree, specs, mesh, device):
    if isinstance(tree, dict):
        return {k: _shard_tree(tree[k], specs[k], mesh, device)
                for k in tree}
    return local_shard(tree.shape, tree.dtype, specs, mesh, device)


def _shard_params(model, device):
    """Every ``meta`` parameter of ``model`` as a fake local shard of its
    ``param_pspecs`` placement."""
    specs = flatten_tree(MF.param_pspecs(model, model.cfg))
    for name, p in list(model.named_parameters()):
        path, _, leaf = name.rpartition(".")
        owner = model.get_submodule(path) if path else model
        owner._parameters[leaf] = nn.Parameter(
            local_shard(p.shape, p.dtype, specs[name], model.mesh, device),
            requires_grad=False)
    return model


# ---------------------------------------------------------------------------
# building a cell
# ---------------------------------------------------------------------------


def _shape(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_cell(arch: str, shape, mesh, variant: str,
               extra_cfg: dict | None = None, alias_out: bool = False,
               device_type: str = "cuda"):
    """Returns ``(fn, args)``: the cell's step and its arguments (the model,
    whose parameters are arguments as the reference's ``params`` are, then
    the optimizer state, inputs or decode state), every tensor a fake
    local shard; call ``fn(*args)`` inside the ``FakeTensorMode`` the
    arguments were made in.  ``shape`` is a ``SHAPES`` name or a
    ``ShapeSpec``.  ``alias_out`` is accepted for the reference's CLI: the
    port's train step updates its parameters and moments in place (always
    aliased), and a decode step returns a new state."""
    del alias_out
    shape = _shape(shape)
    cfg = load_config(arch)
    if variant == "cost":
        cfg = cfg.replace(unroll_scans=True)
    if extra_cfg:
        cfg = cfg.replace(**extra_cfg)
    axes = MF.axes_for(cfg, shape, mesh)
    model = _shard_params(FAMILIES[cfg.family](cfg, axes, mesh), device_type)
    specs = MF.input_pspecs(cfg, shape, axes)
    inputs = {k: local_shard(v.shape, v.dtype, specs[k], mesh, device_type)
              for k, v in MF.input_specs(cfg, shape).items()}

    if shape.kind == "train":
        micro = 1 if variant == "cost" else getattr(cfg, "train_microbatches",
                                                    4)
        step = make_train_step(model, adamw.AdamWConfig(), micro)
        opt = adamw.init_state(model)
        return step, (model, opt, inputs)

    if shape.kind == "prefill":
        return (lambda model, inputs: model.prefill(inputs)), (model, inputs)

    # decode: one new token against a cache of seq_len
    state = model.decode_state_specs(shape.global_batch, shape.seq_len)
    state = _shard_tree(state, MF.state_pspecs(state, axes), mesh,
                        device_type)
    whole = placements(mesh, P(axes.bspec, None), 2)

    def serve_fn(model, state, tokens):
        logits, state = model.decode_step(state, tokens)
        # make_serve_step's greedy argmax, on logits replicated over the
        # model axis: over a vocab-sharded dimension it reads a value
        # back to the host
        nxt = torch.argmax(logits.redistribute(mesh, whole), dim=-1)
        return nxt.to(torch.int32), logits, state

    return serve_fn, (model, state, inputs["tokens"])


# ---------------------------------------------------------------------------
# the account of one rank's local ops
# ---------------------------------------------------------------------------


def _tensors(tree):
    """The plain tensors of a tree of args/outputs (DTensors as their
    local shards; lists, tuples, dicts and a model's parameters)."""
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf._local_tensor
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _flat(e)]
    return []


def _storage_bytes(t) -> int:
    n = t.untyped_storage().nbytes()
    if t.device.type == "cuda":
        n = math.ceil(n / _CUDA_BLOCK) * _CUDA_BLOCK
    return n


@contextlib.contextmanager
def _index_math_unfaked():
    """DTensor computes a strided shard's rows from small index tensors
    (``_StridedShard.local_shard_size_and_offset``) and reads them back;
    inside a ``FakeTensorMode`` those would be fake and unreadable, so the
    method runs with the fake mode set aside (it is metadata of shapes,
    on the host, on a card as here).  A release without the method is
    left as it is."""
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    name = "local_shard_size_and_offset"
    raw = inspect.getattr_static(cls, name, None) if cls else None
    if raw is None:
        yield
        return
    wrapper = type(raw) if isinstance(raw, (staticmethod, classmethod)) \
        else None
    fn = raw.__func__ if wrapper else raw

    @functools.wraps(fn)
    def unfaked(*a, **k):
        with unset_fake_temporarily():
            return fn(*a, **k)

    setattr(cls, name, wrapper(unfaked) if wrapper else unfaked)
    try:
        yield
    finally:
        setattr(cls, name, raw)


# DTensor runs each new op once on fake tensors of the whole shapes to
# learn its output's shape (in the ambient FakeTensorMode, when there is
# one): those ops are no rank's work
_PROPAGATE = "_propagate_tensor_meta_non_cached"


class _Account(CollectiveRecorder):
    """The collectives (:class:`CollectiveRecorder`) plus FLOPs, bytes
    accessed and the live storages of one rank's local ops.  DTensor's
    shape propagation is not counted: the ops it runs inside
    ``ShardingPropagator._propagate_tensor_meta_non_cached``, and ops on
    ``meta`` tensors (a shape's strides are computed on one)."""

    def __init__(self):
        super().__init__(node_size=H100_SXM["gpus_per_node"])
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._paused = 0
        self._orig = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = self._orig = getattr(ShardingPropagator, _PROPAGATE, None)
        if orig is not None:
            def propagate(prop, *a, **k):
                self._paused += 1
                try:
                    return orig(prop, *a, **k)
                finally:
                    self._paused -= 1

            setattr(ShardingPropagator, _PROPAGATE, propagate)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        if self._orig is not None:
            setattr(ShardingPropagator, _PROPAGATE, self._orig)
        return super().__exit__(*exc)

    def _track(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = _storage_bytes(t)
        self._storages[key] = weakref.ref(st, lambda _, k=key, n=n:
                                          self._free(k, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key, n):
        if self._storages.pop(key, None) is not None:
            self.live -= n

    def observe(self, func, args, kwargs, out):
        ins = _flat(list(args)) + _flat(list(kwargs.values()))
        outs = _flat(out)
        if self._paused or any(t.device.type == "meta" for t in ins + outs):
            return
        super().observe(func, args, kwargs, out)
        for t in outs:
            self._track(t)
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        if func in self._table or func.is_view or not outs or \
                func._overloadpacket in _NO_TRAFFIC:
            return
        self.bytes_accessed += sum(t.numel() * t.element_size()
                                   for t in ins + outs)


_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like, torch.ops.aten.detach,
               torch.ops._c10d_functional.wait_tensor}


def _unique_bytes(ts) -> int:
    """The bytes of the distinct storages under ``ts``."""
    return sum(_storage_bytes(t) for t in
               {id(t.untyped_storage()): t for t in ts}.values())


def local_bytes(tree) -> int:
    """The bytes a device holds for ``tree`` (a model, the optimizer
    state, a batch; DTensors count their local shards): its distinct
    storages, in the caching allocator's 512-byte blocks on CUDA, as
    ``argument_size_in_bytes`` counts them."""
    return _unique_bytes(_tensors(tree))


def account(fn, args) -> dict:
    """Run ``fn(*args)`` once under :class:`_Account`; returns the
    record's ``lower_s``, ``memory_analysis``, ``cost_analysis``,
    ``collectives`` and ``collective_links``."""
    arg_ts = _tensors(list(args))
    arg_keys = {id(t.untyped_storage()) for t in arg_ts}
    acc = _Account()
    for t in arg_ts:   # the arguments are live throughout, not temps
        acc._storages[id(t.untyped_storage())] = None
    t0 = time.time()
    with acc:
        out = fn(*args)
    lower_s = time.time() - t0
    out_ts = _tensors(list(out) if isinstance(out, tuple) else [out])
    aliased = [t for t in out_ts if id(t.untyped_storage()) in arg_keys]
    return {
        "lower_s": lower_s,
        "memory_analysis": {
            "argument_size_in_bytes": _unique_bytes(arg_ts),
            "output_size_in_bytes": _unique_bytes(out_ts),
            "temp_size_in_bytes": acc.peak,
            "alias_size_in_bytes": _unique_bytes(aliased),
        },
        "cost_analysis": {"flops": float(acc.flops),
                          "bytes accessed": float(acc.bytes_accessed)},
        "collectives": acc.stats.to_dict(),
        "collective_links": dict(acc.links),
    }


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name, multi_pod: bool, variant: str,
             out_dir: Path = OUT_DIR, extra_cfg: dict | None = None,
             tag: str = "", alias_out: bool = False,
             device_type: str = "cuda", mesh=None) -> dict:
    """Dry-run one cell and write its record.  Starts (and destroys) a
    ``fake`` group of 256 or 512 ranks, unless ``mesh`` is given: then
    the cell runs on that mesh, whose group the caller owns."""
    mesh_name = "multi" if multi_pod else "single"
    shape = _shape(shape_name)
    shape_name = shape.name
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "tag": tag, "ok": False}
    t0 = time.time()
    own = mesh is None
    try:
        if own:
            start_fake_group(512 if multi_pod else 256)
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=device_type)
        with FakeTensorMode(allow_non_fake_inputs=True), \
                _index_math_unfaked():
            fn, args = build_cell(arch, shape, mesh, variant, extra_cfg,
                                  alias_out, device_type)
            rec.update(account(fn, args))
        rec["compile_s"] = 0.0
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record failures per cell
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
    rec["total_s"] = time.time() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape_name}__{mesh_name}__{variant}"
    if tag:
        name += f"__{tag}"
    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=1))
    status = "OK" if rec["ok"] else f"FAIL: {rec.get('error')}"
    print(f"[dryrun] {name}: {status} ({rec['total_s']:.1f}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--variant", choices=["memory", "cost"], default="memory")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell")
    ap.add_argument("--tag", default="", help="suffix for experiment files")
    ap.add_argument("--cfg", default="",
                    help="comma k=v ModelConfig overrides (perf experiments)")
    ap.add_argument("--alias-out", action="store_true",
                    help="pin out_shardings for donated args (buffer alias)")
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda",
                    help="the fake tensors' device (no card is needed)")
    ap.add_argument("--out-dir", type=Path, default=OUT_DIR)
    args = ap.parse_args(argv)

    extra = {}
    for kv in args.cfg.split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            extra[k] = v

    cells = (runnable_cells() if args.all
             else [(args.arch, args.shape)])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.variant, args.out_dir,
                           extra_cfg=extra or None, tag=args.tag,
                           alias_out=args.alias_out,
                           device_type=args.device_type)
            n_fail += 0 if rec["ok"] else 1
    print(f"[dryrun] done, failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
