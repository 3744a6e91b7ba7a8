"""Sharded, compressed, atomic checkpoints with async save and elastic
restore (restore onto a different data-parallel shard count).

The port of the reference package's ``repro.checkpoint.checkpoint``, in
its on-disk format: a directory ``<step>.ckpt/`` holding
``manifest.json`` plus one compressed binary file per (leaf, chunk) —
zstd when the ``zstandard`` wheel imports, zlib otherwise (the codec is
recorded in the manifest, so either writer's checkpoints restore
anywhere).  Leaves are chunked along axis 0, so a checkpoint written with
N chunks can be restored by M != N workers, each re-slicing its own shard.
Writes go to ``.tmp`` and are renamed only after fsync: a killed writer
never corrupts the latest checkpoint.

Leaves are flattened in ``jax.tree_util``'s order
(:mod:`repro_torch.tree_util`: dict keys sorted, the model as the dict of
its parameter tree, tuple and ``NamedTuple`` fields in order) and written
byte for byte as the reference writes the same values, bfloat16 carried
through ``uint16``; so a checkpoint of ``(model, AdamWState)`` written by
either package restores in the other.  The manifest's ``treedef`` is each
package's own string, and neither restore reads it.

The (leaf, chunk) files are compressed and decompressed by a pool of
threads (zlib and zstd release the interpreter lock), with the same bytes
as one thread would write.

A sharded tree (DTensor leaves, on a mesh) is saved in the same format:
every rank gathers each leaf whole (``full_tensor()``), rank 0 writes, and
every rank then waits at a barrier, so the files a rank goes on to read
exist.  On restore each rank reads the whole leaves and places each as
its ``like_tree`` leaf is placed.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.tree_util import tree_flatten, tree_unflatten, treedef_str

try:
    import zstandard as zstd
except ModuleNotFoundError:  # optional dep: fall back to stdlib zlib
    zstd = None

DEFAULT_CODEC = "zstd" if zstd is not None else "zlib"


def _compress(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return zstd.ZstdCompressor(level=3).compress(data)
    return zlib.compress(data, 3)


def _decompress(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError(
                "checkpoint was written with zstd but the 'zstandard' "
                "package is not installed")
        return zstd.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)


def _workers() -> int:
    return min(8, os.cpu_count() or 1)


class _HostLeaf:
    """A leaf copied to host memory: its array and its manifest dtype."""
    __slots__ = ("arr", "dtype")

    def __init__(self, arr: np.ndarray, dtype: str):
        self.arr, self.dtype = arr, dtype


def _to_host(leaf) -> _HostLeaf:
    """A leaf as a host array and its manifest dtype: a tensor is copied,
    and bfloat16 (a tensor's, or numpy's extension dtype) is carried as
    its uint16 bits."""
    if isinstance(leaf, _HostLeaf):
        return leaf
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()  # a collective: every rank gathers
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _HostLeaf(t.view(torch.int16).numpy().view(np.uint16),
                             "bfloat16")
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return _HostLeaf(arr.view(np.uint16), "bfloat16")
    return _HostLeaf(arr, str(arr.dtype))


def snapshot(tree):
    """``tree`` with every leaf copied to host memory now: what
    :func:`save_checkpoint` writes, whatever later happens to the
    tensors.  A DTensor leaf is gathered whole, so on a mesh every rank
    takes the snapshot together."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [_to_host(l) for l in leaves])


def _sharded(tree) -> bool:
    return any(isinstance(l, DTensor) for l in tree_flatten(tree)[0])


def _writer() -> bool:
    """True on the rank that writes a sharded tree's files (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory, step: int, tree, *, chunks: int = 1,
                    metadata: dict | None = None) -> Path:
    """Synchronous save. ``chunks``: shards per leaf along axis 0 (leaves
    with axis0 % chunks != 0 or scalars are stored unchunked).  A sharded
    tree is saved by every rank together (see the module docstring)."""
    if _sharded(tree):
        host = snapshot(tree)
        final = Path(directory) / f"{step:08d}.ckpt"
        if _writer():
            final = save_checkpoint(directory, step, host, chunks=chunks,
                                    metadata=metadata)
        dist.barrier()
        return final
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"{step:08d}.ckpt"
    tmp = directory / f"{step:08d}.ckpt.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, treedef = tree_flatten(tree)
    codec = DEFAULT_CODEC
    manifest = {"step": step, "metadata": metadata or {}, "codec": codec,
                "treedef": treedef_str(treedef), "leaves": []}
    jobs = []
    for i, leaf in enumerate(leaves):
        host = _to_host(leaf)
        arr, dt = host.arr, host.dtype
        n_chunks = chunks if (arr.ndim > 0 and arr.shape[0] % chunks == 0
                              and arr.shape[0] >= chunks) else 1
        rec = {"index": i, "shape": list(arr.shape), "dtype": dt,
               "chunks": n_chunks, "files": []}
        for c in range(n_chunks):
            part = arr[c * arr.shape[0] // n_chunks:
                       (c + 1) * arr.shape[0] // n_chunks] \
                if n_chunks > 1 else arr
            fname = f"leaf{i:05d}_{c:03d}.zst"
            jobs.append((tmp / fname, part))
            rec["files"].append(fname)
        manifest["leaves"].append(rec)

    def write(job):
        path, part = job
        path.write_bytes(_compress(np.ascontiguousarray(part).data, codec))

    # the largest files first, so that no long one starts last
    jobs.sort(key=lambda job: -job[1].nbytes)
    with ThreadPoolExecutor(_workers()) as pool:
        for _ in pool.map(write, jobs):
            pass
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    fd = os.open(tmp, os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _tensor(raw: bytes, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.uint16).copy()
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype)).copy())


def restore_checkpoint(path, like_tree, *, shard_index: int = 0,
                       num_shards: int = 1):
    """Restore; with num_shards > 1 only the slice owned by this worker is
    materialized for axis-0-chunked leaves (elastic: the file chunk count
    need not match num_shards).  Returns (step, tree, metadata): ``tree``
    has ``like_tree``'s structure (a model in it comes back as the nested
    dict of its parameters) and tensor leaves, each on the device of its
    ``like_tree`` leaf where that is a tensor, else on the CPU; a DTensor
    ``like_tree`` leaf gives a DTensor placed as it is."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    codec = manifest.get("codec", "zstd")  # pre-codec checkpoints were zstd
    like_leaves, treedef = tree_flatten(like_tree)
    if len(like_leaves) != len(manifest["leaves"]):
        raise ValueError(f"{path}: {len(manifest['leaves'])} leaves, the "
                         f"like tree has {len(like_leaves)}")
    files = [(rec, fname) for rec in manifest["leaves"]
             for fname in rec["files"]]

    def read(job):
        rec, fname = job
        return _decompress((path / fname).read_bytes(), codec)

    with ThreadPoolExecutor(_workers()) as pool:
        raws = iter(list(pool.map(read, files)))
    out = []
    for rec, like in zip(manifest["leaves"], like_leaves):
        parts = [_tensor(next(raws), rec["dtype"]) for _ in rec["files"]]
        t = torch.cat(parts) if len(parts) > 1 else parts[0]
        t = t.reshape(rec["shape"])
        if num_shards > 1 and t.dim() > 0 and t.shape[0] % num_shards == 0:
            n = t.shape[0] // num_shards
            t = t[shard_index * n:(shard_index + 1) * n]
        if isinstance(like, DTensor):
            t = distribute_tensor(t.to(like.device), like.device_mesh,
                                  like.placements, src_data_rank=None)
        elif isinstance(like, torch.Tensor):
            t = t.to(like.device)
        out.append(t)
    tree = tree_unflatten(treedef, out)
    return manifest["step"], tree, manifest["metadata"]


def latest_checkpoint(directory) -> Path | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    cands = sorted(p for p in directory.iterdir()
                   if p.suffix == ".ckpt" and p.is_dir())
    return cands[-1] if cands else None


class CheckpointManager:
    """Periodic async checkpoints with retention, for the training loop.

    A sharded tree's snapshot is gathered by every rank; rank 0 writes it
    on its thread, and :meth:`wait` (which every rank reaches at the same
    points: the next save, a restore, the end of a run) then holds every
    rank at a barrier until the files exist."""

    def __init__(self, directory, *, interval: int = 100, keep: int = 3,
                 chunks: int = 1):
        self.directory = Path(directory)
        self.interval = interval
        self.keep = keep
        self.chunks = chunks
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._barrier = False

    def maybe_save(self, step: int, tree, metadata=None, *,
                   force: bool = False):
        if not force and (step == 0 or step % self.interval != 0):
            return False
        self.wait()
        # snapshot copies on the caller's thread: the next training step
        # updates the parameters and the optimizer state in place
        self._barrier = _sharded(tree)
        host = snapshot(tree)
        if not _writer():
            return True

        def work():
            try:
                save_checkpoint(self.directory, step, host,
                                chunks=self.chunks, metadata=metadata)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        cands = sorted(p for p in self.directory.iterdir()
                       if p.suffix == ".ckpt" and p.is_dir())
        for p in cands[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    def restore_latest(self, like_tree, **kw):
        self.wait()
        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        return restore_checkpoint(path, like_tree, **kw)
