"""Lane-axis device placement: one machine's waves over several devices.

The port of the reference package's ``repro.core.device_mesh`` for
PyTorch.  Wave lanes are independent, so the natural multi-device
decomposition is a **1-D mesh over a single ``lanes`` axis**: every device
runs the same wave-dispatch kernel on its own contiguous block of a
chunk's experiment lanes (the reference wraps its kernel in ``shard_map``;
here the executor launches one kernel a block, each on its device's
current stream, see ``core/batch_sim.py``).  This module keeps the pieces
that are not kernel code, over ``torch.device``\\ s:

* **Device resolution** — :func:`resolve_devices` turns a spec (the
  ``REPRO_SIM_DEVICES`` environment variable, an integer count, ``"all"``,
  device names such as ``"cuda:0,cuda:1"``, or an explicit sequence) into
  an ordered tuple of ``torch.device``\\ s.  The default is every card
  (:func:`cuda_devices`), at least ``cuda:0``.  Resolution never
  substitutes the CPU: a machine placed on a card it cannot use fails when
  it launches there.  A placement may name one device more than once:
  each entry is one logical device, one lane block (``("cpu",) * 4``
  stands in for four devices on a CPU host, ``("cuda:0", "cuda:0")`` runs
  two blocks on one card).  :func:`resolve_device` picks the one device of
  a single-device entry point and raises when a card is asked for and the
  host has none.

* **Lane meshes** — :class:`LaneMesh` holds an ordered device subset and
  each device's current stream at dispatch; :func:`lane_mesh` memoizes one
  per subset, so every chunk of one mesh width shares it.

* **Per-device dispatch locks** — :func:`dispatch_lock` hands out one
  ``threading.Lock`` per device subset (keyed by the devices' sorted
  names, module-wide).  Machines placed on the same subset serialize their
  host-side kernel dispatch on it; machines on disjoint subsets do not.

* **Campaign placement** — :func:`partition` splits the resolved devices
  into per-machine groups: contiguous disjoint blocks when there are at
  least as many devices as machines, round-robin shared singletons
  otherwise.
"""
from __future__ import annotations

import os
import threading

from repro_torch.obs import tracer as obs

# user-facing device knob: a count, "all", or device names ("cuda:0,cuda:1")
ENV_DEVICES = "REPRO_SIM_DEVICES"
DEFAULT_DEVICE = "cuda:0"


def _torch_device(d):
    import torch  # noqa: PLC0415
    return d if isinstance(d, torch.device) else torch.device(d)


def cuda_devices() -> tuple:
    """Every CUDA device the host has, in index order; ``()`` without a
    card (never the CPU in a card's place)."""
    import torch  # noqa: PLC0415
    if not torch.cuda.is_available():
        return ()
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def resolve_devices(spec=None) -> tuple:
    """Resolve a device spec to an ordered tuple of ``torch.device``\\ s.

    ``spec`` may be ``None`` (read ``REPRO_SIM_DEVICES``, default
    ``"all"``), an integer count or ``"all"`` (the first ``n`` / all cards
    of :func:`cuda_devices`, clamped to ``[1, available]``, and ``cuda:0``
    on a host without one), a device name or comma-separated names, a
    ``torch.device``, or a sequence of devices (returned as
    ``torch.device``\\ s, in order).  Names and sequences may repeat a
    device: each entry is one lane block."""
    import torch  # noqa: PLC0415
    if spec is None:
        spec = os.environ.get(ENV_DEVICES, "").strip() or "all"
    if isinstance(spec, torch.device):
        return (spec,)
    n = None
    if isinstance(spec, int):
        n = spec
    elif isinstance(spec, str):
        s = spec.strip().lower()
        if s != "all" and not s.isdigit():
            return tuple(_torch_device(x.strip()) for x in s.split(",")
                         if x.strip())
        n = None if s == "all" else int(s)
    else:
        return tuple(_torch_device(d) for d in spec)
    cards = cuda_devices() or (torch.device(DEFAULT_DEVICE),)
    return cards if n is None else cards[:min(max(n, 1), len(cards))]


def resolve_device(device=None):
    """One ``torch.device`` for an entry point that runs on a single
    device: ``None`` is the first card, ``cuda:0``.  Asking for a CUDA
    device on a host without one raises instead of running on the CPU."""
    import torch  # noqa: PLC0415
    d = _torch_device(DEFAULT_DEVICE if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{d} requested but no CUDA device is available")
    return d


def device_key(device) -> str:
    """Stable name of a device (``"cuda:0"``, ``"cpu"``): the key of
    dispatch locks and of the per-device telemetry."""
    d = _torch_device(device)
    if d.type == "cuda" and d.index is None:
        return "cuda:0"
    return str(d)


class LaneMesh:
    """A 1-D ``lanes`` mesh over an ordered device subset: lane block ``k``
    of a chunk runs on ``devices[k]``.  What the wave executor needs of it
    is the ordered devices, their names (``key``, the cache identity) and
    each device's current stream at dispatch (:meth:`streams`)."""

    __slots__ = ("devices", "n", "key")

    def __init__(self, devices):
        self.devices = tuple(_torch_device(d) for d in devices)
        self.n = len(self.devices)
        self.key = tuple(device_key(d) for d in self.devices)

    def streams(self) -> tuple:
        """Each device's current stream, read now (``None`` for a CPU
        device): a block's kernel launches on it."""
        import torch  # noqa: PLC0415
        return tuple(torch.cuda.current_stream(d) if d.type == "cuda"
                     else None for d in self.devices)

    def __repr__(self):
        return f"<LaneMesh lanes={self.n} devices={list(self.key)}>"


_MESHES: dict = {}
_LOCKS: dict = {}
_REGISTRY_LOCK = threading.Lock()


def lane_mesh(devices) -> LaneMesh:
    """Memoized :class:`LaneMesh` for an ordered device tuple (meshes are
    shared across machines and buckets)."""
    key = tuple(device_key(d) for d in devices)
    with _REGISTRY_LOCK:
        m = _MESHES.get(key)
        if m is None:
            with obs.span("mesh.build", devices=list(key)):
                m = _MESHES[key] = LaneMesh(devices)
        return m


def dispatch_lock(devices) -> threading.Lock:
    """The per-device-subset dispatch lock (module-wide, keyed by sorted
    device names; the empty subset shares one host lock).  Machines placed
    on the same subset serialize their host-side kernel dispatch on it;
    disjoint subsets get independent locks."""
    key = (tuple(sorted(device_key(d) for d in devices)) if devices
           else ("host",))
    with _REGISTRY_LOCK:
        lk = _LOCKS.get(key)
        if lk is None:
            lk = _LOCKS[key] = threading.Lock()
        return lk


def partition(devices, n_groups: int) -> list:
    """Split ``devices`` into ``n_groups`` placement groups for a
    campaign's machines: contiguous **disjoint** blocks (balanced to
    within one device) when ``len(devices) >= n_groups``, round-robin
    shared singletons when there are fewer devices than machines, and
    empty groups (no placement) when there are no devices."""
    devices = tuple(devices)
    if n_groups <= 0:
        return []
    d = len(devices)
    if d == 0:
        groups = [() for _ in range(n_groups)]
    elif d >= n_groups:
        groups = [devices[i * d // n_groups:(i + 1) * d // n_groups]
                  for i in range(n_groups)]
    else:
        groups = [(devices[i % d],) for i in range(n_groups)]
    if obs.enabled():
        obs.instant("mesh.partition", devices=d, groups=n_groups,
                    placement=[[str(dev) for dev in g] for g in groups])
    return groups
