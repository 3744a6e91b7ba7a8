"""Device placement for wave execution: one device per machine.

The port of the reference package's ``repro.core.device_mesh`` for
PyTorch.  Wave lanes are independent, so the reference shards them across
a 1-D ``lanes`` mesh of jax devices.  This module keeps the pieces that
are not kernel code, over ``torch.device``\\ s and for a **single device
per machine**; sharding one machine's lanes across several GPUs is not
ported yet.

* **Device resolution** — :func:`resolve_devices` turns a spec (the
  ``REPRO_SIM_DEVICES`` environment variable, an integer count, a device
  string such as ``"cuda:0"``, or an explicit sequence) into an ordered
  tuple of ``torch.device``\\ s.  The default is the first card,
  ``cuda:0``.  Resolution never looks for a card and never substitutes
  the CPU: a machine placed on a device it cannot use fails when it
  launches there.

* **Per-device dispatch locks** — :func:`dispatch_lock` hands out one
  ``threading.Lock`` per device subset (keyed by the devices' names,
  module-wide).  Machines placed on the same device serialize their
  host-side kernel dispatch on it; machines on different devices do not.

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


def resolve_devices(spec=None) -> tuple:
    """Resolve a device spec to an ordered tuple of ``torch.device``\\ s.

    ``spec`` may be ``None`` (read ``REPRO_SIM_DEVICES``, default
    ``cuda:0``), an integer count or ``"all"`` (the first ``n`` / all
    CUDA devices the host reports, at least ``cuda:0``), a device name or
    comma-separated names, or a sequence of devices (returned as
    ``torch.device``\\ s, in order)."""
    if spec is None:
        spec = os.environ.get(ENV_DEVICES, "").strip() or DEFAULT_DEVICE
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s == "all" or s.isdigit():
            import torch  # noqa: PLC0415
            have = max(torch.cuda.device_count(), 1)
            n = have if s == "all" else min(max(int(s), 1), have)
            return tuple(torch.device("cuda", i) for i in range(n))
        return tuple(_torch_device(x.strip()) for x in s.split(",")
                     if x.strip())
    if isinstance(spec, int):
        return resolve_devices(str(spec))
    return tuple(_torch_device(d) for d in spec)


def device_key(device) -> str:
    """Stable name of a device (``"cuda:0"``, ``"cpu"``): the key of
    dispatch locks and of the per-device telemetry."""
    d = _torch_device(device)
    if d.type == "cuda" and d.index is None:
        return "cuda:0"
    return str(d)


_LOCKS: dict = {}
_REGISTRY_LOCK = threading.Lock()


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
