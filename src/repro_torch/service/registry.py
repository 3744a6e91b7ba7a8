"""Multi-uarch model registry: the artifact side of uops-as-a-service.

The paper's machine-readable output (§6.4) only pays off if downstream
consumers can *load* it without re-running the tool. The registry discovers
exported XML artifacts (one per microarchitecture, written by
``examples/export_models_torch.py``, its reference twin, or any
:class:`~repro_torch.core.engine.Campaign`),
lazy-loads them on first use, and hot-reloads a uarch whose artifact changed
on disk — so a re-characterization campaign becomes visible to a running
service without a restart.

Artifacts carry the measuring machine's parameter fingerprint
(:func:`~repro_torch.core.engine.machine_fingerprint`). For uarches whose live
definition is known (the simulated cores in ``SIM_UARCHES``), the registry
refuses to serve a model whose fingerprint no longer matches: stale models
must never answer fresh queries, mirroring the measurement-cache rule in
``model_io``.
"""
from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass
from pathlib import Path

from repro_torch.core import model_io
from repro_torch.core.characterize import PerfModel


class ModelNotFoundError(KeyError):
    """No artifact for the requested microarchitecture."""

    def __init__(self, uarch: str, available=()):
        self.uarch = uarch
        self.available = sorted(available)
        super().__init__(f"no model artifact for {uarch!r}; "
                         f"available: {self.available}")

    def __str__(self) -> str:
        return self.args[0]

    def __reduce__(self):  # KeyError's reduce would replay the message
        return (type(self), (self.uarch, self.available))


class StaleModelError(RuntimeError):
    """Artifact fingerprint does not match the live uarch definition."""


@dataclass
class ModelHandle:
    """One loaded artifact. ``version`` bumps on every (re)load, so callers
    (e.g. the service's per-uarch predictors and result caches) can detect
    hot reloads without comparing models."""
    uarch: str
    path: Path
    model: PerfModel
    version: int
    mtime_ns: int
    size: int


def default_expected_fingerprints() -> dict:
    """Fingerprints of the live simulated-uarch definitions: an artifact
    claiming one of these names must have been measured on exactly these
    hidden parameters."""
    from repro_torch.core.engine import machine_fingerprint  # noqa: PLC0415
    from repro_torch.core.isa import TEST_ISA  # noqa: PLC0415
    from repro_torch.core.simulator import SimMachine  # noqa: PLC0415
    from repro_torch.core.uarch import SIM_UARCHES  # noqa: PLC0415

    return {name: machine_fingerprint(SimMachine(ua, TEST_ISA))
            for name, ua in SIM_UARCHES.items()}


class ModelRegistry:
    """Discover / validate / lazy-load / hot-reload exported PerfModels."""

    def __init__(self, models_dir, *, validate: bool = True,
                 expected_fingerprints: dict | None = None):
        self.models_dir = Path(models_dir)
        self.validate = validate
        self._expected = expected_fingerprints
        self._handles: dict[str, ModelHandle] = {}
        self._next_version = 1
        self._lock = threading.RLock()
        self.loads = 0
        self.hot_reloads = 0

    # -- discovery ---------------------------------------------------------
    def _path(self, uarch: str) -> Path:
        """Artifact path for a uarch: XML preferred, JSON fallback (both
        §6.4 export formats round-trip losslessly)."""
        xml = self.models_dir / f"{uarch}.xml"
        if xml.exists():
            return xml
        return self.models_dir / f"{uarch}.json"

    def discover(self) -> list[str]:
        """Microarchitectures with an XML or JSON artifact on disk."""
        if not self.models_dir.is_dir():
            return []
        return sorted({p.stem for p in self.models_dir.glob("*.xml")}
                      | {p.stem for p in self.models_dir.glob("*.json")
                         if not p.name.endswith(".meas.json")})

    def uarches(self) -> list[str]:
        return self.discover()

    # -- validation --------------------------------------------------------
    def _expected_fingerprint(self, uarch: str) -> str | None:
        if self._expected is None:
            self._expected = default_expected_fingerprints()
        return self._expected.get(uarch)

    def _check(self, uarch: str, model: PerfModel, path: Path) -> None:
        if not self.validate:
            return
        expect = self._expected_fingerprint(uarch)
        if expect is None:  # unknown uarch: nothing to validate against
            return
        if not model.fingerprint:
            warnings.warn(f"model artifact {path} carries no machine "
                          f"fingerprint; serving it unvalidated",
                          stacklevel=3)
            return
        if model.fingerprint != expect:
            raise StaleModelError(
                f"model artifact {path} was measured on a different "
                f"{uarch} definition (fingerprint {model.fingerprint[:12]}… "
                f"!= live {expect[:12]}…); re-run the characterization "
                f"campaign and re-export")

    # -- loading -----------------------------------------------------------
    def _load(self, uarch: str, path: Path, *, reload: bool) -> ModelHandle:
        st = path.stat()
        loader = (model_io.load_json if path.suffix == ".json"
                  else model_io.load_xml)
        model = loader(path.read_text())
        if model.uarch != uarch:
            raise ValueError(f"artifact {path} declares uarch "
                             f"{model.uarch!r}, expected {uarch!r}")
        self._check(uarch, model, path)
        handle = ModelHandle(uarch, path, model, self._next_version,
                             st.st_mtime_ns, st.st_size)
        self._next_version += 1
        self._handles[uarch] = handle
        self.loads += 1
        self.hot_reloads += int(reload)
        return handle

    def get(self, uarch: str) -> ModelHandle:
        """Handle for ``uarch``, loading lazily and hot-reloading if the
        artifact changed on disk since the last load."""
        with self._lock:
            path = self._path(uarch)
            if not path.exists():
                self._handles.pop(uarch, None)
                raise ModelNotFoundError(uarch, self.discover())
            handle = self._handles.get(uarch)
            if handle is None:
                return self._load(uarch, path, reload=False)
            st = path.stat()
            if (st.st_mtime_ns, st.st_size) != (handle.mtime_ns, handle.size):
                return self._load(uarch, path, reload=True)
            return handle

    def model(self, uarch: str) -> PerfModel:
        return self.get(uarch).model

    def reload(self, uarch: str | None = None) -> list[str]:
        """Force a reload of one uarch (or all discovered ones)."""
        with self._lock:
            names = [uarch] if uarch is not None else self.discover()
            out = []
            for name in names:
                path = self._path(name)
                if not path.exists():
                    raise ModelNotFoundError(name, self.discover())
                self._load(name, path, reload=name in self._handles)
                out.append(name)
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "models_dir": str(self.models_dir),
                "discovered": self.discover(),
                "loaded": {u: h.version for u, h in self._handles.items()},
                "loads": self.loads,
                "hot_reloads": self.hot_reloads,
                "validate": self.validate,
            }
