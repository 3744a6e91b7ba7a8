"""Deprecated shim: this module moved to :mod:`repro_torch.faults.tolerance`.

The port of the reference package's ``repro.runtime.fault_tolerance``.
The seed-era fault-tolerance objects (StragglerDetector, FleetMonitor,
StepTimer) now live in the faults package, wired to real per-device
kernel timings (see README §Robustness). Import from
``repro_torch.faults``.
"""
import warnings

from repro_torch.faults.tolerance import (FleetMonitor,  # noqa: F401
                                          StepTimer, StragglerDetector)

warnings.warn("repro_torch.runtime.fault_tolerance moved to "
              "repro_torch.faults.tolerance; this shim will be removed",
              DeprecationWarning, stacklevel=2)

__all__ = ["FleetMonitor", "StepTimer", "StragglerDetector"]
