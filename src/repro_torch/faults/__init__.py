"""Deterministic fault injection + fault-tolerance policies.

``repro_torch.faults.plan`` is the seeded injection plane (``REPRO_FAULTS``);
``repro_torch.faults.tolerance`` holds the straggler/fleet policy objects the
resilience layers feed. See README §Robustness.
"""
from repro_torch.faults.plan import (FaultPlan, FaultRule, FiredFault,
                                     InjectedFault, MODES, POINTS, active, check,
                                     check_wave, filter_bytes, get_plan,
                                     plan_from_env, set_plan)
from repro_torch.faults.tolerance import FleetMonitor, StepTimer, StragglerDetector

__all__ = [
    "FaultPlan", "FaultRule", "FiredFault", "InjectedFault", "MODES",
    "POINTS", "active", "check", "check_wave", "filter_bytes", "get_plan",
    "plan_from_env", "set_plan",
    "FleetMonitor", "StepTimer", "StragglerDetector",
]
