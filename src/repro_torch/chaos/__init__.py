"""Seeded chaos harness for the serving runtimes: byte-identical fault
schedules (`schedule`), a live gateway driver that arms and applies them
mid-flight (`driver`), and the invariant monitor/checker asserting the
robustness contract — completion, stream byte-identity vs the fault-free
baseline, zero placements on dead or quarantined nodes (`invariants`)."""
from .driver import (ChaosRunResult, apply_tool_timeouts, arm_schedule,
                     run_chaos)
from .invariants import (LifecycleMoment, PlacementMonitor,
                         check_chaos_invariants)
from .schedule import (FAULT_KILL, FAULT_KINDS, FAULT_REJOIN, FAULT_SLOWDOWN,
                       FAULT_SLOWDOWN_END, FAULT_TOOL_TIMEOUT, FAULT_TRANSFER,
                       ChaosEvent, ChaosSchedule, generate_chaos_schedule)

__all__ = [
    "ChaosEvent", "ChaosSchedule", "generate_chaos_schedule",
    "FAULT_KILL", "FAULT_REJOIN", "FAULT_SLOWDOWN", "FAULT_SLOWDOWN_END",
    "FAULT_TRANSFER", "FAULT_TOOL_TIMEOUT", "FAULT_KINDS",
    "apply_tool_timeouts", "arm_schedule", "run_chaos", "ChaosRunResult",
    "PlacementMonitor", "LifecycleMoment", "check_chaos_invariants",
]
