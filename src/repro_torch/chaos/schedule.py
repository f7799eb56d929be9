"""Seeded, byte-identical chaos schedules.

A `ChaosSchedule` is a pure function of its seed: the same (seed, node_ids)
always generates the same event tuple, serializes to the same JSON bytes and
hashes to the same digest — so a chaos run is as replayable as the workload
it perturbs. Fault times are FRACTIONS of the fault-free serving span, not
absolute seconds: the same schedule scales to any workload once the driver
measures the baseline span.

Fault kinds compose the full failure surface the runtimes expose:

* ``kill``           — `fail_replica(node_id)`: the node dies, in-flight
                       work recovers by journaled deterministic replay.
* ``rejoin``         — `recover_replica(node_id)`: the corpse returns COLD
                       (caches invalidated, resident counters zero).
* ``slowdown``       — `inject_slowdown(node_id, factor)`: measured compute
                       durations stretch on the logical clock; slow, not
                       wrong. Feeds the observed-straggler quarantine.
* ``slowdown_end``   — `inject_slowdown(node_id, 1.0)`.
* ``transfer_fault`` — `inject_transfer_faults(n)`: the next n KV-transfer
                       binds fail once each and retry with bounded backoff.
* ``tool_timeout``   — applied to the WORKLOAD, not the runtime: a victim
                       conversation's mid-turn tool latency is inflated past
                       `tool_deadline_s`, forcing a watchdog eviction and
                       re-admission by replay (`driver.apply_tool_timeouts`).

Every generated schedule guarantees at least one kill -> rejoin cycle, one
sustained slowdown window (sized to trip an EMA-based quarantine and lift
while tails are still observable), one transfer fault and one tool timeout;
kill and slowdown pick DIFFERENT victims so the fleet never loses two
decode-capable nodes to faults at once.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import Counter
from typing import Optional, Sequence, Tuple

import numpy as np

# ----- fault kinds -----------------------------------------------------------
FAULT_KILL = "kill"
FAULT_REJOIN = "rejoin"
FAULT_SLOWDOWN = "slowdown"
FAULT_SLOWDOWN_END = "slowdown_end"
FAULT_TRANSFER = "transfer_fault"
FAULT_TOOL_TIMEOUT = "tool_timeout"

FAULT_KINDS = (FAULT_KILL, FAULT_REJOIN, FAULT_SLOWDOWN, FAULT_SLOWDOWN_END,
               FAULT_TRANSFER, FAULT_TOOL_TIMEOUT)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault. `at_frac` is the firing time as a fraction of
    the fault-free serving span; `node_id` names the victim for node faults,
    `factor` the slowdown multiplier, `n` the transfer-fault count and
    `conv_index` the tool-timeout victim selector (index into the workload's
    multi-turn conversations, sorted by cid)."""
    kind: str
    at_frac: float
    node_id: Optional[int] = None
    factor: float = 1.0
    n: int = 1
    conv_index: Optional[int] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; valid: "
                             f"{', '.join(FAULT_KINDS)}")


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """An ordered, immutable fault plan plus the seed that produced it."""
    seed: int
    events: Tuple[ChaosEvent, ...]

    def to_json(self) -> str:
        """Canonical serialization — the determinism contract's byte form."""
        return json.dumps(
            {"seed": self.seed,
             "events": [dataclasses.asdict(e) for e in self.events]},
            sort_keys=True, separators=(",", ":"))

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()

    def kinds(self) -> Counter:
        return Counter(e.kind for e in self.events)

    def of_kind(self, kind: str) -> Tuple[ChaosEvent, ...]:
        return tuple(e for e in self.events if e.kind == kind)


def generate_chaos_schedule(
        seed: int, node_ids: Sequence[int], *,
        protected: Sequence[int] = (),
        kill_frac_range: Tuple[float, float] = (0.10, 0.30),
        rejoin_delay_frac_range: Tuple[float, float] = (0.15, 0.25),
        slowdown_start_range: Tuple[float, float] = (0.25, 0.40),
        slowdown_len_range: Tuple[float, float] = (0.20, 0.35),
        slowdown_factor_range: Tuple[float, float] = (6.0, 12.0),
        transfer_frac_range: Tuple[float, float] = (0.10, 0.60),
        n_transfer_faults: int = 1) -> ChaosSchedule:
    """Generate the canonical composed schedule: one kill -> rejoin cycle,
    one sustained slowdown window, `n_transfer_faults` transfer faults and
    one tool timeout. Pure over `np.random.RandomState(seed)` — the same
    arguments always yield the same schedule (and digest).

    `node_ids` are the fault-eligible nodes (typically the decode-capable
    fleet); `protected` nodes are never picked as kill/slowdown victims
    (e.g. the sole prefiller). At least two eligible victims are required so
    the kill victim and the slowdown victim differ — the fleet keeps a
    healthy decode path at every point of the schedule.
    """
    eligible = [n for n in node_ids if n not in set(protected)]
    if len(eligible) < 2:
        raise ValueError(
            f"need >= 2 fault-eligible nodes so the kill victim and the "
            f"slowdown victim differ (got eligible={eligible} from "
            f"node_ids={list(node_ids)}, protected={list(protected)})")
    rs = np.random.RandomState(seed)

    def u(lo_hi: Tuple[float, float]) -> float:
        return float(rs.uniform(*lo_hi))

    kill_victim, slow_victim = (
        int(x) for x in rs.choice(eligible, size=2, replace=False))
    kill_t = u(kill_frac_range)
    rejoin_t = kill_t + u(rejoin_delay_frac_range)
    slow_t = u(slowdown_start_range)
    slow_end_t = slow_t + u(slowdown_len_range)
    factor = u(slowdown_factor_range)
    events = [
        ChaosEvent(FAULT_KILL, kill_t, node_id=kill_victim),
        ChaosEvent(FAULT_REJOIN, rejoin_t, node_id=kill_victim),
        ChaosEvent(FAULT_SLOWDOWN, slow_t, node_id=slow_victim,
                   factor=factor),
        ChaosEvent(FAULT_SLOWDOWN_END, slow_end_t, node_id=slow_victim),
    ]
    for _ in range(n_transfer_faults):
        events.append(ChaosEvent(FAULT_TRANSFER, u(transfer_frac_range)))
    # tool timeouts mutate the workload pre-run; at_frac 0 keeps the sorted
    # order honest about when the fault takes effect
    events.append(ChaosEvent(FAULT_TOOL_TIMEOUT, 0.0,
                             conv_index=int(rs.randint(0, 1 << 16))))
    events.sort(key=lambda e: (e.at_frac, e.kind))
    return ChaosSchedule(seed=seed, events=tuple(events))
