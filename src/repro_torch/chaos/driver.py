"""Chaos driver: apply a `ChaosSchedule` to a live gateway-driven run.

The driver owns three jobs:

1. `apply_tool_timeouts` — materialize the schedule's tool-timeout faults
   as a MUTATED COPY of the workload (a victim conversation's mid-turn tool
   latency inflated past the deadline). The same mutated workload feeds the
   chaos run AND the fault-free baseline: tool latency never changes token
   content, so byte-identity still holds while the chaos run additionally
   exercises the watchdog-evict -> replay path.
2. `arm_schedule` — translate fraction-of-span fault times into logical
   seconds and arm each fault on the runtime's own event heap
   (`fail_replica` / `recover_replica` / `inject_slowdown` / `call_at`
   + `inject_transfer_faults`), so faults interleave deterministically with
   serving work.
3. `run_chaos` — drive the workload live through a `ServeGateway` with a
   `PlacementMonitor` attached, optionally holding back a second wave of
   conversations until a node has been OBSERVED rejoining — guaranteeing
   the run contains placements that exercise the rejoined replica.
"""
from __future__ import annotations

import asyncio
import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.conversation import Conversation
from repro_torch.serve.client import GatewayClient
from repro_torch.serve.gateway import ServeGateway

from .invariants import PlacementMonitor
from .schedule import (FAULT_KILL, FAULT_REJOIN, FAULT_SLOWDOWN,
                       FAULT_SLOWDOWN_END, FAULT_TOOL_TIMEOUT,
                       FAULT_TRANSFER, ChaosSchedule)


def apply_tool_timeouts(convs: List[Conversation],
                        schedule: ChaosSchedule,
                        tool_deadline_s: float) -> List[Conversation]:
    """Return a deep copy of `convs` with each tool-timeout fault applied:
    the victim's middle turn's `tool_time_s` is raised to >= 3x the
    deadline, so the runtime's watchdog MUST evict it and the eventual tool
    return MUST re-admit by journaled replay. Victim selection is
    deterministic: multi-turn conversations sorted by cid, indexed by the
    event's `conv_index` modulo their count."""
    out = copy.deepcopy(convs)
    eligible = sorted((c for c in out if c.n_turns >= 2),
                      key=lambda c: c.cid)
    for ev in schedule.of_kind(FAULT_TOOL_TIMEOUT):
        if not eligible:
            raise ValueError("tool-timeout fault scheduled but the workload "
                             "has no multi-turn conversation to victimize")
        victim = eligible[ev.conv_index % len(eligible)]
        mid = (victim.n_turns - 1) // 2  # a turn that HAS a tool wait after
        victim.turns[mid].tool_time_s = max(victim.turns[mid].tool_time_s,
                                            3.0 * tool_deadline_s)
    return out


def arm_schedule(runtime, schedule: ChaosSchedule, span_s: float,
                 t0: float = 0.0) -> None:
    """Arm every runtime-side fault on the runtime's event heap. Fault
    times are `t0 + at_frac * span_s` logical seconds. Tool-timeout events
    are workload-side (see `apply_tool_timeouts`) and skipped here."""
    for ev in schedule.events:
        t = t0 + ev.at_frac * span_s
        if ev.kind == FAULT_KILL:
            runtime.fail_replica(ev.node_id, t)
        elif ev.kind == FAULT_REJOIN:
            runtime.recover_replica(ev.node_id, t)
        elif ev.kind == FAULT_SLOWDOWN:
            runtime.inject_slowdown(ev.node_id, ev.factor, at_s=t)
        elif ev.kind == FAULT_SLOWDOWN_END:
            runtime.inject_slowdown(ev.node_id, 1.0, at_s=t)
        elif ev.kind == FAULT_TRANSFER:
            runtime.call_at(t, lambda n=ev.n: runtime.inject_transfer_faults(n))
        elif ev.kind == FAULT_TOOL_TIMEOUT:
            pass  # applied to the workload before submission


@dataclasses.dataclass
class ChaosRunResult:
    records: list
    gateway: ServeGateway
    client: GatewayClient
    monitor: PlacementMonitor

    @property
    def streams(self) -> Dict[Tuple[int, int], List[int]]:
        return self.gateway.streams


def run_chaos(runtime, convs: List[Conversation], schedule: ChaosSchedule,
              span_s: float, *,
              second_wave: Optional[List[Conversation]] = None,
              quarantine_wave: Optional[List[Conversation]] = None,
              shed_watermark: Optional[int] = None,
              stagger: int = 2, max_events_per_tick: int = 64,
              ticks_between: int = 8) -> ChaosRunResult:
    """Drive `convs` live through a gateway while `schedule`'s faults fire
    mid-flight. Modeled on `serve_scenario_live`, plus:

    * a `PlacementMonitor` subscribed BEFORE any event executes, so every
      placement of the run is checked against the lifecycle contract;
    * an optional `second_wave` staged only after the monitor observes ANY
      `node_join`, and an optional `quarantine_wave` staged only after a
      join with reason ``from_quarantine`` — those conversations'
      placements are guaranteed to see the rejoined node in the
      schedulable set (a cold rejoined node has zero resident KV, exactly
      what min-KV placement prefers), which is the "serves again"
      evidence the invariant checker demands. If a wave's trigger never
      fires it submits once the preceding work is done, so the run still
      completes (and the checker reports the missing evidence).

    The runtime must already have `schedule` armed (see `arm_schedule`) —
    the driver keeps arming and driving separate so offline (non-gateway)
    replays can arm the same schedule identically.
    """
    ordered = sorted(convs, key=lambda c: (c.arrival_s, c.cid))

    def _sorted(w):
        return sorted(w or [], key=lambda c: (c.arrival_s, c.cid))

    waves = [
        (lambda m: bool(m.joins), _sorted(second_wave)),
        (lambda m: any(j.data.get("reason") == "from_quarantine"
                       for j in m.joins), _sorted(quarantine_wave)),
    ]

    async def _run():
        gw = ServeGateway(runtime, shed_watermark=shed_watermark,
                          max_events_per_tick=max_events_per_tick)
        monitor = PlacementMonitor(runtime)
        client = GatewayClient(gw)
        gw.start()
        all_convs = ordered + [c for _, w in waves for c in w]
        consumers = [asyncio.ensure_future(client.collect(c.cid))
                     for c in all_convs]
        for i in range(0, len(ordered), max(stagger, 1)):
            gw.submit(ordered[i:i + max(stagger, 1)])
            for _ in range(ticks_between):
                await asyncio.sleep(0)
        submitted = len(ordered)
        for trigger, wave in waves:
            while wave:
                # liveness fallback: everything already submitted ran dry
                # without the trigger firing — submit anyway so the run
                # completes (the evidence check reports what was missing)
                if trigger(monitor) or len(gw.done_cids) >= submitted:
                    gw.submit(wave)
                    submitted += len(wave)
                    wave = []
                    break
                await asyncio.sleep(0)
        records = await gw.drain()
        await asyncio.gather(*consumers)
        monitor.close()
        return ChaosRunResult(records=records, gateway=gw, client=client,
                              monitor=monitor)

    return asyncio.run(_run())
