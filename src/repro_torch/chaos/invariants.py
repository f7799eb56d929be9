"""Chaos-run invariants: an inline placement monitor plus the post-run
checker asserting the paper's robustness contract.

The monitor is a PURE event-bus subscriber — it reads `NodeState` exactly at
the moment the runtime publishes each admission event, so a placement on a
dead or quarantined node is caught at the instant it happens (with the
runtime's own loud guards as the second line of defense). It also keeps a
timestamped lifecycle log, which is both the evidence trail the checker
consumes and the availability timeline the chaos benchmark integrates.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.events import (EV_ADMISSION_ADMIT, EV_ADMISSION_PARK,
                               EV_NODE_FAILURE, EV_NODE_JOIN,
                               EV_NODE_QUARANTINE, ServeEvent)
from repro_torch.core.signals import NODE_ACTIVE

from .schedule import (FAULT_KILL, FAULT_SLOWDOWN, FAULT_TOOL_TIMEOUT,
                       FAULT_TRANSFER, ChaosSchedule)


@dataclasses.dataclass
class LifecycleMoment:
    """One observed lifecycle transition: (logical time, event kind,
    node_id, payload)."""
    t: float
    kind: str
    node_id: int
    data: Dict[str, Any]


class PlacementMonitor:
    """Bus subscriber asserting zero placements on dead/quarantined nodes
    and recording the lifecycle evidence trail.

    * every `admission_park` / `admission_admit` target must be alive and
      ACTIVE at publish time (violations are recorded AND raised — a chaos
      run must fail loudly at the moment of the bad placement);
    * `node_failure` / `node_join` / `node_quarantine` moments append to
      `lifecycle_log` (ordered by logical time — the bus is synchronous);
    * admits landing on a node AFTER it was observed joining count toward
      `post_join_admits[node_id]` — the "serves again" evidence.
    """

    KINDS = (EV_ADMISSION_PARK, EV_ADMISSION_ADMIT, EV_NODE_FAILURE,
             EV_NODE_JOIN, EV_NODE_QUARANTINE)

    def __init__(self, runtime):
        self.runtime = runtime
        self.violations: List[str] = []
        self.lifecycle_log: List[LifecycleMoment] = []
        self.joins: List[LifecycleMoment] = []
        self.quarantines: List[LifecycleMoment] = []
        self.failures: List[LifecycleMoment] = []
        self.post_join_admits: Dict[int, int] = {}
        self._joined_nodes: set = set()
        self.n_admissions = 0
        self._unsub = runtime.bus.subscribe(self._on_event, kinds=self.KINDS)

    def close(self):
        self._unsub()

    def _on_event(self, ev: ServeEvent):
        if ev.kind in (EV_ADMISSION_PARK, EV_ADMISSION_ADMIT):
            self.n_admissions += 1
            st = self.runtime.view.node(ev.node_id)
            if not st.alive or st.lifecycle != NODE_ACTIVE:
                msg = (f"t={ev.t:.3f} {ev.kind} for cid {ev.cid} targeted "
                       f"node {ev.node_id} which is "
                       f"{'dead' if not st.alive else st.lifecycle}")
                self.violations.append(msg)
                raise AssertionError(msg)
            if ev.kind == EV_ADMISSION_ADMIT \
                    and ev.node_id in self._joined_nodes:
                self.post_join_admits[ev.node_id] = \
                    self.post_join_admits.get(ev.node_id, 0) + 1
            return
        m = LifecycleMoment(t=ev.t, kind=ev.kind, node_id=ev.node_id,
                            data=dict(ev.data))
        self.lifecycle_log.append(m)
        if ev.kind == EV_NODE_JOIN:
            self.joins.append(m)
            self._joined_nodes.add(ev.node_id)
        elif ev.kind == EV_NODE_QUARANTINE:
            self.quarantines.append(m)
        elif ev.kind == EV_NODE_FAILURE:
            self.failures.append(m)

    # ----- derived metrics ---------------------------------------------------
    def availability_timeline(self, node_ids, t0: float, t1: float
                              ) -> Dict[int, float]:
        """Fraction of [t0, t1] each node spent schedulable (alive AND
        ACTIVE), integrated from the observed lifecycle log. Nodes are
        assumed schedulable at t0 (chaos runs start on a healthy fleet)."""
        out: Dict[int, float] = {}
        span = max(t1 - t0, 1e-9)
        for nid in node_ids:
            moments = [m for m in self.lifecycle_log if m.node_id == nid
                       and t0 <= m.t <= t1]
            up, t_prev, is_up = 0.0, t0, True
            for m in moments:
                if is_up:
                    up += m.t - t_prev
                t_prev = m.t
                is_up = m.kind == EV_NODE_JOIN
            if is_up:
                up += t1 - t_prev
            out[nid] = min(1.0, max(0.0, up / span))
        return out

    def recovery_latencies(self) -> List[float]:
        """Observed dead-interval lengths: failure -> from_dead join, per
        node, in logical seconds."""
        out: List[float] = []
        down_at: Dict[int, float] = {}
        for m in self.lifecycle_log:
            if m.kind == EV_NODE_FAILURE:
                down_at[m.node_id] = m.t
            elif (m.kind == EV_NODE_JOIN
                  and m.data.get("reason") == "from_dead"
                  and m.node_id in down_at):
                out.append(m.t - down_at.pop(m.node_id))
        return out


def check_chaos_invariants(
        records: list, gateway, monitor: PlacementMonitor,
        schedule: ChaosSchedule, convs: list,
        baseline_streams: Dict[Tuple[int, int], Any], *,
        streams: Optional[Dict[Tuple[int, int], Any]] = None,
        require_quarantine: bool = True) -> Dict[str, Any]:
    """Assert the chaos contract on a finished run; returns the evidence
    summary on success, raises `AssertionError` naming the first broken
    invariant otherwise.

    1. COMPLETION — every submitted conversation finished.
    2. STREAM IDENTITY — every per-(cid, turn) stream the gateway
       accumulated is byte-identical to the fault-free baseline
       (`streams` overrides the accumulation compared — the simulator
       backend normalizes its per-turn count lists to totals first).
    3. PLACEMENT — the monitor observed zero placements on dead or
       quarantined nodes.
    4. EVIDENCE — each fault kind in the schedule left its observable
       trace: kill -> a failure AND a from_dead join on the same node;
       slowdown -> a quarantine AND a from_quarantine join AND at least
       one post-join admit somewhere (the rejoined fleet serves again);
       transfer faults / tool timeouts -> runtime retry / eviction
       counters advanced.
    """
    done_cids = {r.cid for r in records}
    want_cids = {c.cid for c in convs}
    missing = sorted(want_cids - done_cids)
    assert not missing, f"conversations never completed: {missing}"

    got_streams = gateway.streams if streams is None else streams
    assert got_streams == baseline_streams, (
        "per-(cid, turn) streams diverged from the fault-free baseline: "
        + _describe_stream_diff(got_streams, baseline_streams))

    assert not monitor.violations, (
        f"placements on dead/quarantined nodes: {monitor.violations}")

    kinds = schedule.kinds()
    evidence: Dict[str, Any] = {
        "n_failures": len(monitor.failures),
        "n_joins": len(monitor.joins),
        "n_quarantines": len(monitor.quarantines),
        "post_join_admits": dict(monitor.post_join_admits),
        "recovery_latencies_s": monitor.recovery_latencies(),
    }
    if kinds.get(FAULT_KILL):
        assert monitor.failures, "schedule kills a node but no node_failure"
        dead_joined = {m.node_id for m in monitor.joins
                       if m.data.get("reason") == "from_dead"}
        killed = {e.node_id for e in schedule.of_kind(FAULT_KILL)}
        assert killed <= dead_joined, (
            f"killed nodes {sorted(killed)} but only {sorted(dead_joined)} "
            f"rejoined from dead")
    if kinds.get(FAULT_SLOWDOWN) and require_quarantine:
        assert monitor.quarantines, (
            "schedule slows a node but no quarantine was observed — the "
            "observed-TBT trigger never tripped (tune factor/window)")
        q_nodes = {m.node_id for m in monitor.quarantines}
        rq_nodes = {m.node_id for m in monitor.joins
                    if m.data.get("reason") == "from_quarantine"}
        assert q_nodes <= rq_nodes, (
            f"quarantined nodes {sorted(q_nodes)} but only "
            f"{sorted(rq_nodes)} rejoined from quarantine")
        served_again = rq_nodes & set(monitor.post_join_admits)
        assert served_again, (
            f"no admission landed on a quarantine-rejoined node "
            f"({sorted(rq_nodes)}) after its join — the replica never "
            f"observably served again (post-join admits: "
            f"{dict(monitor.post_join_admits)})")
    if kinds.get(FAULT_TRANSFER):
        n_retries = getattr(gateway.runtime, "n_transfer_retries", 0)
        assert n_retries >= 1, (
            "schedule arms transfer faults but the runtime observed zero "
            "transfer retries")
        evidence["n_transfer_retries"] = n_retries
    if kinds.get(FAULT_TOOL_TIMEOUT):
        n_evict = getattr(gateway.runtime, "n_tool_evictions", 0)
        n_recovered = sum(1 for r in records if getattr(r, "recovered", False)
                          or getattr(r, "n_tool_evictions", 0) > 0)
        assert n_evict >= 1 or n_recovered >= 1, (
            "schedule inflates a tool latency past the deadline but no "
            "tool eviction/recovery was observed")
        evidence["n_tool_evictions"] = n_evict
    return evidence


def _describe_stream_diff(got: Dict, want: Dict) -> str:
    extra = sorted(set(got) - set(want))
    missing = sorted(set(want) - set(got))
    diff = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    return (f"{len(diff)} mismatched keys (first: {diff[:3]}), "
            f"{len(missing)} missing (first: {missing[:3]}), "
            f"{len(extra)} extra (first: {extra[:3]})")
