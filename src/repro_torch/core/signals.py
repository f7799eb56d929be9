"""The two observable signals ConServe schedules on (§4.2), plus the
restricted cluster view handed to schedulers.

1. The prefill latency curve — profiled OFFLINE as a deterministic function
   of input-token count (quadratic once attention dominates, §3.1). Given an
   incoming conversation's first-turn prompt length the scheduler reads off
   expected prefiller utilization in O(1).
2. Per-decoder *active* KV-cache occupancy — decremented at conversation
   termination so it reflects only live state. For recurrent-state families
   (RWKV6 / RG-LRU) per-token growth is ~0 and the signal degenerates to the
   active-slot count (DESIGN.md §4); both are exposed.

Neither is a forecast; both are properties of state the system already
maintains.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ----- replica lifecycle states ----------------------------------------------
# ACTIVE      — takes placements and refills (the only schedulable state).
# QUARANTINED — observed straggler: its observed_tbt_ema_s exceeded k× the
#               fleet median over a window of observed chunks. Takes no new
#               placements or refills; parked admissions drain to peers;
#               in-flight tails keep running so observations keep flowing.
# DRAINING    — the quarantined node's observed EMA recovered but in-flight
#               tails remain; it re-activates when the last tail leaves.
# A dead node (alive=False) has no lifecycle of its own: revival resets it
# to ACTIVE. All transitions condition on observed state only.
NODE_ACTIVE = "ACTIVE"
NODE_QUARANTINED = "QUARANTINED"
NODE_DRAINING = "DRAINING"


@dataclasses.dataclass
class PrefillLatencyCurve:
    """TTFT(L) = a·L² + b·L + c  (seconds). Fit from offline profiling; the
    quadratic term captures attention, the linear term the projections."""
    a: float
    b: float
    c: float

    def latency_s(self, n_tokens: int) -> float:
        L = float(n_tokens)
        return self.a * L * L + self.b * L + self.c

    @staticmethod
    def fit(lengths: Sequence[int], latencies: Sequence[float]
            ) -> Tuple["PrefillLatencyCurve", float]:
        """Least-squares quadratic fit; returns (curve, R^2)."""
        x = np.asarray(lengths, dtype=np.float64)
        y = np.asarray(latencies, dtype=np.float64)
        A = np.stack([x * x, x, np.ones_like(x)], axis=1)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        pred = A @ coef
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum()) or 1e-12
        return PrefillLatencyCurve(*coef), 1.0 - ss_res / ss_tot


@dataclasses.dataclass
class NodeState:
    """Observable per-node state the runtime maintains and schedulers read."""
    node_id: int
    role: str  # "prefill" | "decode" | "mixed"
    # prefill side
    queued_prefill_tokens: int = 0
    # decode side
    active_kv_tokens: int = 0
    active_conversations: int = 0
    kv_capacity_tokens: int = 300_000
    slot_capacity: int = 64
    # admission / backpressure observables (repro.core.runtime): work parked
    # in this node's admission queue, KV slots currently held, and KV tokens
    # reserved by admitted-but-not-yet-resident work. All three are counters
    # the runtime already maintains — observations, never predictions.
    queued_conversations: int = 0
    used_slots: int = 0
    reserved_kv_tokens: int = 0
    # decode-rotation observables: how well the decode iterations keep their
    # batch lanes busy. `decode_scan_steps` counts scan steps the node ran
    # (every lane computes in lockstep per step), `decode_lane_steps_emitting`
    # counts lane-steps that belonged to an EMITTING slot (live + the masked
    # no-op tail a slot spends frozen after finishing mid-chunk), and
    # `decode_lane_steps_live` counts lane-steps that emitted a real token.
    # All three are counters of work the runtime already dispatched —
    # observations, never predictions; both backends maintain them.
    decode_scan_steps: int = 0
    decode_lane_steps_emitting: int = 0
    decode_lane_steps_live: int = 0
    # health (observation-based straggler signal)
    observed_tbt_ema_s: float = 0.0
    alive: bool = True
    # lifecycle (see module constants): only alive+ACTIVE nodes are visible
    # through ClusterView.nodes(), so schedulers never place on a straggler
    lifecycle: str = NODE_ACTIVE
    # failure-recovery observable: prefill tokens this node computed to
    # REBUILD journaled context after a replica death or tool-deadline
    # eviction — replay work is charged here, never to the victim
    # conversation's TTFET history (Maestro-style honest recovery cost)
    replayed_prefill_tokens: int = 0
    # prefix-KV-pool observables: immutable shared-prefix rows this node
    # holds outside any slot. Counters of pool state/events the runtime
    # already owns (tokens resident, entries, observed reuse hits, evictions)
    # — observations a scheduler may condition prefix-affinity placement on,
    # never predictions of future reuse. Pool capacity is a SEPARATE budget
    # from kv_capacity_tokens: pooled rows never eat slot headroom, so
    # kv_headroom_tokens stays truthful about slot-landable work.
    pooled_prefix_tokens: int = 0
    pooled_prefix_entries: int = 0
    pooled_prefix_hits: int = 0
    pooled_prefix_evictions: int = 0

    @property
    def kv_utilization(self) -> float:
        return self.active_kv_tokens / max(self.kv_capacity_tokens, 1)

    @property
    def free_slots(self) -> int:
        return self.slot_capacity - self.used_slots

    @property
    def kv_headroom_tokens(self) -> int:
        """KV tokens this node can still take on: capacity minus live KV
        minus reservations of admitted-in-flight work."""
        return (self.kv_capacity_tokens - self.active_kv_tokens
                - self.reserved_kv_tokens)

    @property
    def masked_forward_fraction(self) -> float:
        """Fraction of this node's dispatched decode forwards that were
        masked no-ops: lane-steps spent on an emitting slot AFTER its
        per-slot share was exhausted (a slot finishing at step 3 of a
        32-step scan contributes 29 here). The quantity decode rotation
        exists to reclaim; 0.0 when the node never decoded."""
        if self.decode_lane_steps_emitting <= 0:
            return 0.0
        return 1.0 - (self.decode_lane_steps_live
                      / self.decode_lane_steps_emitting)

    @property
    def slot_busy_fraction(self) -> float:
        """Mean fraction of this node's KV slots that emitted a real token
        per executed scan step — lane occupancy including empty lanes, the
        saturation view of the same counters. 0.0 when the node never
        decoded."""
        denom = self.decode_scan_steps * max(self.slot_capacity, 1)
        return self.decode_lane_steps_live / denom if denom > 0 else 0.0


class ClusterView:
    """Read-only window onto observable cluster state. This is the ONLY
    interface scheduler policies receive — placement decisions can condition
    on nothing else (the paper's 'observation, not prediction' contract)."""

    def __init__(self, nodes: Dict[int, NodeState],
                 prefill_curve: PrefillLatencyCurve):
        self._nodes = nodes
        self.prefill_curve = prefill_curve

    def nodes(self, role: Optional[str] = None) -> List[NodeState]:
        out = [n for n in self._nodes.values()
               if n.alive and n.lifecycle == NODE_ACTIVE]
        if role:
            out = [n for n in out if n.role == role]
        return out

    def node(self, node_id: int) -> NodeState:
        return self._nodes[node_id]

    def prefill_backlog_s(self, node_id: int) -> float:
        """Expected time to drain a prefiller's queued input tokens — derived
        from the offline curve, not from any prediction of decode behavior."""
        n = self._nodes[node_id]
        return self.prefill_curve.latency_s(max(n.queued_prefill_tokens, 0))

    def median_decoder_tbt(self) -> float:
        ds = [n.observed_tbt_ema_s for n in self.nodes("decode")
              if n.observed_tbt_ema_s > 0]
        return float(np.median(ds)) if ds else 0.0
