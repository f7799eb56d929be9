"""Observation-driven capacity management (§4.2 last paragraph): the same
two signals that drive placement drive scaling. No forecasting — the
autoscaler reacts to measured prefill backlog and aggregate KV pressure."""
from __future__ import annotations

import dataclasses
from typing import Optional

from .hardware import NodeCostModel
from .simulator import ClusterSimulator


@dataclasses.dataclass
class AutoscalerConfig:
    check_interval_s: float = 10.0
    kv_high_watermark: float = 0.85   # aggregate decoder KV utilization
    kv_low_watermark: float = 0.30
    prefill_backlog_high_s: float = 5.0
    provision_delay_s: float = 30.0   # time to bring a replica up
    max_decoders: int = 16
    min_decoders: int = 1


class Autoscaler:
    """Periodically inspects the ClusterView and adds/drains decoder
    replicas. Scale-out uses the same NodeCostModel as existing decoders
    (or a capped tier for heterogeneous growth)."""

    def __init__(self, sim: ClusterSimulator, decoder_cost: NodeCostModel,
                 cfg: Optional[AutoscalerConfig] = None):
        self.sim = sim
        self.cost = decoder_cost
        self.cfg = cfg or AutoscalerConfig()
        self.events = []
        self._pending = 0

    def start(self):
        self.sim.at(self.cfg.check_interval_s, self._tick)
        return self

    def _decoders(self):
        return [n for n in self.sim.nodes.values()
                if n.role == "decode" and n.alive]

    def _parked_admissions(self) -> int:
        """Conversations parked in ANY node's admission queue — work the
        event heap does not see (parked admissions wait for a pump, not a
        timer), so the tick re-arm must count it explicitly."""
        return sum(len(q) for q in self.sim._admission.values())

    def _tick(self):
        sim, cfg = self.sim, self.cfg
        decs = self._decoders()
        if decs:
            # KV pressure counts RESERVED tokens too: admitted-in-flight
            # work holds real headroom (kv_headroom_tokens subtracts it),
            # so ignoring it undercounts pressure exactly when a burst of
            # admissions is about to land and can trigger a scale-IN while
            # the cluster is filling up
            util = (sum(d.state.active_kv_tokens
                        + d.state.reserved_kv_tokens for d in decs)
                    / max(sum(d.state.kv_capacity_tokens for d in decs), 1))
            n_live = len(decs) + self._pending
            if util > cfg.kv_high_watermark and n_live < cfg.max_decoders:
                self._pending += 1
                self.events.append((sim.now, "scale_out_requested", util))

                def up():
                    self._pending -= 1
                    nid = sim.add_decoder(self.cost)
                    self.events.append((sim.now, "scale_out_ready", nid))

                sim.at(sim.now + cfg.provision_delay_s, up)
            elif util < cfg.kv_low_watermark and len(decs) > cfg.min_decoders:
                # drain: stop new bindings by retiring the emptiest decoder
                # once it holds no live conversations AND no parked
                # admissions — then route the retirement through the shared
                # failure/drain contract (Runtime._drain_dead_node) so
                # anything that parked in the same event instant is
                # re-placed through its original scheduler decision point
                # instead of rotting in a dead queue (the old path flipped
                # `alive` directly and stranded parked work)
                cand = min(decs, key=lambda d: d.state.active_conversations)
                if (cand.state.active_conversations == 0
                        and len(sim._admission[cand.node_id]) == 0
                        and len(decs) > cfg.min_decoders):
                    cand.alive = False
                    cand.state.alive = False
                    sim._drain_dead_node(cand.node_id, sim.now)
                    self.events.append((sim.now, "scale_in", cand.node_id))
        # keep ticking while work remains ANYWHERE: heap events, or
        # conversations parked in admission queues (parked work generates
        # no events until something pumps it — a tick that stops on an
        # empty heap can strand it forever)
        if sim._events or self._parked_admissions():
            sim.at(sim.now + cfg.check_interval_s, self._tick)
