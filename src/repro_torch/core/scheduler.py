"""Scheduler interface. The runtime (event simulator or the real JAX engine)
invokes these callbacks; policies answer *where* work runs using only the
observable ClusterView. The runtime owns all mechanism (queues, KV transfer,
batching); schedulers own only placement.

Decision points, per the paper's taxonomy:
  * conversation arrival  -> which node runs the turn-1 prefill
  * prefill completion    -> which decoder the conversation binds to
  * turn 2+ arrival       -> which node runs the append-prefill (per-turn
                             systems decide here; ConServe returns the pinned
                             decoder unconditionally)
  * conversation end      -> occupancy release (handled by runtime; hook
                             provided for stateful policies)
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional

from .conversation import ConversationView, TurnView
from .signals import ClusterView


@dataclasses.dataclass(frozen=True)
class Placement:
    node_id: int
    # Whether this placement requires moving KV state to `node_id` first
    # (remote append-prefill in per-turn systems pays a bidirectional move).
    kv_transfer: bool = False


class Scheduler(abc.ABC):
    """Base scheduler. Subclasses must be pure policies over ClusterView."""

    name = "base"

    @abc.abstractmethod
    def place_first_prefill(self, conv: ConversationView,
                            view: ClusterView) -> Placement:
        ...

    @abc.abstractmethod
    def bind_decoder(self, conv: ConversationView,
                     view: ClusterView) -> Placement:
        """Called when the turn-1 prefill finishes; the returned decoder
        receives the one-shot KV transfer and hosts the tail."""
        ...

    @abc.abstractmethod
    def place_turn(self, turn: TurnView, bound_decoder: int,
                   view: ClusterView) -> Placement:
        ...

    def on_conversation_end(self, cid: int, view: ClusterView) -> None:
        pass

    def reoffer_admission(self, cid: int, node_id: int,
                          view: ClusterView) -> Optional[Placement]:
        """Optional defer/re-offer decision point (repro.core.runtime).

        Called whenever `node_id` re-offers its admission queue (every
        release point, plus every decode-rotation chunk cut) with `cid` the
        next conversation `select_refill` picked — consulted BEFORE the
        capacity check, so a policy can drain a still-full node's queue
        toward idle peers. Return None (the default) to admit on `node_id`
        when it has capacity — FIFO, no policy involvement, which keeps
        ConServe and the baselines pure over ClusterView — or a Placement
        naming a different node to move the waiting work there instead."""
        return None

    def select_refill(self, node_id: int, waiting: List[int],
                      view: ClusterView) -> Optional[List[int]]:
        """Optional mid-tail refill ordering decision point.

        Called whenever `node_id` re-offers its admission queue — at every
        release point and at every decode-rotation chunk cut. `waiting` is
        the queue's conversation ids in FIFO order. Return None (the
        default) to refill strictly FIFO — no policy involvement, which
        keeps ConServe and the baselines pure over ClusterView — or a
        reordered list of cids naming the admission order to try instead
        (cids not in `waiting` are ignored; an empty list falls back to
        FIFO). Token streams are keyed per (cid, turn), so any refill
        ordering produces byte-identical per-conversation output — the
        hook decides WHEN work runs, never WHAT it computes."""
        return None

    # -- shared helpers -------------------------------------------------------
    @staticmethod
    def least_loaded_prefiller(view: ClusterView) -> int:
        pf = view.nodes("prefill")
        if not pf:  # collocated deployments have no dedicated prefiller
            pf = view.nodes("mixed")
        if not pf:
            # view.nodes() filters dead nodes: overlapping failures can
            # leave no prefill-capable node at all — name the condition
            # instead of a bare min() ValueError
            raise RuntimeError(
                "no healthy prefill-capable node (prefill or mixed) left "
                "in the cluster; cannot place prefill work")
        return min(pf, key=lambda n: n.queued_prefill_tokens).node_id

    @staticmethod
    def min_kv_decoder(view: ClusterView, straggler_factor: float = 0.0) -> int:
        """Decoder with lowest *active* KV occupancy (ties: fewest slots).
        With straggler_factor > 0, decoders whose observed TBT exceeds
        factor × pool median are excluded from NEW bindings — observation-
        based straggler mitigation (no prediction involved)."""
        ds = view.nodes("decode")
        if not ds:
            raise RuntimeError(
                "no healthy decoder left in the cluster; cannot bind "
                "conversations (view.nodes() filters dead nodes)")
        if straggler_factor:
            med = view.median_decoder_tbt()
            if med > 0:
                healthy = [d for d in ds
                           if d.observed_tbt_ema_s <= straggler_factor * med]
                if healthy:
                    ds = healthy
        return min(ds, key=lambda n: (n.active_kv_tokens,
                                      n.active_conversations)).node_id

    @staticmethod
    def prefix_pool_pressure(view: ClusterView, node_id: int) -> float:
        """Observed churn of a node's prefix KV pool: evictions per recorded
        hit (0.0 for an idle or perfectly-retaining pool). Built purely from
        the `pooled_prefix_*` counters the runtime maintains — a policy may
        use it to prefer nodes whose pools are NOT thrashing when placing
        turn-1 prefills of shared-preamble conversations (the ConversationView
        carries `preamble_id`, observable at arrival). No prediction of
        future reuse is involved: both inputs count events that already
        happened."""
        n = view.node(node_id)
        if n.pooled_prefix_hits <= 0:
            return float(n.pooled_prefix_evictions)
        return n.pooled_prefix_evictions / n.pooled_prefix_hits


SCHEDULERS: Dict[str, type] = {}


def register(cls):
    SCHEDULERS[cls.name] = cls
    return cls


def make_scheduler(name: str, **kw) -> Scheduler:
    return SCHEDULERS[name](**kw)
