"""Baselines (§5.1): Collocated, Full Disaggregation, and AMPD (per-turn
prediction-based disaggregation with an injectable wrong-prediction rate —
the paper's structural-brittleness probe, Fig. 12)."""
from __future__ import annotations

import numpy as np

from .conversation import ConversationView, TurnView
from .scheduler import Placement, Scheduler, register
from .signals import ClusterView


@register
class CollocatedScheduler(Scheduler):
    """All replicas are mixed-batch; a conversation lives entirely on one
    replica chosen at arrival (least KV); prefill and decode batch together
    (chunked prefill bounds the per-step stall; interference modeled by the
    runtime per Fig. 5)."""
    name = "collocated"

    def place_first_prefill(self, conv: ConversationView,
                            view: ClusterView) -> Placement:
        nodes = view.nodes("mixed")
        nid = min(nodes, key=lambda n: (n.active_kv_tokens,
                                        n.queued_prefill_tokens)).node_id
        return Placement(nid)

    def bind_decoder(self, conv, view) -> Placement:
        # already on the mixed replica; no transfer
        raise RuntimeError("collocated runtime binds at arrival")

    def place_turn(self, turn: TurnView, bound_decoder: int,
                   view: ClusterView) -> Placement:
        return Placement(bound_decoder, kv_transfer=False)


@register
class FullDisaggScheduler(Scheduler):
    """Every turn's prefill routes through the prefill node (classic PD
    disaggregation applied per-request): pays a KV transfer on every turn and
    forfeits cross-turn prefix reuse on the decoder."""
    name = "full_disagg"

    def place_first_prefill(self, conv: ConversationView,
                            view: ClusterView) -> Placement:
        return Placement(self.least_loaded_prefiller(view))

    def bind_decoder(self, conv: ConversationView,
                     view: ClusterView) -> Placement:
        return Placement(self.min_kv_decoder(view), kv_transfer=True)

    def place_turn(self, turn: TurnView, bound_decoder: int,
                   view: ClusterView) -> Placement:
        # remote append-prefill on the prefiller; KV moves decoder -> prefiller
        # -> decoder (bidirectional, runtime charges both directions)
        return Placement(self.least_loaded_prefiller(view), kv_transfer=True)


@register
class AMPDScheduler(Scheduler):
    """Per-turn prediction-based disaggregation (He et al., 2026), at our
    best effort per §5.1: for every turn-2+ prefill an offline cost model
    picks local-on-decoder vs remote-on-prefiller. In the agentic regime the
    correct answer is always 'local' (appends are uniformly short and carry a
    hot prefix cache), so the per-turn decision collapses to a fixed local
    policy — *except* when the predictor errs. `wrong_prediction_rate`
    injects that error: with probability p the turn migrates to the
    prefiller, paying a bidirectional KV move and adding unanticipated load
    to the saturation-provisioned prefiller (Fig. 12's x-axis)."""
    name = "ampd"

    def __init__(self, wrong_prediction_rate: float = 0.10, seed: int = 0):
        self.p = float(wrong_prediction_rate)
        self.rng = np.random.RandomState(seed)

    def place_first_prefill(self, conv: ConversationView,
                            view: ClusterView) -> Placement:
        return Placement(self.least_loaded_prefiller(view))

    def bind_decoder(self, conv: ConversationView,
                     view: ClusterView) -> Placement:
        return Placement(self.min_kv_decoder(view), kv_transfer=True)

    def _cost_model_says_remote(self, turn: TurnView,
                                view: ClusterView) -> bool:
        """The offline cost model (profiled prefill curve vs an interference
        estimate that, per §5.4, omits decoder KV pressure and prefiller
        queueing). In our traces appends are short, so it returns local;
        its failure mode is modeled by the injected error rate."""
        remote_cost = view.prefill_curve.latency_s(turn.append_tokens)
        local_cost = view.prefill_curve.latency_s(turn.append_tokens) * 0.1
        return remote_cost < local_cost  # never true for short appends

    def place_turn(self, turn: TurnView, bound_decoder: int,
                   view: ClusterView) -> Placement:
        remote = self._cost_model_says_remote(turn, view)
        if self.rng.random_sample() < self.p:
            remote = not remote  # mispredicted turn
        if remote:
            return Placement(self.least_loaded_prefiller(view),
                             kv_transfer=True)
        return Placement(bound_decoder, kv_transfer=False)
