"""ConServe: conversation-level disaggregated scheduling (§4).

The whole policy, verbatim from the paper:
  1. Turn-1 prefill routes to the prefiller (least-backlogged when several).
  2. On prefill completion, bind to the decoder with the lowest *active* KV
     occupancy; transfer the KV cache exactly once.
  3. Every later turn executes on the bound decoder. No re-evaluation, no
     migration, no learned cost model, no decode-side prediction — ever.

Both signals read are direct observations (input-token counts; per-decoder
KV occupancy). Straggler avoidance is also observational: decoders whose
measured TBT drifts beyond k× the pool median stop receiving NEW bindings
(already-placed conversations stay put — ConServe never migrates).
"""
from __future__ import annotations

from .conversation import ConversationView, TurnView
from .scheduler import Placement, Scheduler, register
from .signals import ClusterView


@register
class ConServeScheduler(Scheduler):
    name = "conserve"

    def __init__(self, straggler_factor: float = 0.0):
        # 0.0 disables straggler screening (paper's minimal policy);
        # fault-tolerant deployments set e.g. 3.0.
        self.straggler_factor = straggler_factor
        self._bindings = {}

    def place_first_prefill(self, conv: ConversationView,
                            view: ClusterView) -> Placement:
        return Placement(self.least_loaded_prefiller(view))

    def bind_decoder(self, conv: ConversationView,
                     view: ClusterView) -> Placement:
        nid = self.min_kv_decoder(view, self.straggler_factor)
        self._bindings[conv.cid] = nid
        # the one and only KV movement this conversation will ever make
        return Placement(nid, kv_transfer=True)

    def place_turn(self, turn: TurnView, bound_decoder: int,
                   view: ClusterView) -> Placement:
        # Pinned for the conversation's lifetime: local append-prefill with
        # full prefix-cache reuse, zero transfer.
        return Placement(bound_decoder, kv_transfer=False)

    def on_conversation_end(self, cid: int, view: ClusterView) -> None:
        self._bindings.pop(cid, None)


@register
class ConServeRebalanceScheduler(ConServeScheduler):
    """ConServe + occupancy-aware admission re-offer (ROADMAP open item).

    The base policy is unchanged — one-shot binding to the min-KV decoder,
    pinned tail — but a one-shot KV binding PARKED on a saturated decoder is
    re-offered to the eligible decoder with the most observed KV headroom
    (`kv_headroom_tokens`, with a free slot) instead of waiting FIFO behind
    that decoder's own releases. Both inputs are observables the runtime
    already maintains; nothing is predicted. Only decode-role queues are
    touched: a parked admission on a prefill/mixed node is an arrival, not a
    binding, and stays where the placement decision put it."""
    name = "conserve_rebalance"

    def reoffer_admission(self, cid: int, node_id: int,
                          view: ClusterView):
        if view.node(node_id).role != "decode":
            return None
        eligible = [d for d in view.nodes("decode") if d.free_slots > 0]
        if not eligible:
            return None
        best = max(eligible,
                   key=lambda d: (d.kv_headroom_tokens, -d.node_id))
        here = view.node(node_id)
        if best.node_id != node_id and (
                here.free_slots <= 0
                or best.kv_headroom_tokens > here.kv_headroom_tokens):
            return Placement(best.node_id, kv_transfer=True)
        return None


@register
class ConServeSJFRefillScheduler(ConServeScheduler):
    """ConServe + shortest-context-first admission refill (ROADMAP open
    item: a non-trivial `select_refill`).

    The base policy is unchanged — placement, binding and the pinned tail
    are verbatim ConServe — but whenever a node re-offers its admission
    queue (every release point and every decode-rotation chunk cut) the
    parked conversations are tried SHORTEST OBSERVED CONTEXT first instead
    of FIFO. A short-context admission holds its slot for the least KV and
    tends to release it soonest, so draining the queue smallest-first
    maximizes slot turnover under saturation (classic SJF, applied to slot
    residency).

    Observation-only: the context a conversation would land with is
    exactly what the scheduler already SAW at its own decision points —
    `first_input_len` at arrival, `context_tokens + append_tokens` at each
    turn arrival — accumulated the same way ConServe accumulates
    `_bindings`. Nothing decode-side is predicted; a cid this scheduler
    never saw (nothing arrives that way in practice) keeps its FIFO rank.
    Refill order changes WHEN parked work runs, never WHAT it computes:
    per-(cid, turn) token streams are refill-order-invariant by the
    runtime contract, and the unit tests assert both the reorder and the
    invariance."""
    name = "conserve_sjf_refill"

    def __init__(self, straggler_factor: float = 0.0):
        super().__init__(straggler_factor)
        self._seen_ctx = {}  # cid -> last context observed at a decision

    def place_first_prefill(self, conv: ConversationView,
                            view: ClusterView) -> Placement:
        self._seen_ctx[conv.cid] = conv.first_input_len
        return super().place_first_prefill(conv, view)

    def place_turn(self, turn: TurnView, bound_decoder: int,
                   view: ClusterView) -> Placement:
        self._seen_ctx[turn.cid] = turn.context_tokens + turn.append_tokens
        return super().place_turn(turn, bound_decoder, view)

    def on_conversation_end(self, cid: int, view: ClusterView) -> None:
        self._seen_ctx.pop(cid, None)
        super().on_conversation_end(cid, view)

    def select_refill(self, node_id: int, waiting, view: ClusterView):
        fifo_rank = {cid: i for i, cid in enumerate(waiting)}
        return sorted(waiting, key=lambda cid: (
            self._seen_ctx.get(cid, float("inf")), fifo_rank[cid]))
