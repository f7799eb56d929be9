"""Async serving gateway: live streaming admission over the shared `Runtime`
contract, working identically against both backends.

The gateway is a FRONT END, not a third runtime. Everything it reports is a
read of state the runtime already owns, delivered through the event bus
(`repro_torch.core.events`) whose hooks fire from the runtime's own transition
points:

* per-token streams come from the decode rotation's finish events (the
  engine holds the authoritative per-(cid, turn) stream in `_TurnTask
  .stream`; the simulator emits at turn granularity — counts, no bytes);
* session progress comes from `ServeSession.transition`'s notify hook;
* health comes from the same `NodeState` observables schedulers read
  (`kv_headroom_tokens`, `queued_conversations`, `masked_forward_fraction`);
* backpressure comes from admission park/admit events plus the circuit
  breaker below, which REFUSES new work loudly (`GatewayOverloaded`) when
  every live node's admission queue exceeds a watermark — refusal is an
  observable signal, never a crash of in-flight work.

Because both backends run a logical clock behind `run_pending()`, the
gateway drives them incrementally from an asyncio loop: staged submissions
inject between event batches (the runtimes clamp past arrival timestamps to
now), and token callbacks fan out to per-conversation asyncio queues that
`stream(cid)` consumes. Determinism is preserved — the event heap orders
execution, the gateway only observes — so a live-submitted workload streams
byte-identically to an offline `Runtime.serve()` replay of the same trace,
including across an injected replica failure (the `recovery` event rewinds
the interrupted turn's accumulation; deterministic replay re-streams it
byte-for-byte).
"""
from __future__ import annotations

import asyncio
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.conversation import Conversation
from repro_torch.core.events import (EV_NODE_JOIN, EV_NODE_QUARANTINE, EV_RECOVERY,
                               EV_SESSION, EV_TOKENS, ServeEvent)
from repro_torch.core.runtime import DONE, Runtime


class GatewayOverloaded(RuntimeError):
    """Raised by `ServeGateway.submit` when the circuit breaker sheds new
    admissions: every live node's admission queue is deeper than the
    watermark. In-flight conversations are untouched — the caller is told
    to back off, which is the observable backpressure contract.

    Carries two observed quantities so callers can back off intelligently
    (both read straight from `NodeState` at shed time — no new bookkeeping):

    * `min_queue_depth` — the SHALLOWEST live node's admission-queue depth
      (by definition > watermark, or nothing would have shed);
    * `retry_after_s` — a drain-rate-derived hint: the shallowest node's
      queue depth × its observed mean resident context × its observed TBT
      EMA. 0.0 when that node has no decode observations yet (nothing
      observed means no basis for a hint — the contract forbids inventing
      a prediction).
    """

    def __init__(self, message: str, *,
                 min_queue_depth: Optional[int] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.min_queue_depth = min_queue_depth
        self.retry_after_s = retry_after_s


class ServeGateway:
    """Asyncio front end over one `Runtime`.

    Usage::

        gw = ServeGateway(runtime, shed_watermark=8)
        gw.start()                      # spawn the drive loop
        gw.submit(first_batch)          # stage arrivals (may raise
        ...                             #   GatewayOverloaded)
        async for kind, *rest in gw.stream(cid): ...
        records = await gw.drain()      # stop accepting, finish, close

    `streams` accumulates per-(cid, turn_idx) emissions: token-id lists on
    the engine backend (concatenated chunk payloads — byte-identical to the
    engine's own `sampled_tokens`), per-turn count lists on the simulator
    (one entry per completed turn). A `recovery` event resets the
    interrupted turn's key; replay then re-streams it.
    """

    def __init__(self, runtime: Runtime, *,
                 shed_watermark: Optional[int] = None,
                 max_events_per_tick: int = 64):
        self.runtime = runtime
        self.shed_watermark = shed_watermark
        self.max_events_per_tick = int(max_events_per_tick)
        # (cid, turn_idx) -> accumulated emission (ids or per-turn counts)
        self.streams: Dict[Tuple[int, int], List[int]] = {}
        # cid -> logical time of the first streamed token ever observed
        self.first_token_t: Dict[int, float] = {}
        self.done_cids: set = set()
        self.n_shed = 0
        self.n_submitted = 0
        self.events_seen: Counter = Counter()
        self._pending: List[Conversation] = []
        self._queues: Dict[int, asyncio.Queue] = {}
        self._accepting = True
        self._task: Optional[asyncio.Task] = None
        self._unsub = runtime.bus.subscribe(self._on_event)

    # ----- event-bus subscriber ---------------------------------------------
    def _on_event(self, ev: ServeEvent):
        self.events_seen[ev.kind] += 1
        if ev.kind == EV_TOKENS:
            key = (ev.cid, ev.turn_idx)
            buf = self.streams.setdefault(key, [])
            if "tokens" in ev.data:          # engine: actual token ids
                buf.extend(ev.data["tokens"])
                payload: Any = ev.data["tokens"]
            else:                            # simulator: turn-level count
                buf.append(int(ev.data["n_tokens"]))
                payload = ev.data["n_tokens"]
            self.first_token_t.setdefault(ev.cid, ev.t)
            self._q(ev.cid).put_nowait(("tokens", ev.turn_idx, payload))
        elif ev.kind == EV_RECOVERY:
            # deterministic replay will re-stream this in-flight turn from
            # scratch: drop the stale accumulation and tell consumers
            self.streams.pop((ev.cid, ev.turn_idx), None)
            self._q(ev.cid).put_nowait(("rewind", ev.turn_idx))
        elif ev.kind == EV_SESSION and ev.data.get("state") == DONE:
            self.done_cids.add(ev.cid)
            self._q(ev.cid).put_nowait(("done",))

    def _q(self, cid: int) -> asyncio.Queue:
        q = self._queues.get(cid)
        if q is None:
            q = self._queues[cid] = asyncio.Queue()
        return q

    # ----- admission (with circuit breaker) ---------------------------------
    def submit(self, convs: List[Conversation]) -> "ServeGateway":
        """Stage conversations for live injection at the next drive tick.
        Sheds (raises `GatewayOverloaded`) when every live node's admission
        queue exceeds the watermark — overload refuses new work, it never
        crashes work already admitted."""
        if not self._accepting:
            raise RuntimeError(
                "gateway is draining: new submissions are not accepted")
        if self.shed_watermark is not None:
            live = self.runtime.view.nodes()
            depths = {n.node_id: n.queued_conversations for n in live}
            if live and all(d > self.shed_watermark
                            for d in depths.values()):
                self.n_shed += len(convs)
                # observed-drain hint off the SHALLOWEST live node: its
                # queue drains one conversation per (mean resident context
                # × observed TBT) — every factor is a NodeState read
                shallow = min(live, key=lambda n: n.queued_conversations)
                min_depth = shallow.queued_conversations
                if (shallow.observed_tbt_ema_s <= 0
                        or shallow.active_conversations <= 0):
                    retry_after = 0.0
                else:
                    mean_ctx = (shallow.active_kv_tokens
                                / shallow.active_conversations)
                    retry_after = (min_depth * mean_ctx
                                   * shallow.observed_tbt_ema_s)
                raise GatewayOverloaded(
                    f"shedding {len(convs)} conversation(s): every live "
                    f"node's admission queue exceeds the watermark "
                    f"{self.shed_watermark} (depths: {depths}); retry "
                    f"after queues drain"
                    + (f" (~{retry_after:.3f}s observed-drain hint)"
                       if retry_after > 0 else ""),
                    min_queue_depth=min_depth,
                    retry_after_s=retry_after)
        self._pending.extend(convs)
        self.n_submitted += len(convs)
        return self

    # ----- drive loop --------------------------------------------------------
    def start(self) -> "ServeGateway":
        if self._task is None:
            self._task = asyncio.ensure_future(self._drive())
        return self

    async def _drive(self):
        """Interleave staged submission with incremental event execution.
        Exits once draining AND the runtime heap and staging buffer are both
        empty. While accepting, an idle tick yields to the loop so live
        producers can stage more arrivals."""
        while True:
            if self._pending:
                batch, self._pending = self._pending, []
                self.runtime.submit(batch)
            n = self.runtime.run_pending(self.max_events_per_tick)
            if n == 0 and not self._pending and not self._accepting:
                break
            await asyncio.sleep(0)

    async def drain(self) -> list:
        """Stop accepting, finish all in-flight work, close the runtime and
        return its `ConversationRecord`s."""
        self._accepting = False
        if self._task is not None:
            await self._task
            self._task = None
        self.runtime.close()
        self._unsub()
        return self.runtime.results()

    # ----- consumption -------------------------------------------------------
    async def stream(self, cid: int):
        """Async generator over one conversation's live emissions:
        ``("tokens", turn_idx, payload)`` (payload: id list on the engine,
        int count on the sim), ``("rewind", turn_idx)`` after a failure
        rewound an in-flight turn, ending at the session's DONE transition.
        """
        q = self._q(cid)
        while True:
            item = await q.get()
            if item[0] == "done":
                return
            yield item

    # ----- observability -----------------------------------------------------
    @property
    def accepting(self) -> bool:
        return self._accepting

    def health(self) -> Dict[str, Any]:
        """Health/drain endpoint payload: gateway lifecycle plus the same
        per-node observables schedulers read — a read of owned state, not a
        parallel bookkeeping path."""
        nodes = {}
        for st in self.runtime.view._nodes.values():
            nodes[st.node_id] = {
                "role": st.role,
                "alive": st.alive,
                "lifecycle": st.lifecycle,
                "kv_headroom_tokens": st.kv_headroom_tokens,
                "queued_conversations": st.queued_conversations,
                "masked_forward_fraction": st.masked_forward_fraction,
            }
        return {
            "gateway": "accepting" if self._accepting else "draining",
            "runtime_state": self.runtime.runtime_state,
            "n_submitted": self.n_submitted,
            "n_shed": self.n_shed,
            "n_done": len(self.done_cids),
            "n_node_joins": self.events_seen.get(EV_NODE_JOIN, 0),
            "n_node_quarantines": self.events_seen.get(
                EV_NODE_QUARANTINE, 0),
            "events_seen": dict(self.events_seen),
            "nodes": nodes,
        }
