"""The conversation-session runtime contract shared by BOTH serving backends
(the discrete-event `ClusterSimulator` and the real-JAX `EngineServer`).

The paper's claim is that conversation-level scheduling makes placement a
pure function of observable state. For that to be true BY CONTRACT rather
than by convention, both backends must present the scheduler with the same
lifecycle, the same observables, and the same overload behavior. This module
defines that contract:

* `ServeSession` — the per-conversation state machine
  (QUEUED -> PREFILLING -> TRANSFERRING -> DECODING -> TOOL_WAIT -> DONE)
  with per-state timestamps, so queue wait, transfer stall and tool time are
  measurable observations, not modeled guesses.
* `Runtime` — the serving protocol (`submit` / `run` / `results`, plus the
  admission plumbing) every backend implements; `serve()` composes them.
* Admission control with backpressure: when a target node has no free KV
  slot or insufficient headroom, the work (a conversation arrival, a
  one-shot KV binding, a remote-turn package) waits in that node's
  `AdmissionQueue` and is re-offered when occupancy frees — instead of
  crashing (the engine's old `"no free KV slots"`) or silently overcommitting
  (the simulator's old unbounded growth). Queue depth is an observable
  (`NodeState.queued_conversations`); schedulers may read it but never a
  prediction of when it will drain.

Schedulers stay pure policies over `ClusterView`: the only new decision
point is `Scheduler.reoffer_admission`, called when a node frees capacity
with work waiting — the default (None) admits in FIFO order, so ConServe
and the baselines run unmodified.

Failure contract (both backends): the conversation is the unit of recovery
because it is the unit whose state is fully OBSERVABLE — a journal of the
completed turns' token transcripts (`ConversationJournal`) plus the
deterministic per-(cid, turn) turn inputs is everything needed to rebuild a
dead node's KV by re-prefilling, through the same admission path as an
arrival. Concretely:

* a victim session REWINDS with `transition(QUEUED, t, force=True)` — the
  rewind appends to `history` (never erases it), so `time_in`/`queue_wait_s`
  remain measurements across a failure;
* the dead node's parked admissions are re-placed through the SAME scheduler
  decision point that placed them originally (`Runtime._drain_dead_node`
  below, the shared mechanism) — never silently dropped, and never re-parked
  on a node that is itself dead: with overlapping failures the cluster can
  legitimately have no healthy target, and that raises loudly instead of
  rotting in a dead queue;
* replay compute is charged to dedicated observables
  (`NodeState.replayed_prefill_tokens`, `ConversationRecord.recovered` /
  `.recovery_latency_s`), never to the victim's TTFET history.
"""
from __future__ import annotations

import abc
import dataclasses
import statistics
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

from .events import (EV_ADMISSION_ADMIT, EV_ADMISSION_PARK, EV_NODE_JOIN,
                     EV_NODE_QUARANTINE, EV_SESSION, EventBus, ServeEvent)
from .signals import NODE_ACTIVE, NODE_DRAINING, NODE_QUARANTINED

# ----- session states --------------------------------------------------------
QUEUED = "QUEUED"              # submitted / waiting for admission
PREFILLING = "PREFILLING"      # (append-)prefill running or enqueued
TRANSFERRING = "TRANSFERRING"  # KV moving between nodes
DECODING = "DECODING"          # decode tail active on the bound node
TOOL_WAIT = "TOOL_WAIT"        # tool call in flight; KV stays pinned
DONE = "DONE"                  # final turn's last token emitted

SESSION_STATES = (QUEUED, PREFILLING, TRANSFERRING, DECODING, TOOL_WAIT, DONE)

# Legal transitions. QUEUED is re-enterable from every live state: any stage
# that needs capacity on a full node parks there until occupancy frees.
_ALLOWED: Dict[str, Tuple[str, ...]] = {
    QUEUED: (PREFILLING, TRANSFERRING, DECODING),
    PREFILLING: (TRANSFERRING, DECODING, QUEUED),
    TRANSFERRING: (PREFILLING, DECODING, QUEUED),
    DECODING: (TOOL_WAIT, DONE),
    TOOL_WAIT: (PREFILLING, TRANSFERRING, DECODING, QUEUED),
    DONE: (),
}


@dataclasses.dataclass
class ServeSession:
    """Observable lifecycle of one conversation inside a runtime.

    `history` is the full (state, entered_at) trail; timestamps come from the
    runtime's logical clock, so per-state dwell times (queue wait, transfer
    stall, tool time) are measurements of things that already happened."""
    cid: int
    arrival_s: float
    state: str = QUEUED
    node_id: Optional[int] = None  # current binding (decoder residency)
    turn_idx: int = 0
    history: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    # observer hook fired from INSIDE transition() — the event bus reads the
    # state machine at its own transition point, never a mirrored copy.
    # Called as notify(session, prev_state, new_state, t) after the history
    # entry lands; observers must not mutate the session.
    notify: Optional[Callable[["ServeSession", str, str, float], None]] = \
        dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if not self.history:
            self.history.append((self.state, self.arrival_s))

    def transition(self, state: str, t: float, *, force: bool = False):
        """Enter `state` at time `t`. Raises on an illegal transition unless
        `force` (failure recovery legitimately rewinds a session).

        Entry timestamps are clamped monotone non-decreasing against the
        session's own history. Normal serving already satisfies this (each
        stage's stamp is at or after the previous stage's); a failure REWIND
        interleaves with logically-later completions — e.g. a staged decode
        stamped at its future prefill-completion time when the replica dies
        just before that instant — and the clamp keeps every dwell
        (`time_in`) a non-negative measurement rather than erasing history."""
        if state == self.state:
            return
        if not force and state not in _ALLOWED[self.state]:
            raise RuntimeError(
                f"illegal session transition for cid {self.cid}: "
                f"{self.state} -> {state} (allowed: "
                f"{', '.join(_ALLOWED[self.state]) or 'none'})")
        prev = self.state
        self.state = state
        self.history.append((state, max(t, self.history[-1][1])))
        if self.notify is not None:
            self.notify(self, prev, state, self.history[-1][1])

    def time_in(self, state: str, now: Optional[float] = None) -> float:
        """Total seconds spent in `state` over the session's closed history
        segments (plus the open segment up to `now`, when given)."""
        total = 0.0
        for (s, t0), (_, t1) in zip(self.history, self.history[1:]):
            if s == state:
                total += t1 - t0
        if self.history and self.history[-1][0] == state and now is not None:
            total += max(now - self.history[-1][1], 0.0)
        return total

    @property
    def queue_wait_s(self) -> float:
        """Accumulated admission wait — the backpressure signal overload
        benchmarks record."""
        return self.time_in(QUEUED)

    @property
    def done(self) -> bool:
        return self.state == DONE


# ----- admission -------------------------------------------------------------
@dataclasses.dataclass
class Admission:
    """One unit of work waiting for capacity on a node: a conversation
    arrival, a one-shot KV binding, or a remote-turn package. `ready` is
    invoked with the ADMITTING node id (the scheduler's re-offer hook may
    move a parked admission to a different node before it runs). `kind`
    records which scheduler decision point placed the work, so a runtime
    that must re-place a parked admission (e.g. its node died) asks the
    same decision point again."""
    cid: int
    need_tokens: int           # KV tokens the work lands with (headroom ask)
    ready: Callable[[int], None]
    kind: str = "bind"         # "arrival" | "bind" | "turn"
    # set the first time this admission parks: one admission counts at most
    # once toward n_deferred_admissions even if a reoffer policy later
    # moves it to another node that also parks it
    deferred: bool = False
    # prefill-COMPUTE tokens this work will actually run (the backlog charge
    # feeding `queued_prefill_tokens`). None = need_tokens. They differ when
    # a shared prefix is already resident in the target node's prefix KV
    # pool: the slot still lands with the FULL context (need_tokens — the
    # headroom/fit ask is unchanged), but only the delta past the pooled
    # prefix is computed. Set from an OBSERVED pool hit at offer time, never
    # from a prediction of what the pool might hold later.
    charge_tokens: Optional[int] = None

    @property
    def charge(self) -> int:
        return (self.need_tokens if self.charge_tokens is None
                else self.charge_tokens)


class AdmissionQueue:
    """Per-node queue of admissions waiting for a free KV slot / headroom.
    FIFO by default; `Scheduler.select_refill` may name a different cid to
    admit first (mid-tail rotation refill), so arbitrary-position peek and
    removal are part of the contract."""

    def __init__(self, node_id: int):
        self.node_id = node_id
        self._q: Deque[Admission] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, adm: Admission):
        self._q.append(adm)

    def cids(self) -> List[int]:
        """Waiting conversation ids, FIFO order (the select_refill input)."""
        return [a.cid for a in self._q]

    def admissions(self, kind: Optional[str] = None) -> List[Admission]:
        """Waiting admissions (optionally filtered by kind), FIFO order —
        read-only view for accounting checks (strict_accounting asserts
        each node's backlog observables against exactly this state)."""
        return [a for a in self._q if kind is None or a.kind == kind]

    def peek(self, cid: int) -> Admission:
        """The first waiting admission for `cid` (a conversation has at most
        one admission in flight at a time)."""
        for a in self._q:
            if a.cid == cid:
                return a
        raise KeyError(f"cid {cid} is not waiting on node {self.node_id}")

    def remove(self, cid: int) -> Admission:
        adm = self.peek(cid)
        self._q.remove(adm)
        return adm

    def drain(self) -> List[Admission]:
        out = list(self._q)
        self._q.clear()
        return out


# ----- journal ---------------------------------------------------------------
class ConversationJournal:
    """Per-conversation transcript journal: the token stream each COMPLETED
    turn fed into the KV cache, keyed (cid, turn_idx). Together with the
    deterministic turn inputs this is sufficient to rebuild a conversation's
    exact KV state on any replica by re-prefilling — deterministic replay,
    the paper's recovery mechanism, with zero prediction involved.

    The engine records each turn's SAMPLED stream here at turn completion
    (the stream is ``[prefill argmax] + decoded tokens``, length n+1; the
    last sampled token of a turn is never fed back, so the KV-fed slice is
    ``stream[:-1]``). The simulator's journal is implicit — its cost model
    tracks token COUNTS, so `_recover`'s context arithmetic plays the same
    role — but both backends share the contract: completed turns are
    journaled, in-flight turns are not (their partial output is discarded
    and re-decoded, which determinism makes byte-identical).

    Entries are dropped at conversation DONE to bound memory to live work."""

    def __init__(self):
        self._streams: Dict[Tuple[int, int], Any] = {}

    def record(self, cid: int, turn_idx: int, stream: Sequence[int]):
        """Journal a completed turn's full sampled stream. Re-recording the
        same turn (it completed once; recovery replays only in-flight turns)
        would mean non-deterministic replay — kept loud."""
        key = (cid, turn_idx)
        if key in self._streams:
            raise RuntimeError(
                f"turn {turn_idx} of conversation {cid} journaled twice — "
                f"a completed turn must never re-run")
        self._streams[key] = list(stream)

    def fed_tokens(self, cid: int, turn_idx: int) -> List[int]:
        """The tokens turn `turn_idx` fed into the KV cache (the sampled
        stream minus its final token, which was never appended)."""
        return self._streams[(cid, turn_idx)][:-1]

    def n_completed(self, cid: int) -> int:
        """Completed (journaled) turns for `cid`. Turns complete in order,
        so this is also the index of the first un-journaled turn."""
        return sum(1 for (c, _) in self._streams if c == cid)

    def drop(self, cid: int):
        for key in [k for k in self._streams if k[0] == cid]:
            del self._streams[key]


# ----- prefix KV pool: the one shared eviction rule --------------------------
def prefix_eviction_order(entries: Dict[Any, Any]) -> List[Any]:
    """Eviction order for a node's prefix KV pool, shared by BOTH backends so
    the pools age identically under one contract.

    The rule is observation-only (Astraea's argument, PAPERS.md): evict the
    entry with the FEWEST observed reuse hits first, ties broken
    least-recently-hit (LRU over measured hits, `last_use` is a monotone use
    sequence number) — never a predicted popularity. Entries with live
    references (`refs > 0`: a prefill is reading the rows right now) are
    pinned and excluded entirely; callers must REFUSE to make room rather
    than evict pinned rows out from under an in-flight program.

    `entries` maps pool key -> entry with observable counters `hits`,
    `last_use`, `refs`. Returns the evictable keys, first-to-evict first.
    """
    evictable = [(e.hits, e.last_use, k) for k, e in entries.items()
                 if e.refs == 0]
    evictable.sort(key=lambda t: (t[0], t[1]))
    return [k for _, _, k in evictable]


@dataclasses.dataclass
class PrefixPoolEntry:
    """One immutable pooled prefix. In the engine, `caches` holds the device
    rows shaped exactly like `slice_slot_prefix`'s output ((…, 1, ctx, …)
    growing leaves, (…, 1, …) fixed states), zero-masked beyond `length` so
    the padded tail carries no slot-specific stale bytes; the simulator
    models only the token volume and stores None. `hits`/`last_use` are the
    OBSERVED reuse counters the eviction rule orders on; `refs` pins the
    entry while a prefill is reading it."""
    key: Any
    caches: Any
    length: int           # live prefix tokens
    ctx: int              # padded ctx bucket the rows were exported at
    hits: int = 0
    last_use: int = 0
    refs: int = 0


class PrefixKVPool:
    """Node-level pool of immutable shared-prefix KV rows — ONE container
    for both backends (the engine keys by token-content hash and stores
    device rows; the simulator keys by preamble identity and stores token
    volume only), so the pools age identically under the shared eviction
    rule.

    A third cache ownership class: rows owned by NO slot — populated the
    first time a preamble is prefilled, read (never written) by any number
    of later turn-1 prefills on the same node. Capacity is a budget in
    live prefix tokens, SEPARATE from the slot cache's kv_capacity, so
    `kv_headroom_tokens` keeps meaning slot-landable work. Eviction is the
    shared `prefix_eviction_order` rule (fewest observed hits, ties
    least-recently-hit, pinned entries untouchable): when evicting every
    unpinned entry still cannot make room, `put` REFUSES (returns False)
    rather than evict pinned rows out from under a reader."""

    def __init__(self, capacity_tokens: int):
        self.capacity_tokens = int(capacity_tokens)
        self.entries: Dict[Any, PrefixPoolEntry] = {}
        self._seq = 0  # monotone use counter (LRU tie-break clock)
        self.total_hits = 0
        self.n_evictions = 0

    # ----- observables -------------------------------------------------------
    @property
    def pooled_tokens(self) -> int:
        return sum(e.length for e in self.entries.values())

    @property
    def n_entries(self) -> int:
        return len(self.entries)

    # ----- reads -------------------------------------------------------------
    def contains(self, key) -> bool:
        return key in self.entries

    def get(self, key) -> Optional[PrefixPoolEntry]:
        """Look up pooled rows and RECORD the reuse: hits and last_use are
        the observed counters eviction orders on, so a lookup that feeds a
        prefill must come through here (use `contains` for side-effect-free
        checks)."""
        e = self.entries.get(key)
        if e is None:
            return None
        self._seq += 1
        e.hits += 1
        e.last_use = self._seq
        self.total_hits += 1
        return e

    # ----- pinning -----------------------------------------------------------
    def pin(self, key):
        self.entries[key].refs += 1

    def unpin(self, key):
        e = self.entries[key]
        if e.refs <= 0:
            raise RuntimeError(
                f"prefix pool entry {key} unpinned more times than pinned")
        e.refs -= 1

    # ----- writes ------------------------------------------------------------
    def put(self, key, caches, length: int, ctx: int) -> bool:
        """Install pooled rows for `key`, evicting by the shared observed-
        reuse rule until the token budget fits. Returns False (and pools
        nothing) when the entry can never fit or only pinned entries could
        make room. Re-putting an existing key is a no-op (the rows are
        immutable — first write wins)."""
        if key in self.entries:
            return True
        if length > self.capacity_tokens:
            return False
        while self.pooled_tokens + length > self.capacity_tokens:
            order = prefix_eviction_order(self.entries)
            if not order:
                return False  # everything left is pinned — refuse, don't rip
            victim = self.entries.pop(order[0])
            self.n_evictions += 1
            del victim
        self._seq += 1
        self.entries[key] = PrefixPoolEntry(
            key=key, caches=caches, length=int(length), ctx=int(ctx),
            last_use=self._seq)
        return True

    def invalidate_all(self):
        """Node failure: pooled rows die with the node's slot cache (same
        `invalidate_all` moment). Entries are dropped so a recovered
        conversation re-populates through the normal miss path instead of
        dangling a reference to dead device buffers; cumulative counters
        (hits/evictions) survive — they count events that already
        happened."""
        self.entries.clear()


class Runtime(abc.ABC):
    """Serving contract both backends implement. Subclasses provide:

    * `sched` (a `Scheduler`), `view` (a `ClusterView`),
    * `sessions: Dict[int, ServeSession]`,
    * `_admission: Dict[int, AdmissionQueue]` (one per node),
    * `_can_admit(node_id, adm)` — the backend's ground-truth capacity check
      (engine: a free KV slot; simulator: a free slot AND token headroom).

    The base class owns the admission/backpressure mechanism so overload
    behaves identically at both scales; schedulers only ever see the
    observable consequences (queue depth, occupancy) through `ClusterView`.
    """

    sessions: Dict[int, ServeSession]
    _admission: Dict[int, "AdmissionQueue"]
    # how many admissions were ever deferred (parked) — a structural
    # backpressure signal independent of measured wall time
    n_deferred_admissions: int = 0
    # lifecycle: False while the runtime accepts submissions (before and
    # DURING the event loop — staged arrivals inject mid-flight); True once
    # run() completed or close() was called, after which submit() raises
    _closed: bool = False
    # observed-straggler quarantine config (None disables the trigger; both
    # backends expose these as constructor parameters). A node flips
    # ACTIVE -> QUARANTINED when its observed_tbt_ema_s exceeds
    # quarantine_k × the fleet median for quarantine_window consecutive
    # observed decode chunks, and requalifies (-> DRAINING -> ACTIVE) once
    # it falls back below quarantine_rejoin_k × median (defaults to
    # quarantine_k) for the same window. Every quantity involved is an
    # observation the runtime already owns — never a failure prediction.
    quarantine_k: Optional[float] = None
    quarantine_window: int = 3
    quarantine_rejoin_k: Optional[float] = None

    # ----- protocol ----------------------------------------------------------
    @abc.abstractmethod
    def submit(self, convs) -> "Runtime":
        """Register conversations (records + sessions) and schedule their
        arrival events. Legal before and DURING the event loop (staged
        arrival injection: an arrival timestamp already in the logical past
        is clamped to now); raises once the runtime is closed. Returns self
        for chaining."""

    @abc.abstractmethod
    def run(self) -> "Runtime":
        """Drain the event loop, then CLOSE the runtime (late submissions
        raise). Returns self for chaining."""

    @abc.abstractmethod
    def run_pending(self, max_events: Optional[int] = None) -> int:
        """Incremental drive: pop up to `max_events` pending events (all of
        them when None) WITHOUT closing the runtime, so staged submissions
        may keep arriving between calls — the live gateway's drive loop.
        Returns the number of events executed."""

    @abc.abstractmethod
    def results(self) -> list:
        """Completed `ConversationRecord`s."""

    def serve(self, convs) -> list:
        """The one-call contract: submit + run + results."""
        return self.submit(convs).run().results()

    # ----- lifecycle ---------------------------------------------------------
    @property
    def now_s(self) -> float:
        """The runtime's current logical-clock instant. Backends override
        (engine `_now`, simulator `now`); shared read path for front ends
        (gateway, chaos driver) that arm time-scheduled faults."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose now_s")

    @property
    def runtime_state(self) -> str:
        """"accepting" while submissions are legal, "closed" after."""
        return "closed" if self._closed else "accepting"

    def close(self):
        """Finalize: no further submissions are accepted. run() calls this
        after draining; a gateway calls it at drain time."""
        self._closed = True

    def _assert_accepting(self):
        """Loud guard for every submit(): a submission after run() completed
        would push arrival events onto a heap nothing drains — on the engine
        backend that used to be SILENTLY inert (sessions registered, nothing
        ever served). Name the runtime state instead."""
        if self._closed:
            raise RuntimeError(
                f"late submission rejected: {type(self).__name__} runtime "
                f"state is '{self.runtime_state}' — run() already completed "
                f"(or close() was called) and drained the event loop, so "
                f"the arrival would never execute. Submit before or during "
                f"run(), or drive staged arrivals through run_pending() / "
                f"repro.serve.ServeGateway.")

    # ----- event bus ---------------------------------------------------------
    @property
    def bus(self) -> EventBus:
        """The runtime's event bus, created on first access. Hot paths guard
        with `_publish`, which never creates the bus — a runtime nobody
        subscribed to pays one dict lookup per potential event."""
        b = self.__dict__.get("_bus")
        if b is None:
            b = self.__dict__["_bus"] = EventBus()
        return b

    def _publish(self, event_kind: str, t: float, *,
                 cid: Optional[int] = None, turn_idx: Optional[int] = None,
                 node_id: Optional[int] = None, **data):
        # first param deliberately not named "kind": admission events carry
        # a "kind" payload key (the Admission.kind decision point) in **data
        bus = self.__dict__.get("_bus")
        if bus is not None and bus.wants(event_kind):
            bus.publish(ServeEvent(kind=event_kind, t=t, cid=cid,
                                   turn_idx=turn_idx, node_id=node_id,
                                   data=data))

    def _notify_session(self, sess: ServeSession, prev: str, state: str,
                        t: float):
        """ServeSession.notify target: republish the state machine's own
        transition (the hook fires inside transition(), so `sess` IS the
        owned state at that instant)."""
        self._publish(EV_SESSION, t, cid=sess.cid, turn_idx=sess.turn_idx,
                      node_id=sess.node_id, state=state, prev=prev)

    # ----- admission mechanism ----------------------------------------------
    @abc.abstractmethod
    def _can_admit(self, node_id: int, adm: Admission) -> bool:
        ...

    def _never_fits(self, node_id: int, adm: Admission) -> bool:
        """True when `adm` can NEVER fit on `node_id` no matter how much
        occupancy frees (backend capacity bound). Backends override; the
        base conservatively says False. Used to veto a reoffer policy's
        move: work legally waiting on its origin must not be relocated
        somewhere the loud never-fits check would kill the serve."""
        return False

    def _on_reoffer_move(self, adm: Admission, from_node: int,
                         to_node: int) -> None:
        """Hook: a parked admission is being MOVED from `from_node`'s queue
        to `to_node` by a `reoffer_admission` policy. Backends that maintain
        per-node backlog observables derived from parked work (the engine's
        `queued_prefill_tokens`) move them here, at the instant the work
        changes queues — moving them later (e.g. when the admission finally
        runs) lets the counter sit on the wrong node for the whole parked
        interval, which is exactly the drift strict accounting rejects."""

    def _make_session(self, cid: int, arrival_s: float) -> ServeSession:
        sess = ServeSession(cid=cid, arrival_s=arrival_s,
                            notify=self._notify_session)
        self.sessions[cid] = sess
        return sess

    # ----- replica lifecycle (observed-straggler quarantine) -----------------
    @property
    def _lifecycle_streaks(self) -> Dict[int, Tuple[int, int]]:
        """Per-node (consecutive-above, consecutive-below) chunk counters for
        the quarantine trigger — lazily created like the bus so backends
        need no ctor changes. Counters of observed chunk comparisons that
        already happened, nothing predictive."""
        d = self.__dict__.get("_lc_streaks")
        if d is None:
            d = self.__dict__["_lc_streaks"] = {}
        return d

    def _node_has_inflight(self, node_id: int) -> bool:
        """True while `node_id` still runs or holds in-flight work (decode
        tails, queued prefill, bound sessions). Backends override; the base
        says False so QUARANTINED -> ACTIVE requalification is immediate."""
        return False

    def _observe_chunk_tbt(self, node_id: int, now: float):
        """Lifecycle trigger, called by both backends immediately after every
        `observed_tbt_ema_s` update (one observed decode chunk). Compares the
        node's own EMA against the median of its live ACTIVE decode-capable
        peers — both sides of the comparison are maintained observations —
        and advances the ACTIVE -> QUARANTINED -> DRAINING -> ACTIVE machine.

        Known (documented) limit of observation-only rejoin: a quarantined
        node with no in-flight tails produces no new chunk observations, so
        its EMA can never be observed to recover and it stays QUARANTINED
        until revived externally — the trigger never invents a probe."""
        if self.quarantine_k is None:
            return
        st = self.view.node(node_id)
        if not st.alive or st.observed_tbt_ema_s <= 0:
            return
        peers = [n.observed_tbt_ema_s for n in self.view.nodes()
                 if n.role in ("decode", "mixed") and n.node_id != node_id
                 and n.observed_tbt_ema_s > 0]
        if not peers:
            return  # no healthy peer baseline to compare against
        med = statistics.median(peers)
        if med <= 0:
            return
        streaks = self._lifecycle_streaks
        above, below = streaks.get(node_id, (0, 0))
        rejoin_k = (self.quarantine_k if self.quarantine_rejoin_k is None
                    else self.quarantine_rejoin_k)
        if st.lifecycle == NODE_ACTIVE:
            above = above + 1 if st.observed_tbt_ema_s > \
                self.quarantine_k * med else 0
            streaks[node_id] = (above, 0)
            if above >= self.quarantine_window:
                streaks[node_id] = (0, 0)
                self._quarantine_node(node_id, now, st.observed_tbt_ema_s,
                                      med)
        elif st.lifecycle == NODE_QUARANTINED:
            below = below + 1 if st.observed_tbt_ema_s <= rejoin_k * med \
                else 0
            streaks[node_id] = (0, below)
            if below >= self.quarantine_window:
                streaks[node_id] = (0, 0)
                if self._node_has_inflight(node_id):
                    st.lifecycle = NODE_DRAINING
                else:
                    self._rejoin_node(node_id, now,
                                      reason="from_quarantine")
        # DRAINING: requalified already — only waiting on resident tails;
        # _maybe_finish_draining (called at every release point) completes it

    def _quarantine_node(self, node_id: int, now: float, ema: float,
                         med: float):
        """Flip `node_id` out of the schedulable set: it takes no new
        placements or refills (ClusterView.nodes() hides it; _offer refuses
        it), its parked admissions re-place to peers through the same
        decision points a failure drain uses, and its in-flight tails keep
        running — they are the observation source the rejoin rule needs."""
        st = self.view.node(node_id)
        st.lifecycle = NODE_QUARANTINED
        log = getattr(self, "log", None)
        if log is not None:
            log.append(
                f"t={now:.3f} QUARANTINE node {node_id}: observed TBT EMA "
                f"{ema:.6f}s > {self.quarantine_k}x fleet median "
                f"{med:.6f}s over {self.quarantine_window} chunks")
        self._publish(EV_NODE_QUARANTINE, now, node_id=node_id,
                      observed_tbt_ema_s=ema, fleet_median_tbt_s=med,
                      k=self.quarantine_k)
        self._drain_dead_node(node_id, now)

    def _rejoin_node(self, node_id: int, now: float, *, reason: str):
        """`node_id` (re)enters ACTIVE service — revival of a dead replica
        (`reason="from_dead"`) or an observed-EMA recovery out of quarantine
        (`reason="from_quarantine"`). Publishes `node_join`, then pumps
        EVERY active node's admission queue so parked work lands on the
        rejoined capacity immediately."""
        st = self.view.node(node_id)
        st.lifecycle = NODE_ACTIVE
        self._lifecycle_streaks.pop(node_id, None)
        log = getattr(self, "log", None)
        if log is not None:
            log.append(f"t={now:.3f} JOIN node {node_id} ({reason})")
        self._publish(EV_NODE_JOIN, now, node_id=node_id, reason=reason)
        self._pump_all(now)

    def _maybe_finish_draining(self, node_id: int, now: float):
        """Release-point hook: a DRAINING node whose last in-flight tail
        just left re-activates."""
        st = self.view.node(node_id)
        if (st.alive and st.lifecycle == NODE_DRAINING
                and not self._node_has_inflight(node_id)):
            self._rejoin_node(node_id, now, reason="from_quarantine")

    def _pump_all(self, now: float):
        """Pump every schedulable node's admission queue — the rejoin path:
        a reoffer policy may now move parked work onto the fresh node."""
        for nid in self._admission:
            st = self.view.node(nid)
            if st.alive and st.lifecycle == NODE_ACTIVE:
                self._pump(nid, now)

    # ----- failure mechanism -------------------------------------------------
    def _replace_admission(self, adm: Admission, now: float) -> Optional[int]:
        """Re-place one admission drained from a dead node's queue through
        the SAME scheduler decision point that placed it originally (`kind`
        records which). Return the new target node id, or None when the
        backend re-dispatched the work some other way (e.g. re-planning a
        turn placement from scratch). Backends with failure semantics
        override; the base raises so a backend can't silently drop work."""
        raise NotImplementedError(
            f"{type(self).__name__} drained a dead node's admission queue "
            f"but implements no _replace_admission")

    def _drain_dead_node(self, node_id: int, now: float):
        """Shared failure/quarantine semantics: an unschedulable node's
        parked admissions would never be pumped — drain them and re-place
        each via `_replace_admission`, guarding the result. (The name keeps
        the failure contract's original entry point; quarantine reuses the
        identical mechanism on a still-alive node.) With overlapping
        failures the chosen target can itself be dead or quarantined, or
        the cluster may have no healthy candidate at all (the scheduler
        helpers raise); all must fail loudly here instead of re-parking
        work on an unschedulable node."""
        st = self.view.node(node_id)
        for adm in self._admission[node_id].drain():
            st.queued_conversations -= 1
            target = self._replace_admission(adm, now)
            if target is None:
                continue
            tgt = self.view.node(target)
            if not tgt.alive:
                raise RuntimeError(
                    f"re-placement of conversation {adm.cid} "
                    f"({adm.kind}) off dead node {node_id} chose node "
                    f"{target}, which is also dead; schedulers must place "
                    f"on live nodes only")
            if tgt.lifecycle != NODE_ACTIVE:
                raise RuntimeError(
                    f"re-placement of conversation {adm.cid} "
                    f"({adm.kind}) off node {node_id} chose node "
                    f"{target}, which is {tgt.lifecycle}; schedulers must "
                    f"place on ACTIVE nodes only")
            self._on_reoffer_move(adm, node_id, target)
            self._offer(target, adm, now)

    def _offer(self, node_id: int, adm: Admission, now: float) -> bool:
        """Admit `adm` on `node_id` immediately if it has capacity and no one
        is already waiting (FIFO fairness); otherwise park it in the node's
        admission queue and flip the session to QUEUED. Returns True when the
        work ran now."""
        target = self.view.node(node_id)
        if not target.alive:
            # work offered to a dead node would park in a queue nothing ever
            # pumps — every placement path must name a live node
            raise RuntimeError(
                f"admission for conversation {adm.cid} ({adm.kind}) offered "
                f"to dead node {node_id}; placements must name a live node")
        if target.lifecycle != NODE_ACTIVE:
            # a quarantined/draining node takes no new placements; parked
            # work there would wait on a node that refuses refills
            raise RuntimeError(
                f"admission for conversation {adm.cid} ({adm.kind}) offered "
                f"to {target.lifecycle} node {node_id}; placements must "
                f"name an ACTIVE node")
        q = self._admission[node_id]
        # evaluate capacity even when others are waiting: _can_admit is also
        # where work that can NEVER fit raises — that must happen at offer
        # time, not later from an unrelated conversation's release event
        fits = self._can_admit(node_id, adm)
        if len(q) == 0 and fits:
            self._publish(EV_ADMISSION_ADMIT, now, cid=adm.cid,
                          node_id=node_id, kind=adm.kind,
                          need_tokens=adm.need_tokens)
            adm.ready(node_id)
            return True
        q.push(adm)
        self.view.node(node_id).queued_conversations += 1
        self._publish(EV_ADMISSION_PARK, now, cid=adm.cid, node_id=node_id,
                      kind=adm.kind, need_tokens=adm.need_tokens)
        # structural backpressure count (independent of measured timings);
        # an admission re-parked by a reoffer move does not count twice
        if not adm.deferred:
            adm.deferred = True
            self.n_deferred_admissions = getattr(
                self, "n_deferred_admissions", 0) + 1
        sess = self.sessions.get(adm.cid)
        if sess is not None:
            sess.transition(QUEUED, now)
        return False

    def _pump(self, node_id: int, now: float):
        """Re-offer parked work on `node_id` — at every release point, and
        (on rotating backends) at every decode chunk cut. Two scheduler
        decision points, both defaulting to the unmodified FIFO behavior:

        * `select_refill` picks WHICH waiting conversation to try first
          (default: the queue head);
        * `reoffer_admission` may move that admission to another node
          (default: stay). It is consulted before the capacity check, so a
          policy can drain a still-full node's queue toward idle peers.

        Admission stops at the first selected conversation this node cannot
        take (head-of-line semantics under FIFO; a reordering policy picks
        its own head). A non-ACTIVE node never refills (its queue was
        drained at the transition; the guard keeps release-point callers
        honest)."""
        q = self._admission[node_id]
        st = self.view.node(node_id)
        if not st.alive or st.lifecycle != NODE_ACTIVE:
            return
        while len(q):
            cids = q.cids()
            order = self.sched.select_refill(node_id, list(cids), self.view)
            cid = cids[0]
            if order:
                cid = next((c for c in order if c in cids), cids[0])
            adm = q.peek(cid)
            pl = self.sched.reoffer_admission(adm.cid, node_id, self.view)
            if pl is not None and pl.node_id != node_id \
                    and not self._never_fits(pl.node_id, adm):
                # the hook sees only (cid, node, view) — the mechanism, not
                # the policy, guards against moving work somewhere it could
                # never fit (heterogeneous capacities)
                q.remove(cid)
                st.queued_conversations -= 1
                self._on_reoffer_move(adm, node_id, pl.node_id)
                self._offer(pl.node_id, adm, now)
                continue
            if not self._can_admit(node_id, adm):
                break
            q.remove(cid)
            st.queued_conversations -= 1
            self._publish(EV_ADMISSION_ADMIT, now, cid=adm.cid,
                          node_id=node_id, kind=adm.kind,
                          need_tokens=adm.need_tokens)
            adm.ready(node_id)

    # ----- shared observables -----------------------------------------------
    def queue_waits(self) -> Dict[int, float]:
        """Per-conversation admission wait (seconds) — the backpressure cost
        overload benchmarks and capacity planning read."""
        return {cid: s.queue_wait_s for cid, s in self.sessions.items()}
