"""Serving loop over REAL replicas, driven by the same `repro_torch.core`
schedulers — and the same `repro_torch.core.runtime.Runtime` contract — as
the cluster simulator of the JAX package. A copy of the JAX package's
`engine/server.py` over the port's `ReplicaEngine`; the only changes are the
imports and the two frontend stubs, which are torch tensors here.

Replica compute is executed for real (measured wall time advances per-node
logical clocks); KV transfers physically copy cache slots between replica
buffers and charge modeled link latency. Tool-call delays advance logical
time only. The result: scheduler policies are exercised against a real
engine — prefix reuse, slot pinning, one-shot transfer and occupancy
accounting all have to actually work — while a full trace replays in
seconds on CPU.

Prefill stages dispatch through the replica's AOT-compiled donated bucket
programs by default (`ReplicaEngine.prefill_mode="jit"`: one dispatch per
(append-)prefill, in-slot KV scatter, compile time off the logical clock);
`EngineServer(prefill_mode="reference")` replays the eager per-op oracle
on every replica for parity runs.

Serving is organized as queue-fed stages over an explicit per-conversation
state machine (`ServeSession`): arrival no longer runs prefill inline —
every slot-holding stage (turn-1 prefill, the one-shot KV binding, remote
turns) first passes ADMISSION on its target node. When the node has no free
KV slot the work parks in that node's admission queue (session -> QUEUED,
`NodeState.queued_conversations` observable) and is re-offered when a
conversation ends and frees its slot — backpressure instead of the old
`"no free KV slots"` crash, with `Scheduler.reoffer_admission` as the
optional policy hook.

The decode tail runs as a CONTINUOUS ROTATION over each node's KV slots
(`rotation=True`, the default): every `_iterate` call is one chunk cut.
At the cut the loop first merges READY turns — completed prefills and
post-tool next-turns of conversations already pinned to the node — into
the batch, then re-offers the node's admission queue (so parked sessions
leave QUEUED mid-tail, at the cut where a slot actually freed, ordered by
`Scheduler.select_refill`, default FIFO). Chunks are sized adaptively:
with refill supply observed waiting (admission-queue depth, staged ready
turns) the chunk is cut at the earliest in-flight finish horizon
(bucket-floored min(remaining) — every lane stays live to the cut, zero
masked forwards, and the freed slot turns around immediately); with no
supply the chunk runs to bucket-floored max(remaining) exactly as before
(raggedness absorbs the stagger; cutting early would only buy dispatch
overhead). `rotation=False` preserves the chunk-boundary-only admission
behavior (refills ride the event heap and join one full chunk late) as
the measurable baseline. Either way the scan itself is byte-for-byte the
ragged donated-KV contract documented in ROADMAP "Serving runtime", and
per-(cid, turn) token streams are identical across rotation on/off and
any refill ordering.

Spans (`engine.trace`; published only to a ``span`` subscriber of `bus`)
lie on the logical clock, at the points where the state already changes:
``server.conversation`` (arrival -> last token), ``server.turn``
(runnable -> last token) under it, and under each turn the intervals that
stage it: ``server.admission`` (offered -> admitted; kind arrival, bind,
turn or recovery), ``server.wait_replica`` (admitted or runnable -> the
replica's clock frees), ``server.prefill`` and ``server.append`` (the
call's logical interval), ``server.transfer`` (each package move; a failed
attempt marked ``failed``, lasting its backoff) and ``server.wait_join``
(staged -> the start of the chunk that first decodes the turn). A turn's
children carry ``attempt``, the recoveries the turn has been through: on
a failure-free path attempt 0 tiles runnable -> that chunk's start. A
replica failure opens the next attempt at the failure (at the tool's
return, for a tool-waiting turn): a turn staged but not yet decoded then
ends its attempt with a ``server.wait_join`` marked ``interrupted``, so
every attempt tiles its start -> its first chunk's start (or the
failure), and a turn that had decoded leaves the decode between.
(Not covered: a remote turn's admission parked on a replica that fails is
re-planned, and the time it sat parked is in no span.) A span bracketing
a replica call is the parent of the replica's host-clock spans.
`ServeSession` states are not spans and are unchanged.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.conversation import Conversation, TurnView, view_of
from repro_torch.core.events import (EV_NODE_FAILURE, EV_RECOVERY, EV_TOKENS,
                               EV_TURN_FINISH)
from repro_torch.core.metrics import ConversationRecord, TurnRecord
from repro_torch.core.runtime import (Admission, AdmissionQueue,
                                ConversationJournal, DECODING, DONE,
                                PREFILLING, QUEUED, Runtime, ServeSession,
                                TOOL_WAIT, TRANSFERRING)
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.signals import (NODE_ACTIVE, ClusterView, NodeState,
                                PrefillLatencyCurve)

from .kvcache import prefix_hash
from .replica import DECODE_CHUNKS, ReplicaEngine, decode_chunk_floor
from .trace import Tracer


@dataclasses.dataclass
class _TurnSpan:
    """A turn's open ``server.turn`` span (tracing)."""
    span_id: int
    turn_idx: int
    t0: float            # runnable
    host_t0_ns: int
    gen: int             # the conversation's generation when it opened
    staged_t: Optional[float] = None  # staged, and in no chunk yet


@dataclasses.dataclass
class _TurnTask:
    conv: Conversation
    turn_idx: int
    slot: int
    remaining: int
    next_token: int
    first_token_t: Optional[float] = None
    arrival_t: float = 0.0
    # every sampled token of this turn so far ([prefill argmax] + decoded),
    # journaled at turn completion — the engine's failure-recovery transcript
    stream: List[int] = dataclasses.field(default_factory=list)
    # recovery generation of the conversation when this task was built:
    # finish events carrying a stale generation are dropped (the turn was
    # rewound and is being replayed)
    gen: int = 0


class EngineServer(Runtime):
    def __init__(self, scheduler: Scheduler, replicas: List[ReplicaEngine],
                 link_bw_bytes_s: float = 25e9, seed: int = 0,
                 max_decode_chunk: int = 32, decode_mode: str = "fused",
                 record_tokens: bool = False, strict_accounting: bool = False,
                 rotation: bool = True, rotation_min_chunk: int = 16,
                 prefill_mode: Optional[str] = None,
                 tool_deadline_s: Optional[float] = None,
                 tool_timeout_action: str = "evict",
                 max_transfer_retries: int = 3,
                 transfer_retry_backoff_s: float = 0.01,
                 quarantine_k: Optional[float] = None,
                 quarantine_window: int = 3,
                 quarantine_rejoin_k: Optional[float] = None):
        """decode_mode: "fused" runs up to `max_decode_chunk` tokens per
        dispatch through the donated in-place RAGGED scan (`decode_steps`):
        each slot consumes only its own per-slot share, and turns that
        exhaust their output mid-chunk finish at interpolated timestamps.
        "reference" replays the pre-fusion one-dispatch-per-token path
        (kept for parity tests and before/after benchmarks).
        rotation: True (default) runs the decode tail as a continuous
        rotation — adaptive chunk cuts at observed finish horizons, ready
        turns and parked admissions refilled INTO the batch at every cut
        (see the module docstring). False preserves the chunk-boundary-only
        admission behavior as the comparison baseline; token streams are
        identical either way.
        rotation_min_chunk: shortest chunk (in scan steps) a refill cut may
        produce while longer work remains in the batch — a lane that
        finishes below it freezes briefly instead of forcing a cut, so
        per-dispatch overhead stays amortized (each dispatch costs a few
        scan steps' time; cutting at every tiny finish horizon re-creates
        the retired min-collapse pathology). Tune to the measured
        dispatch-overhead/step-cost ratio of the deployment; the default 16
        suits this container (CPU dispatch ~3-4 scan steps' worth). Chunk
        SIZING never changes token content — only when work runs.
        record_tokens: keep every sampled token per (cid, turn) in
        `sampled_tokens` — O(total output tokens) memory, tests only.
        strict_accounting: at every conversation end, assert the NodeState
        observables (active_kv_tokens, used_slots, queued_prefill_tokens)
        still mirror the KV caches' / admission queues' ground truth on
        every replica — drift detection for tests.
        prefill_mode: None (default) leaves each replica's own mode in
        place; "jit" / "reference" overrides every replica — "reference"
        replays the eager per-op (append-)prefill path as the parity
        oracle (see ReplicaEngine.prefill_mode).
        tool_deadline_s: TOOL_WAIT watchdog (off by default, None). A
        session whose tool call has not returned `tool_deadline_s` seconds
        after entering TOOL_WAIT is acted on per `tool_timeout_action`:
        "evict" frees its KV slot for waiting work (the tool return
        re-admits by journaled replay through the arrival admission path);
        "fail" raises loudly naming the conversation. Either way nothing
        parks forever on a tool that never comes back.
        max_transfer_retries / transfer_retry_backoff_s: bound on one-shot
        KV-transfer attempts per binding (see `inject_transfer_faults`);
        each failed attempt backs off exponentially from the base and
        re-asks `Scheduler.bind_decoder` for a (possibly different)
        decoder. Exhausting the bound raises loudly.
        quarantine_k / quarantine_window / quarantine_rejoin_k: the
        observed-straggler quarantine trigger (Runtime contract; None
        disables it). A replica whose observed_tbt_ema_s exceeds
        quarantine_k × the fleet median for quarantine_window consecutive
        decode chunks leaves the schedulable set (lifecycle QUARANTINED),
        and requalifies once it falls back below quarantine_rejoin_k ×
        median (defaults to quarantine_k) for the same window."""
        assert decode_mode in ("fused", "reference")
        assert prefill_mode in (None, "jit", "reference")
        assert tool_timeout_action in ("evict", "fail")
        if prefill_mode is not None:
            for r in replicas:
                r.prefill_mode = prefill_mode
        self.sched = scheduler
        self.replicas = {r.replica_id: r for r in replicas}
        self.link_bw = link_bw_bytes_s
        # compiled scan buckets top out at DECODE_CHUNKS[-1]; a larger chunk
        # would silently desync server token accounting from the replica
        self.max_decode_chunk = max(1, min(int(max_decode_chunk),
                                           DECODE_CHUNKS[-1]))
        self.decode_mode = decode_mode
        self.record_tokens = record_tokens
        self.strict_accounting = strict_accounting
        self.rotation = rotation
        self.rotation_min_chunk = max(1, min(int(rotation_min_chunk),
                                             self.max_decode_chunk))
        self.seed = seed
        states = {}
        for r in replicas:
            states[r.replica_id] = NodeState(
                node_id=r.replica_id,
                role="prefill" if r.role == "prefill" else (
                    "mixed" if r.role == "mixed" else "decode"),
                kv_capacity_tokens=r.kv.n_slots * r.kv.max_ctx,
                slot_capacity=r.kv.n_slots)
        # observable curve: coarse profile of the actual replica
        curve = PrefillLatencyCurve(0.0, 1e-5, 0.01)
        self.view = ClusterView(states, curve)
        self.states = states
        self.clock: Dict[int, float] = {r.replica_id: 0.0 for r in replicas}
        self.records: Dict[int, ConversationRecord] = {}
        self.sessions: Dict[int, ServeSession] = {}
        self._admission: Dict[int, AdmissionQueue] = {
            r.replica_id: AdmissionQueue(r.replica_id) for r in replicas}
        self._tokens: Dict[Tuple[int, int], np.ndarray] = {}
        # shared-preamble token blocks, keyed (preamble_id, length)
        self._preambles: Dict[Tuple[int, int], np.ndarray] = {}
        self._slots: Dict[int, Tuple[int, int]] = {}  # cid -> (node, slot)
        self._decode_q: Dict[int, List[_TurnTask]] = {
            r.replica_id: [] for r in replicas}
        # rotation staging: ready turns (prefill done) waiting to merge
        # into the node's batch at the next chunk cut, as (ready_t, seq,
        # task) — seq keeps merge order deterministic at equal timestamps
        self._ready: Dict[int, List[Tuple[float, int, _TurnTask]]] = {
            r.replica_id: [] for r in replicas}
        # logical time of the pending _iterate event per node (None = no
        # cut scheduled); lets refills kick an idle rotation awake without
        # flooding the heap with duplicate cut events
        self._iter_at: Dict[int, Optional[float]] = {
            r.replica_id: None for r in replicas}
        self._events: List[Tuple[float, int, object]] = []
        self._seq = itertools.count()
        self._now = 0.0
        self.transfer_bytes = 0.0
        self.n_transfers = 0
        # ----- failure contract state -----
        self.tool_deadline_s = tool_deadline_s
        self.tool_timeout_action = tool_timeout_action
        self.max_transfer_retries = int(max_transfer_retries)
        self.transfer_retry_backoff_s = float(transfer_retry_backoff_s)
        self.journal = ConversationJournal()
        self._convs: Dict[int, Conversation] = {}
        # recovery generation per cid: bumped at every rewind so in-flight
        # finish events from before the failure are recognizably stale
        self._gen: Dict[int, int] = {}
        # arrival_t of each conversation's CURRENT in-flight turn (lets a
        # failure rewind keep the turn's original TTFT reference point)
        self._turn_arrival: Dict[int, float] = {}
        # recovery trigger time per cid (failure, or tool return to a dead/
        # evicted binding) — closed into recovery_latency_s at re-bind
        self._recover_t0: Dict[int, float] = {}
        self._bind_attempts: Dict[int, int] = {}
        self._transfer_fault_budget = 0
        self.n_transfer_retries = 0
        self.n_tool_evictions = 0
        self.n_recoveries = 0
        # ----- replica lifecycle state -----
        self.quarantine_k = quarantine_k
        self.quarantine_window = int(quarantine_window)
        self.quarantine_rejoin_k = quarantine_rejoin_k
        # injected slowdown factor per replica (1.0 = healthy); stretches
        # every measured dt on the logical clock — see inject_slowdown
        self._slow: Dict[int, float] = {}
        # incarnation counter per replica: bumped at every revival so
        # fail -> recover -> fail cycles are distinguishable observations
        self._node_gen: Dict[int, int] = {
            r.replica_id: 0 for r in replicas}
        self.log: List[str] = []
        # sampled token stream per (cid, turn_idx) when record_tokens is
        # set — first token from the turn's prefill, then every decoded
        # token in order (lets tests assert end-to-end token equality
        # across decode modes)
        self.sampled_tokens: Dict[Tuple[int, int], List[int]] = {}
        # spans: the replicas publish on this bus too
        self.tracer = Tracer(self.bus, lambda: self._now)
        for r in replicas:
            r.tracer = self.tracer
        # open spans while tracing: cid -> (span id, host_t0_ns) of the
        # conversation, and its turn's
        self._conv_spans: Dict[int, Tuple[int, int]] = {}
        self._turn_spans: Dict[int, _TurnSpan] = {}

    # ----- spans -----------------------------------------------------------------
    def _open_turn(self, cid: int, idx: int, t: float):
        """Turn `idx` of `cid` became runnable at `t`. A turn already open
        (re-planned, or recovering) keeps its start."""
        ts = self._turn_spans.get(cid)
        if ts is None or ts.turn_idx != idx:
            self._turn_spans[cid] = _TurnSpan(
                self.tracer.new_id(), idx, t, time.perf_counter_ns(),
                self._gen.get(cid, 0))

    def _span(self, name: str, cid: int, t0: float, t: float,
              node_id: Optional[int] = None, **attrs):
        """Publish [t0, t] under `cid`'s open turn (with no parent if the
        turn opened before tracing began)."""
        ts = self._turn_spans.get(cid)
        if ts is None:
            self.tracer.emit(name, t0, t, None, cid, None, node_id, **attrs)
            return
        self.tracer.emit(name, t0, t, ts.span_id, cid, ts.turn_idx, node_id,
                         attempt=self._gen.get(cid, 0) - ts.gen, **attrs)

    def _call(self, name: str, cid: int, node_id: int):
        """A span around a replica call, under `cid`'s open turn as in
        `_span` (``with``; None with tracing off)."""
        ts = self._turn_spans.get(cid)
        if ts is None:
            return self.tracer.call(name, None, cid, None, node_id)
        return self.tracer.call(name, ts.span_id, cid, ts.turn_idx, node_id,
                                attempt=self._gen.get(cid, 0) - ts.gen)

    def _staged(self, cid: int, t: float):
        """`cid`'s open turn staged for decode at `t`."""
        ts = self._turn_spans.get(cid)
        if ts is not None:
            ts.staged_t = t

    def _joined(self, cid: int, t: float, node_id: int,
                interrupted: bool = False):
        """`cid`'s staged turn joins a chunk starting at `t`, or a failure
        at `t` cuts it off (at its staging, if that lies later): its
        ``server.wait_join``."""
        ts = self._turn_spans.get(cid)
        if ts is not None and ts.staged_t is not None:
            attrs = {"interrupted": True} if interrupted else {}
            self._span("server.wait_join", cid, ts.staged_t,
                       max(ts.staged_t, t), node_id, **attrs)
            ts.staged_t = None

    def _close_turn(self, conv: Conversation, idx: int, t: float,
                    node_id: int):
        """Turn `idx` finished at `t`: its span and, after the last turn,
        the conversation's."""
        tr, cid = self.tracer, conv.cid
        cs = self._conv_spans.get(cid)
        ts = self._turn_spans.get(cid)
        if ts is not None and ts.turn_idx == idx:
            del self._turn_spans[cid]
            tr.emit("server.turn", ts.t0, t, None if cs is None else cs[0],
                    cid, idx, node_id, span_id=ts.span_id,
                    host_t0_ns=ts.host_t0_ns)
        if idx + 1 == conv.n_turns and cs is not None:
            del self._conv_spans[cid]
            tr.emit("server.conversation", conv.arrival_s, t, None, cid,
                    node_id=node_id, span_id=cs[0], host_t0_ns=cs[1])

    def _on_admit(self, adm: Admission, node_id: int, now: float):
        if self.tracer.on:
            kind = ("recovery" if adm.kind == "arrival"
                    and adm.cid in self._recover_t0 else adm.kind)
            self._span("server.admission", adm.cid, adm.offered_t,
                       max(adm.offered_t, now), node_id, kind=kind)

    # ----- helpers ---------------------------------------------------------------
    def _preamble_token_block(self, preamble_id: int, n: int) -> np.ndarray:
        """Deterministic shared-preamble token content: keyed per
        (preamble_id, length), NOT per cid, so every conversation declaring
        the same preamble gets byte-identical prefix bytes — which is what
        makes `prefix_hash` actually collide across them (the pool keys on
        token content, never on the trace-level id)."""
        key = (int(preamble_id), int(n))
        if key not in self._preambles:
            vocab = next(iter(self.replicas.values())).cfg.vocab_size
            rng = np.random.RandomState(
                (self.seed * 1000003 + 0x5eed + preamble_id * 104729)
                % (2 ** 31))
            self._preambles[key] = rng.randint(
                0, vocab, size=n).astype(np.int32)
        return self._preambles[key]

    def _turn_tokens(self, conv: Conversation, idx: int) -> np.ndarray:
        # keyed per (cid, turn) so token content is independent of the ORDER
        # turns are first reached — decode chunking / scheduling / ADMISSION
        # changes may reorder events, and token streams must stay comparable
        # across runs
        key = (conv.cid, idx)
        if key not in self._tokens:
            vocab = next(iter(self.replicas.values())).cfg.vocab_size
            rng = np.random.RandomState(
                (self.seed * 1000003 + conv.cid * 9973 + idx * 7919)
                % (2 ** 31))
            toks = rng.randint(
                0, vocab, size=conv.turns[idx].append_tokens).astype(np.int32)
            if (idx == 0 and conv.preamble_id is not None
                    and conv.preamble_tokens > 0):
                # turn 1 opens with the shared preamble; only the tail past
                # it is per-conversation content
                toks[:conv.preamble_tokens] = self._preamble_token_block(
                    conv.preamble_id, conv.preamble_tokens)
            self._tokens[key] = toks
        return self._tokens[key]

    def _prefix_split(self, conv: Conversation, node: ReplicaEngine) -> int:
        """The prefix length turn 1 splits at on `node` (0 = no split): the
        declared preamble, EXCEPT for frontend models, whose prefill
        prepends non-token positions the split cannot express — there
        neither the pool nor the split applies, consistently, so streams
        stay comparable pool-on vs pool-off."""
        if conv.preamble_tokens <= 0 or node.cfg.frontend != "none":
            return 0
        return conv.preamble_tokens

    def _pool_probe(self, node_id: int, conv: Conversation) -> Optional[int]:
        """OBSERVED pool state at offer time: returns the delta-token
        prefill-compute charge when `node_id`'s pool currently holds this
        conversation's preamble rows (side-effect-free `contains` — the hit
        counter records only reads that feed a prefill), else None (charge
        the full first turn). The charge is fixed at offer time; if the
        entry is evicted before the prefill runs, the recompute is honest
        extra work, not a new backlog charge — the counter stays an
        observation of what was known when the work was accepted."""
        node = self.replicas[node_id]
        p = self._prefix_split(conv, node)
        if p <= 0 or node.prefix_pool is None:
            return None
        key = prefix_hash(self._turn_tokens(conv, 0)[:p])
        if node.prefix_pool.contains(key):
            return conv.first_input_len - p
        return None

    def _sync_pool_state(self, node_id: int):
        """Mirror the replica's prefix-pool ground truth into the NodeState
        observables (strict accounting asserts exactly this equality)."""
        pool = self.replicas[node_id].prefix_pool
        if pool is None:
            return
        st = self.states[node_id]
        st.pooled_prefix_tokens = pool.pooled_tokens
        st.pooled_prefix_entries = pool.n_entries
        st.pooled_prefix_hits = pool.total_hits
        st.pooled_prefix_evictions = pool.n_evictions

    def _push(self, t: float, fn):
        heapq.heappush(self._events, (t, next(self._seq), fn))

    def call_at(self, t: float, fn) -> "EngineServer":
        """Schedule `fn()` on the event heap at logical time `t` — the hook
        chaos drivers arm time-scheduled faults through."""
        self._push(max(t, self._now), fn)
        return self

    @property
    def now_s(self) -> float:
        return self._now

    def _stretched(self, node_id: int, dt: float) -> float:
        """Apply any injected slowdown to a measured compute time before it
        advances the logical clock (and hence the observed TBT EMA). Token
        content never changes — a straggler is slow, not wrong."""
        return dt * self._slow.get(node_id, 1.0)

    # ----- Runtime protocol --------------------------------------------------------
    def submit(self, convs: List[Conversation]) -> "EngineServer":
        self._assert_accepting()
        for c in convs:
            self._convs[c.cid] = c
            self.records[c.cid] = ConversationRecord(c.cid, c.arrival_s)
            self._make_session(c.cid, c.arrival_s)
            # staged arrival injection: a submission landing after logical
            # time passed its arrival stamp executes at now (the logical
            # clock must never run backwards); the session keeps the trace's
            # arrival_s, so the gap is measured as queue wait, not erased
            self._push(max(c.arrival_s, self._now),
                       lambda c=c: self._arrive(c))
        return self

    def run(self) -> "EngineServer":
        self.run_pending()
        self.close()
        return self

    def run_pending(self, max_events: Optional[int] = None) -> int:
        n = 0
        while self._events and (max_events is None or n < max_events):
            t, _, fn = heapq.heappop(self._events)
            self._now = t
            fn()
            n += 1
        return n

    def results(self) -> List[ConversationRecord]:
        return [r for r in self.records.values() if r.turns]

    def serve(self, convs: List[Conversation]) -> List[ConversationRecord]:
        return self.submit(convs).run().results()

    def _can_admit(self, node_id: int, adm: Admission) -> bool:
        """Ground truth: a free KV slot on the replica. A slot is a fixed
        max_ctx region, so a free slot IS the headroom guarantee — except
        for work that can never fit, which must fail loudly, not queue
        forever."""
        node = self.replicas[node_id]
        if self._never_fits(node_id, adm):
            # mirror SlotKVCache.acquire()'s message style: name the
            # conversation, the node, and the slot headroom it could never
            # fit into — a refill candidate that cannot EVER fit must fail
            # loudly at offer time, not rot in the queue
            raise RuntimeError(
                f"conversation {adm.cid} can never fit on replica "
                f"{node_id}: needs {adm.need_tokens} KV tokens but every "
                f"slot holds max_ctx={node.kv.max_ctx} "
                f"({int(node.kv.active.sum())}/{node.kv.n_slots} slots "
                f"active, {node.kv.active_kv_tokens} live KV tokens); no "
                f"amount of queueing or refill can admit it")
        return bool((~node.kv.active).any())

    def _never_fits(self, node_id: int, adm: Admission) -> bool:
        return adm.need_tokens > self.replicas[node_id].kv.max_ctx

    def check_accounting(self):
        """Assert every NodeState observable mirrors its replica's KV ground
        truth (satellite of the runtime redesign: observation means the
        counters must BE the state, not an estimate of it). The prefill
        backlog counter is included: at every event boundary a node's
        `queued_prefill_tokens` must equal exactly the first-turn tokens of
        the arrivals PARKED in its admission queue (admitted turn-1
        prefills run synchronously, so nothing is admitted-unstarted when
        this runs) — the counter must follow a re-placed arrival to the
        queue that actually holds it, not to where it eventually runs."""
        for nid, node in self.replicas.items():
            st = self.states[nid]
            assert st.active_kv_tokens == node.kv.active_kv_tokens, (
                f"replica {nid}: NodeState.active_kv_tokens="
                f"{st.active_kv_tokens} != kv ground truth "
                f"{node.kv.active_kv_tokens}")
            assert st.used_slots == int(node.kv.active.sum()), (
                f"replica {nid}: NodeState.used_slots={st.used_slots} != "
                f"{int(node.kv.active.sum())} active KV slots")
            parked = sum(a.charge for a in
                         self._admission[nid].admissions("arrival"))
            assert st.queued_prefill_tokens == parked, (
                f"replica {nid}: NodeState.queued_prefill_tokens="
                f"{st.queued_prefill_tokens} != {parked} prefill-compute "
                f"tokens parked in its admission queue (backlog counter "
                f"drift; charges are delta-tokens for observed pool hits)")
            pool = node.prefix_pool
            if pool is not None:
                assert st.pooled_prefix_tokens == pool.pooled_tokens, (
                    f"replica {nid}: NodeState.pooled_prefix_tokens="
                    f"{st.pooled_prefix_tokens} != pool ground truth "
                    f"{pool.pooled_tokens}")
                assert st.pooled_prefix_entries == pool.n_entries, (
                    f"replica {nid}: NodeState.pooled_prefix_entries="
                    f"{st.pooled_prefix_entries} != {pool.n_entries}")
                assert st.pooled_prefix_hits == pool.total_hits, (
                    f"replica {nid}: NodeState.pooled_prefix_hits="
                    f"{st.pooled_prefix_hits} != {pool.total_hits}")
                assert st.pooled_prefix_evictions == pool.n_evictions, (
                    f"replica {nid}: NodeState.pooled_prefix_evictions="
                    f"{st.pooled_prefix_evictions} != {pool.n_evictions}")

    # ----- arrival & turn-1 prefill -------------------------------------------------
    def _arrive(self, conv: Conversation):
        if self.tracer.on:
            self._conv_spans[conv.cid] = (self.tracer.new_id(),
                                          time.perf_counter_ns())
            self._open_turn(conv.cid, 0, conv.arrival_s)
        pl = self.sched.place_first_prefill(view_of(conv), self.view)
        st = self.states[pl.node_id]
        # backlog observable covers parked + admitted-unstarted prefill
        # work. With an OBSERVED pool hit on the placed node, only the
        # delta past the pooled preamble is prefill COMPUTE — charging the
        # full turn would overstate the backlog `prefill_backlog_s` reads
        # (need_tokens stays the full context: the slot still lands all of
        # it, so the headroom/fit ask is unchanged).
        delta = self._pool_probe(pl.node_id, conv)
        charge = conv.first_input_len if delta is None else delta
        st.queued_prefill_tokens += charge
        self._offer(pl.node_id,
                    Admission(conv.cid, conv.first_input_len,
                              lambda nid, conv=conv, charge=charge:
                              self._prefill_turn1(conv, nid, charge),
                              kind="arrival",
                              charge_tokens=None if delta is None else delta,
                              offered_t=conv.arrival_s),
                    self._now)

    def _on_reoffer_move(self, adm: Admission, from_node: int, to_node: int):
        """A reoffer policy moved a parked admission: the prefill backlog
        observable follows the ARRIVAL to the queue that now holds it, at
        the instant it moves. (It used to follow only when the prefill
        finally RAN, so a twice-parked arrival left the counter sitting on
        the first node for the whole parked interval — the backlog drift
        strict accounting now rejects.)"""
        if adm.kind == "arrival":
            self.states[from_node].queued_prefill_tokens -= adm.charge
            self.states[to_node].queued_prefill_tokens += adm.charge

    def _prefill_turn1(self, conv: Conversation, node_id: int,
                       charge: Optional[int] = None):
        node = self.replicas[node_id]
        st = self.states[node_id]
        start = max(self._now, self.clock[node_id])
        self.sessions[conv.cid].transition(PREFILLING, start)

        # run the real prefill; a declared preamble ALWAYS splits turn 1 at
        # its boundary (the split, not the pool, fixes the math — streams
        # stay byte-identical pool-on vs pool-off)
        slot = node.kv.acquire()
        st.used_slots += 1
        tokens = self._turn_tokens(conv, 0)
        fe = None
        if node.cfg.frontend != "none":
            fe = torch.zeros((1, node.cfg.frontend_len or node.cfg.encoder_seq,
                              node.cfg.d_model), dtype=node.cfg.torch_dtype,
                             device=node.device)
        with self._call("server.prefill", conv.cid, node_id) as sp:
            next_tok, dt = node.prefill_conversation(
                slot, tokens, fe, prefix_len=self._prefix_split(conv, node))
        dt = self._stretched(node_id, dt)
        if sp is not None:
            self._span("server.wait_replica", conv.cid, self._now, start,
                       node_id)
            sp.close(start, start + dt, len=len(tokens))
        self._sync_pool_state(node_id)
        done_t = start + dt
        self.clock[node_id] = done_t
        st.queued_prefill_tokens -= (conv.first_input_len if charge is None
                                     else charge)
        # mirror the slot's WRITTEN length (includes frontend positions),
        # not the nominal input length — the two drift for frontend models
        written = int(node.kv.lengths[slot])
        st.active_kv_tokens += written

        if node.role in ("decode", "mixed"):
            # collocated: stay put
            self._bind_done(conv, node_id, slot, int(next_tok), done_t)
            return
        # disaggregated: bind decoder + one-shot transfer. The prefiller's
        # slot frees NOW (the package travels host-side); the binding itself
        # must pass admission on the decoder.
        bind = self.sched.bind_decoder(view_of(conv), self.view)
        pkg = node.kv.export_slot(slot)
        node.kv.release(slot)
        st.used_slots -= 1
        st.active_kv_tokens -= written
        self._pump(node_id, self._now)
        # if the decoder is full, the binding parks at its prefill-completion
        # time (done_t): that is when the package became ready to move
        self._offer(bind.node_id,
                    Admission(conv.cid, pkg["length"],
                              lambda nid, conv=conv, pkg=pkg,
                              nt=int(next_tok), done_t=done_t:
                              self._transfer_bind(conv, nid, pkg, nt,
                                                  max(done_t, self._now))),
                    done_t)

    def _transfer_bind(self, conv: Conversation, node_id: int, pkg,
                       next_tok: int, t: float, turn_idx: int = 0,
                       arrival_t: Optional[float] = None):
        """One-shot KV transfer onto the admitted decoder (t = when the
        package starts moving: prefill completion, or the later admission;
        turn_idx > 0 when the binding resumes a failure-recovered turn).
        An armed transfer fault (`inject_transfer_faults`) kills the attempt
        before any KV lands; the binding retries with exponential backoff on
        a decoder the scheduler chooses fresh, bounded by
        `max_transfer_retries` — then fails loudly."""
        dec = self.replicas[node_id]
        st = self.states[node_id]
        self.sessions[conv.cid].transition(TRANSFERRING, t)
        if self._transfer_fault_budget > 0:
            self._transfer_fault_budget -= 1
            self.n_transfer_retries += 1
            attempt = self._bind_attempts.get(conv.cid, 0) + 1
            self._bind_attempts[conv.cid] = attempt
            if attempt > self.max_transfer_retries:
                raise RuntimeError(
                    f"KV transfer for conversation {conv.cid} failed on "
                    f"{attempt} consecutive attempts "
                    f"(max_transfer_retries={self.max_transfer_retries}); "
                    f"giving up loudly")
            backoff = self.transfer_retry_backoff_s * (2 ** (attempt - 1))
            if self.tracer.on:
                self._span("server.transfer", conv.cid, t, t + backoff,
                           node_id, nbytes=0, failed=True)
            self.log.append(
                f"t={t:.3f} KV transfer to replica {node_id} FAILED for "
                f"cid {conv.cid} (attempt {attempt}); retrying in "
                f"{backoff:.3f}s")

            def retry(conv=conv, pkg=pkg, nt=next_tok, idx=turn_idx,
                      at=arrival_t):
                # re-ask the scheduler at RETRY time: the view may have
                # changed (the faulty target may be gone or full)
                pl = self.sched.bind_decoder(view_of(conv), self.view)
                self._offer(pl.node_id,
                            Admission(conv.cid, pkg["length"],
                                      lambda nid: self._transfer_bind(
                                          conv, nid, pkg, nt,
                                          max(t + backoff, self._now),
                                          turn_idx=idx, arrival_t=at)),
                            self._now)

            self._push(t + backoff, retry)
            return
        self._bind_attempts.pop(conv.cid, None)
        dslot = dec.kv.acquire()
        st.used_slots += 1
        dec.kv.import_slot(dslot, pkg)
        st.active_kv_tokens += pkg["length"]
        nbytes = dec.kv.nbytes_of(pkg)
        self.transfer_bytes += nbytes
        self.n_transfers += 1
        self.records[conv.cid].n_kv_transfers += 1
        xfer_t = nbytes / self.link_bw + 0.005
        if self.tracer.on:
            self._span("server.transfer", conv.cid, t, t + xfer_t, node_id,
                       nbytes=nbytes)
        self._bind_done(conv, node_id, dslot, next_tok, t + xfer_t,
                        turn_idx=turn_idx, arrival_t=arrival_t)

    def _bind_done(self, conv, node_id, slot, next_tok, t, turn_idx: int = 0,
                   arrival_t: Optional[float] = None):
        self._slots[conv.cid] = (node_id, slot)
        self.sessions[conv.cid].node_id = node_id
        st = self.states[node_id]
        st.active_conversations += 1
        t0 = self._recover_t0.pop(conv.cid, None)
        if t0 is not None:
            # recovery closed: trigger -> interrupted turn's decode runnable
            self.records[conv.cid].recovery_latency_s.append(t - t0)
        self._begin_decode(conv, turn_idx, next_tok, t, arrival_t=arrival_t)

    # ----- decode ---------------------------------------------------------------------
    def _begin_decode(self, conv, turn_idx, next_tok, ready_t,
                      arrival_t=None):
        """A turn's prefill completed at logical time `ready_t`: hand it to
        the bound node's decode rotation (`arrival_t`, default ready_t, is
        when the turn became RUNNABLE — tool returned / conversation
        arrived — and feeds its TTFT). Under rotation the task STAGES
        immediately (host-side) and merges into the batch at the first
        chunk cut whose start covers ready_t — no event-heap round trip, so
        a refill never misses the next chunk. With rotation off it rides
        the event heap exactly as before: the task lands in the queue when
        its event fires and joins at the following chunk boundary (the
        chunk-boundary-only admission baseline)."""
        node_id, slot = self._slots[conv.cid]
        sess = self.sessions[conv.cid]
        sess.turn_idx = turn_idx
        sess.transition(DECODING, ready_t)
        task = _TurnTask(conv=conv, turn_idx=turn_idx, slot=slot,
                         remaining=conv.turns[turn_idx].output_tokens,
                         next_token=next_tok,
                         arrival_t=ready_t if arrival_t is None else arrival_t,
                         stream=[next_tok],
                         gen=self._gen.get(conv.cid, 0))
        self._turn_arrival[conv.cid] = task.arrival_t
        if self.tracer.on:
            self._staged(conv.cid, ready_t)
        if self.record_tokens:
            # alias the task's live stream: a failure rewind rebuilds the
            # task, so the dict always points at the CURRENT attempt's tokens
            self.sampled_tokens[(conv.cid, turn_idx)] = task.stream
        # the turn's opening token (the prefill argmax, stream[0]) exists
        # the moment the task stages — publish it from here so subscribers
        # concatenating `tokens` payloads reproduce task.stream exactly
        self._publish(EV_TOKENS, ready_t, cid=conv.cid, turn_idx=turn_idx,
                      node_id=node_id, tokens=[next_tok], per_token_s=0.0)
        if self.rotation:
            self._ready[node_id].append((ready_t, next(self._seq), task))
            self._kick(node_id, ready_t)
        else:
            self._push(ready_t, lambda: self._enqueue_task(node_id, task))

    def _enqueue_task(self, node_id: int, task: _TurnTask):
        """Legacy (rotation=False) join: at the event time, append to the
        decode queue; the task is batched from the next chunk boundary on."""
        q = self._decode_q[node_id]
        q.append(task)
        if len(q) == 1:
            self._push(max(self._now, self.clock[node_id]),
                       lambda: self._iterate(node_id))

    def _kick(self, node_id: int, t: float):
        """Schedule a chunk cut at logical time >= t unless one is already
        pending no later than t (duplicate cut events are harmless — the
        clock serializes chunks — but pointless)."""
        t = max(t, self._now)
        at = self._iter_at[node_id]
        if at is not None and at <= t:
            return
        self._iter_at[node_id] = t
        self._push(t, lambda: self._iterate(node_id))

    def _merge_ready(self, node_id: int, start: float):
        """Refill supply #1: merge staged ready turns (completed prefills /
        post-tool next-turns of conversations pinned here) whose ready time
        is covered by the chunk start, in (ready_t, seq) order."""
        staged = self._ready[node_id]
        if not staged:
            return
        staged.sort()
        join = [s for s in staged if s[0] <= start]
        if not join:
            return
        self._ready[node_id] = staged[len(join):]
        self._decode_q[node_id].extend(task for _, _, task in join)

    def _refill_supply(self, node_id: int) -> bool:
        """Observed refill supply at a chunk cut: conversations parked in
        this node's admission queue, or staged ready turns not yet coverable
        by the chunk start (e.g. an in-flight remote-turn return). Both are
        state the runtime already owns — queue depth and staged work are
        observations; nothing predicts WHEN a tool returns."""
        return (self.states[node_id].queued_conversations > 0
                or bool(self._ready[node_id]))

    def _iterate(self, node_id: int):
        node = self.replicas[node_id]
        if not self.states[node_id].alive:
            return  # stale chunk-cut event for a replica that since died
        if self.rotation:
            # one chunk cut: refill the batch from both supplies before
            # sizing the chunk. Suppress re-kicks while cutting — staging
            # during the merge below must not spawn duplicate cut events.
            self._iter_at[node_id] = self._now
            start = max(self._now, self.clock[node_id])
            self._merge_ready(node_id, start)          # supply 1: ready turns
            if len(self._admission[node_id]):
                # supply 2: parked admissions — sessions leave QUEUED at
                # the cut (mid-tail), ordered by Scheduler.select_refill;
                # an admitted arrival prefills inline (advancing the node
                # clock) and stages, so the second merge batches it.
                # Pumped even with every slot busy: reoffer policies are
                # entitled to drain a still-full node's queue toward idle
                # peers at every cut (the default FIFO breaks immediately)
                self._pump(node_id, self._now)
                start = max(start, self.clock[node_id])
                self._merge_ready(node_id, start)
            q = self._decode_q[node_id]
            if not q:
                self._iter_at[node_id] = None
                staged = self._ready[node_id]
                if staged:  # future-ready work only: cut again when it lands
                    self._kick(node_id, min(s[0] for s in staged))
                return
            start = max(start, self.clock[node_id])
        else:
            q = self._decode_q[node_id]
            if not q:
                return
        n_slots = node.kv.n_slots
        next_tokens = np.zeros(n_slots, np.int32)
        emit = np.zeros(n_slots, bool)
        rem = np.zeros(n_slots, np.int32)
        for task in q:
            s = task.slot
            next_tokens[s] = task.next_token
            emit[s] = True
            # per-slot room: each slot's chunk share is clamped to ITS OWN
            # headroom — one long-context neighbor no longer shrinks (or
            # falsely trips) the whole batch's chunk
            room = node.kv.max_ctx - int(node.kv.lengths[s])
            if room <= 0:
                # a silent overflow would drop the scattered KV write while
                # host lengths keep advancing — fail loudly in BOTH modes
                raise RuntimeError(
                    f"KV slot overflow on replica {node_id}: slot {s} "
                    f"(cid {task.conv.cid}) is at max_ctx={node.kv.max_ctx} "
                    f"with {task.remaining} output tokens remaining")
            # floor 1 covers zero-output turns — pre-PR decoded one there
            rem[s] = max(1, min(task.remaining, self.max_decode_chunk, room))
        if not self.rotation:
            start = max(self._now, self.clock[node_id])

        if self.tracer.on:
            for task in q:
                self._joined(task.conv.cid, start, node_id)
        if self.decode_mode == "reference":
            n = 1
            rem = np.minimum(rem, 1)
            sampled, dt = node.decode_step_all_reference(next_tokens, emit)
            seq = sampled[None]
        else:
            if self.rotation and self._refill_supply(node_id):
                # rotation under pressure: cut at the earliest OBSERVED
                # in-flight finish horizon (bucket-floored min(remaining)),
                # floored at rotation_min_chunk so per-dispatch overhead
                # stays amortized — a lane finishing below the floor
                # freezes for at most (floor - remaining) steps, and the
                # freed slot turns around into waiting work at the cut
                # instead of idling to the batch's longest tail
                lo, hi = int(rem[emit].min()), int(rem[emit].max())
                n = decode_chunk_floor(
                    max(lo, min(hi, self.rotation_min_chunk)))
            else:
                # no refill supply (or rotation off): ragged chunk sized
                # from the LONGEST remaining task — a nearly-finished slot
                # freezes mid-scan while its neighbors run on; cutting
                # early here would only buy dispatch overhead, since no
                # waiting work could use the freed lane
                n = decode_chunk_floor(int(rem[emit].max()))
            rem = np.minimum(rem, n)
            seq, dt = node.decode_steps(next_tokens, emit, rem)
        dt = self._stretched(node_id, dt)
        t_done = start + dt
        per_tok = dt / n
        self.clock[node_id] = t_done
        st = self.states[node_id]
        # rotation observables: lane-step counters of the dispatch that just
        # ran (scan computes every slot in lockstep for n steps; an emitting
        # slot is live for its own rem share, a masked no-op after)
        st.decode_scan_steps += n
        st.decode_lane_steps_emitting += n * int(emit.sum())
        st.decode_lane_steps_live += int(rem[emit].sum())
        ema = st.observed_tbt_ema_s
        st.observed_tbt_ema_s = 0.9 * ema + 0.1 * per_tok if ema else per_tok
        # one observed decode chunk: advance the straggler-quarantine
        # machine on the EMA that just updated (shared Runtime trigger)
        self._observe_chunk_tbt(node_id, t_done)

        for task in q:
            slot = task.slot
            took = int(rem[slot])
            if task.first_token_t is None:
                # per-token timestamps interpolate the measured chunk time
                task.first_token_t = start + per_tok
            task.remaining -= took
            task.next_token = int(seq[took - 1, slot])
            new_toks = [int(t) for t in seq[:took, slot]]
            task.stream.extend(new_toks)
            # per-token emission out of the chunk that just ran: the tokens
            # and their interpolated timestamps are the same values the
            # stream/finish bookkeeping above already owns
            self._publish(EV_TOKENS, start + per_tok, cid=task.conv.cid,
                          turn_idx=task.turn_idx, node_id=node_id,
                          tokens=new_toks, per_token_s=per_tok)
            st.active_kv_tokens += took
            if task.remaining <= 0:
                # mid-chunk finish: this turn's last token landed at step
                # `took`, not at the chunk boundary — emit the finish event
                # at its interpolated timestamp so tool time (and the next
                # turn's prefill) starts there instead of waiting for the
                # batch's longest slot
                t_fin = start + took * per_tok
                self._push(t_fin, lambda task=task, t=t_fin:
                           self._finish_turn(task, t))
        # rebuild the queue once per iteration (not O(n) removes per finish)
        self._decode_q[node_id] = q = [t for t in q if t.remaining > 0]
        if self.rotation:
            # schedule the next cut; finish events above land first (their
            # interpolated times are <= t_done), so releases pump the
            # admission queue and post-tool turns stage before the cut
            self._iter_at[node_id] = None
            if q or self._ready[node_id]:
                self._kick(node_id, t_done)
        elif q:
            # chunk-boundary baseline: newly-ready turns join at the NEXT
            # boundary after their event lands
            self._push(t_done, lambda: self._iterate(node_id))

    def _finish_turn(self, task: _TurnTask, t: float):
        conv, idx = task.conv, task.turn_idx
        if task.gen != self._gen.get(conv.cid, 0):
            # finish event from before a failure rewound this conversation:
            # the turn's partial output was discarded and is being replayed
            # (the replayed finish will land with the current generation)
            return
        turn = conv.turns[idx]
        sess = self.sessions[conv.cid]
        if self.tracer.on:
            self._close_turn(conv, idx, t, self._slots[conv.cid][0])
        self.journal.record(conv.cid, idx, task.stream)
        self._publish(EV_TURN_FINISH, t, cid=conv.cid, turn_idx=idx,
                      node_id=self._slots[conv.cid][0],
                      n_output_tokens=turn.output_tokens)
        self.records[conv.cid].turns.append(TurnRecord(
            turn_idx=idx, arrival_s=task.arrival_t,
            first_token_s=task.first_token_t, last_token_s=t,
            n_output_tokens=turn.output_tokens))
        if idx + 1 < conv.n_turns:
            sess.transition(TOOL_WAIT, t)
            sess.turn_idx = idx + 1
            ready = t + turn.tool_time_s
            self._push(ready, lambda: self._next_turn(conv, idx + 1, ready))
            if self.tool_deadline_s is not None:
                self._push(t + self.tool_deadline_s,
                           lambda gen=task.gen:
                           self._tool_watchdog(conv, idx + 1, gen,
                                               t + self.tool_deadline_s))
        else:
            sess.transition(DONE, t)
            self.journal.drop(conv.cid)
            self._turn_arrival.pop(conv.cid, None)
            # _gen is kept: a pre-rewind finish event can still be in the
            # heap after DONE, and must keep reading as stale
            node_id, slot = self._slots.pop(conv.cid)
            node = self.replicas[node_id]
            st = self.states[node_id]
            st.active_kv_tokens -= int(node.kv.lengths[slot])
            st.active_conversations -= 1
            node.kv.release(slot)
            st.used_slots -= 1
            self.sched.on_conversation_end(conv.cid, self.view)
            if self.strict_accounting:
                self.check_accounting()
            # occupancy freed: re-offer parked admissions (backpressure)
            self._pump(node_id, self._now)
            # a DRAINING node whose last resident tail just left rejoins
            self._maybe_finish_draining(node_id, self._now)

    # ----- turn 2+ --------------------------------------------------------------------
    def _next_turn(self, conv: Conversation, idx: int, ready_t: float):
        if self.tracer.on:
            self._open_turn(conv.cid, idx, ready_t)
        binding = self._slots.get(conv.cid)
        if binding is None or not self.states[binding[0]].alive:
            # the tool returned to a dead binding (replica failed during
            # TOOL_WAIT) or an evicted one (tool-deadline watchdog freed the
            # slot): lazy recovery by journaled replay, mirroring the
            # simulator's _on_turn_arrival. The turn becomes runnable NOW,
            # so its TTFT reference point is ready_t.
            self._recover(conv, idx, ready_t)
            return
        node_id, slot = binding
        node = self.replicas[node_id]
        ctx = int(node.kv.lengths[slot])
        tv = TurnView(cid=conv.cid, turn_idx=idx,
                      append_tokens=conv.turns[idx].append_tokens,
                      context_tokens=ctx)
        pl = self.sched.place_turn(tv, node_id, self.view)
        tokens = self._turn_tokens(conv, idx)
        self.records[conv.cid].n_kv_transfers += int(pl.kv_transfer)

        if pl.node_id == node_id:
            # ConServe fast path: local append-prefill with hot prefix; the
            # slot is already held, so no admission is involved
            start = max(ready_t, self.clock[node_id])
            self.sessions[conv.cid].transition(PREFILLING, start)
            with self._call("server.append", conv.cid, node_id) as sp:
                next_tok, dt = node.append_prefill(slot, tokens)
            dt = self._stretched(node_id, dt)
            if sp is not None:
                self._span("server.wait_replica", conv.cid, ready_t, start,
                           node_id)
                sp.close(start, start + dt, len=len(tokens), prev=ctx)
            self.clock[node_id] = start + dt
            self.states[node_id].active_kv_tokens += len(tokens)
            self._begin_decode(conv, idx, int(next_tok), start + dt,
                               arrival_t=ready_t)
            return
        # remote append-prefill needs a temporary slot on the remote node —
        # that acquisition passes admission like every other one
        self.records[conv.cid].n_remote_turns += 1
        self._offer(pl.node_id,
                    Admission(conv.cid, ctx + len(tokens),
                              lambda nid, conv=conv, idx=idx:
                              self._remote_turn(conv, idx, nid,
                                                max(ready_t, self._now)),
                              kind="turn"),
                    self._now)

    def _remote_turn(self, conv: Conversation, idx: int, remote_id: int,
                     ready_t: float):
        """Remote append-prefill: move KV to the remote node, prefill there,
        move back (bidirectional — the per-turn disaggregation penalty)."""
        node_id, slot = self._slots[conv.cid]
        node = self.replicas[node_id]
        remote = self.replicas[remote_id]
        rst = self.states[remote_id]
        tokens = self._turn_tokens(conv, idx)
        self.sessions[conv.cid].transition(TRANSFERRING, ready_t)
        pkg = node.kv.export_slot(slot)
        nbytes = node.kv.nbytes_of(pkg)
        rslot = remote.kv.acquire()
        rst.used_slots += 1
        remote.kv.import_slot(rslot, pkg)
        rst.active_kv_tokens += pkg["length"]
        freed = max(ready_t, self.clock[remote_id])
        t0 = freed + nbytes / self.link_bw
        self.sessions[conv.cid].transition(PREFILLING, t0)
        with self._call("server.append", conv.cid, remote_id) as sp:
            next_tok, dt = remote.append_prefill(rslot, tokens)
        dt = self._stretched(remote_id, dt)
        if sp is not None:
            self._span("server.wait_replica", conv.cid, ready_t, freed,
                       remote_id)
            self._span("server.transfer", conv.cid, freed, t0, remote_id,
                       nbytes=nbytes)
            sp.close(t0, t0 + dt, len=len(tokens), prev=pkg["length"])
        # the append landed in the remote slot: mirror it before the release
        # below subtracts the slot's full (grown) length
        rst.active_kv_tokens += len(tokens)
        pkg2 = remote.kv.export_slot(rslot)
        nbytes2 = remote.kv.nbytes_of(pkg2)
        rst.active_kv_tokens -= int(remote.kv.lengths[rslot])
        remote.kv.release(rslot)
        rst.used_slots -= 1
        node.kv.import_slot(slot, pkg2)
        self.transfer_bytes += nbytes + nbytes2
        self.n_transfers += 2
        done = t0 + dt + nbytes2 / self.link_bw
        if sp is not None:
            self._span("server.transfer", conv.cid, t0 + dt, done, node_id,
                       nbytes=nbytes2)
        self.clock[remote_id] = t0 + dt
        self.states[node_id].active_kv_tokens += len(tokens)
        self._pump(remote_id, self._now)
        self._begin_decode(conv, idx, int(next_tok), done, arrival_t=ready_t)

    # ----- failure contract -----------------------------------------------------------
    def fail_replica(self, node_id: int, at_s: float) -> "EngineServer":
        """Schedule replica `node_id` to die at logical time `at_s`. Same
        injection API as ClusterSimulator.inject_failure: every in-flight
        conversation on the dead replica recovers by deterministic journaled
        replay on a healthy one, and parked admissions re-place through the
        same scheduler decision points that placed them."""
        self._push(at_s, lambda: self._fail(node_id))
        return self

    # simulator-API parity, so benchmarks drive both backends uniformly
    inject_failure = fail_replica

    def recover_replica(self, node_id: int, at_s: float) -> "EngineServer":
        """Schedule failed replica `node_id` to REJOIN at logical time
        `at_s`, cold: its slot cache and prefix pool stay invalidated (they
        died with the node), resident counters are zero, cumulative
        counters (hits, evictions, replayed tokens) survive — they count
        events that already happened. The node re-enters
        `ClusterView.nodes()` and every admission queue is pumped so parked
        work can land on the fresh capacity immediately. fail -> recover ->
        fail cycles are legal (per-node generations); recovering a replica
        that is still alive raises."""
        self._push(at_s, lambda: self._recover_node(node_id))
        return self

    # simulator-API parity (mirrors fail_replica / inject_failure)
    revive_node = recover_replica

    def _recover_node(self, node_id: int):
        st = self.states[node_id]
        if st.alive:
            raise RuntimeError(
                f"replica {node_id} is already alive; only a failed "
                f"replica can rejoin")
        st.alive = True
        st.lifecycle = NODE_ACTIVE
        # the EMA observed the PREVIOUS incarnation's chunks; the rejoined
        # replica starts with no observations of its own
        st.observed_tbt_ema_s = 0.0
        self._node_gen[node_id] = self._node_gen.get(node_id, 0) + 1
        # the node's logical clock never ran backwards while dead
        self.clock[node_id] = max(self.clock[node_id], self._now)
        self._rejoin_node(node_id, self._now, reason="from_dead")

    def _node_has_inflight(self, node_id: int) -> bool:
        """In-flight work resident on `node_id`: batched or staged decode
        tasks, plus any session whose KV slot binding names the node
        (TOOL_WAIT sessions hold their slot between turns)."""
        if self._decode_q[node_id] or self._ready[node_id]:
            return True
        return any(nid == node_id for nid, _ in self._slots.values())

    def inject_slowdown(self, node_id: int, factor: float,
                        at_s: Optional[float] = None) -> "EngineServer":
        """Stretch replica `node_id`'s measured compute times by `factor`
        on the logical clock from `at_s` (immediately when None). The
        straggler is SLOW, not wrong: token content is untouched, but every
        dt the server measures — prefill, append-prefill, decode chunks —
        is multiplied before it advances the node clock, so the TBT EMA
        observes the slowdown and the quarantine trigger can act on it.
        factor=1.0 ends the slowdown."""
        def arm():
            self._slow[node_id] = float(factor)
        if at_s is None:
            arm()
        else:
            self._push(at_s, arm)
        return self

    def _fail(self, node_id: int):
        node = self.replicas[node_id]
        st = self.states[node_id]
        if not st.alive:
            raise RuntimeError(f"replica {node_id} failed twice")
        st.alive = False
        self._lifecycle_streaks.pop(node_id, None)
        # find the victims BEFORE tearing state down. Only DECODING sessions
        # need immediate replay (staged ready turns included — their session
        # is already DECODING); TOOL_WAIT sessions hold no runnable work and
        # recover lazily when their tool returns to the dead binding.
        # PREFILLING/TRANSFERRING run synchronously inside one event, so no
        # session can be caught mid-stage at an event boundary.
        victims = []
        for cid, (nid, _slot) in list(self._slots.items()):
            if nid != node_id:
                continue
            sess = self.sessions[cid]
            if sess.state == DECODING:
                victims.append((self._convs[cid], sess.turn_idx,
                                self._turn_arrival.get(cid, self._now)))
                if self.tracer.on:
                    self._joined(cid, self._now, node_id, interrupted=True)
            else:
                # a TOOL_WAIT session's binding dies WITH the node: sever it
                # now so a later revival (recover_replica) can't make the
                # stale slot reference look valid again — the tool return
                # finds no binding and recovers by journaled replay exactly
                # as it would against a still-dead node
                self._slots.pop(cid)
                sess.node_id = None
        # the replica's KV is gone at once: invalidate every slot and zero
        # the mirroring observables wholesale (strict accounting keeps
        # checking dead replicas against exactly this ground truth)
        node.kv.invalidate_all()
        if node.prefix_pool is not None:
            # pooled rows die with the node's slot cache: drop them so a
            # recovered conversation re-populates through the normal miss
            # path instead of dangling a reference to dead device buffers
            node.prefix_pool.invalidate_all()
        st.active_kv_tokens = 0
        st.used_slots = 0
        st.active_conversations = 0
        st.reserved_kv_tokens = 0
        # resident pool observables zero with the pool; the cumulative
        # hit/eviction counters survive (events that already happened)
        self._sync_pool_state(node_id)
        self._decode_q[node_id] = []
        self._ready[node_id] = []
        self._iter_at[node_id] = None
        self.log.append(
            f"t={self._now:.3f} replica {node_id} FAILED; replaying "
            f"{len(victims)} in-flight conversations on healthy replicas "
            f"(tool-waiting ones recover lazily)")
        self._publish(EV_NODE_FAILURE, self._now, node_id=node_id,
                      n_victims=len(victims))
        # parked admissions would never be pumped: re-place each through the
        # SAME decision point that placed it (shared Runtime mechanism —
        # raises loudly if no healthy target exists)
        self._drain_dead_node(node_id, self._now)
        for conv, turn_idx, arrival_t in victims:
            self._recover(conv, turn_idx, arrival_t)

    def _recover(self, conv: Conversation, turn_idx: int, arrival_t: float):
        """Deterministic replay of conversation `conv` interrupted at turn
        `turn_idx`: rewind the session (force=True), rebuild the journaled
        context by re-prefilling it on a scheduler-chosen healthy replica
        through the arrival admission path (same backpressure as a fresh
        conversation), then resume the interrupted turn's decode. Replica
        determinism makes the recovered token streams byte-identical to a
        failure-free run; replay compute is charged to
        `replayed_prefill_tokens`, never to the victim's turn records."""
        cid = conv.cid
        self._gen[cid] = self._gen.get(cid, 0) + 1
        # the interrupted turn's already-published tokens are now stale;
        # this must publish BEFORE the replay path can emit the replacement
        # argmax token, so subscribers reset their (cid, turn_idx)
        # accumulation and the replay re-streams it byte-identically
        self._publish(EV_RECOVERY, self._now, cid=cid, turn_idx=turn_idx)
        self._slots.pop(cid, None)
        rec = self.records[cid]
        rec.recovered = True
        self.n_recoveries += 1
        self._recover_t0[cid] = self._now
        sess = self.sessions[cid]
        sess.node_id = None
        sess.turn_idx = turn_idx
        sess.transition(QUEUED, self._now, force=True)
        if self.tracer.on:
            self._open_turn(cid, turn_idx, arrival_t)
        ctx = self._journal_context(conv, turn_idx)
        self.log.append(
            f"t={self._now:.3f} recovering cid {cid} at turn {turn_idx}: "
            f"re-prefilling {len(ctx)} journaled context tokens")
        pl = self.sched.place_first_prefill(view_of(conv), self.view)
        # replay backlog is real prefill backlog — schedulers must see it
        self.states[pl.node_id].queued_prefill_tokens += len(ctx)
        self._offer(pl.node_id,
                    Admission(cid, len(ctx),
                              lambda nid, conv=conv, idx=turn_idx,
                              at=arrival_t:
                              self._replay_prefill(conv, idx, nid, at),
                              kind="arrival"),
                    self._now)

    def _journal_context(self, conv: Conversation, turn_idx: int
                         ) -> np.ndarray:
        """The exact token sequence whose prefill rebuilds `conv`'s KV for
        resuming turn `turn_idx`: each completed turn's deterministic input
        followed by its journaled KV-fed stream, then the interrupted turn's
        input. Byte-identity of the replay rests on this being exact, so a
        journal/turn mismatch is kept loud."""
        done = self.journal.n_completed(conv.cid)
        if done != turn_idx:
            raise RuntimeError(
                f"journal holds {done} completed turns for conversation "
                f"{conv.cid} but recovery targets turn {turn_idx}")
        parts = []
        for t in range(turn_idx):
            parts.append(self._turn_tokens(conv, t))
            parts.append(np.asarray(
                self.journal.fed_tokens(conv.cid, t), np.int32))
        parts.append(self._turn_tokens(conv, turn_idx))
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def _replay_prefill(self, conv: Conversation, turn_idx: int,
                        node_id: int, arrival_t: float):
        """Admitted recovery prefill: rebuild the journaled context in one
        AOT prefill dispatch, then rebind exactly like a turn-1 prefill —
        stay put on a decode-capable node, or one-shot transfer to a
        scheduler-chosen decoder."""
        node = self.replicas[node_id]
        st = self.states[node_id]
        start = max(self._now, self.clock[node_id])
        self.sessions[conv.cid].transition(PREFILLING, start)
        slot = node.kv.acquire()
        st.used_slots += 1
        ctx = self._journal_context(conv, turn_idx)
        fe = None
        if node.cfg.frontend != "none":
            fe = torch.zeros((1, node.cfg.frontend_len or node.cfg.encoder_seq,
                              node.cfg.d_model), dtype=node.cfg.torch_dtype,
                             device=node.device)
        # replay splits at the SAME preamble boundary the original turn-1
        # did (the journaled ctx opens with it), so the rebuilt stream is
        # byte-identical to the failure-free run and the healthy node's
        # pool serves/repopulates the preamble exactly like a fresh arrival
        with self._call("server.prefill", conv.cid, node_id) as sp:
            next_tok, dt = node.prefill_conversation(
                slot, ctx, fe, prefix_len=self._prefix_split(conv, node))
        dt = self._stretched(node_id, dt)
        if sp is not None:
            self._span("server.wait_replica", conv.cid, self._now, start,
                       node_id)
            sp.close(start, start + dt, len=len(ctx), replay=True)
        self._sync_pool_state(node_id)
        done_t = start + dt
        self.clock[node_id] = done_t
        st.queued_prefill_tokens -= len(ctx)
        st.replayed_prefill_tokens += len(ctx)
        written = int(node.kv.lengths[slot])
        st.active_kv_tokens += written
        if node.role in ("decode", "mixed"):
            self._bind_done(conv, node_id, slot, int(next_tok), done_t,
                            turn_idx=turn_idx, arrival_t=arrival_t)
            return
        pkg = node.kv.export_slot(slot)
        node.kv.release(slot)
        st.used_slots -= 1
        st.active_kv_tokens -= written
        self._pump(node_id, self._now)
        bind = self.sched.bind_decoder(view_of(conv), self.view)
        self._offer(bind.node_id,
                    Admission(conv.cid, pkg["length"],
                              lambda nid, conv=conv, pkg=pkg,
                              nt=int(next_tok), done_t=done_t,
                              idx=turn_idx, at=arrival_t:
                              self._transfer_bind(conv, nid, pkg, nt,
                                                  max(done_t, self._now),
                                                  turn_idx=idx,
                                                  arrival_t=at)),
                    done_t)

    def _replace_admission(self, adm: Admission, now: float) -> Optional[int]:
        """Re-place one admission drained off a dead node through the SAME
        decision point that placed it (Runtime._drain_dead_node guards the
        returned target)."""
        conv = self._convs[adm.cid]
        if adm.kind == "arrival":
            return self.sched.place_first_prefill(view_of(conv),
                                                  self.view).node_id
        if adm.kind == "bind":
            return self.sched.bind_decoder(view_of(conv), self.view).node_id
        # a parked remote-turn package: the conversation is still bound
        # (with live KV) elsewhere — re-plan the whole turn placement from
        # scratch rather than re-offering a package that was never built
        sess = self.sessions[adm.cid]
        self._push(now, lambda idx=sess.turn_idx:
                   self._next_turn(conv, idx, now))
        return None

    def _tool_watchdog(self, conv: Conversation, next_idx: int, gen: int,
                       deadline_t: float):
        """TOOL_WAIT deadline: the session entered TOOL_WAIT before turn
        `next_idx` and its tool has not returned by `deadline_t`. "evict"
        frees the slot for waiting work — the tool return re-admits through
        journaled replay, exactly the dead-binding path; "fail" raises
        loudly. A watchdog that fires after the tool returned (or after the
        binding already died/recovered) is a no-op."""
        cid = conv.cid
        sess = self.sessions[cid]
        if (gen != self._gen.get(cid, 0) or sess.state != TOOL_WAIT
                or sess.turn_idx != next_idx or cid not in self._slots):
            return
        node_id, slot = self._slots[cid]
        if not self.states[node_id].alive:
            return  # binding already dead; the tool return replays anyway
        if self.tool_timeout_action == "fail":
            raise RuntimeError(
                f"conversation {cid} exceeded the tool deadline: turn "
                f"{next_idx} still TOOL_WAIT at t={deadline_t:.3f} "
                f"(tool_deadline_s={self.tool_deadline_s}); "
                f"tool_timeout_action='fail'")
        node = self.replicas[node_id]
        st = self.states[node_id]
        st.active_kv_tokens -= int(node.kv.lengths[slot])
        node.kv.release(slot)
        st.used_slots -= 1
        st.active_conversations -= 1
        self._slots.pop(cid)
        sess.node_id = None
        self.records[cid].n_tool_evictions += 1
        self.n_tool_evictions += 1
        self.log.append(
            f"t={deadline_t:.3f} tool deadline: evicted cid {cid} from "
            f"replica {node_id} (turn {next_idx} still waiting); slot freed "
            f"for parked work, tool return re-admits by replay")
        # the freed slot turns around into waiting work immediately
        self._pump(node_id, self._now)
        self._maybe_finish_draining(node_id, self._now)

    def inject_transfer_faults(self, n: int = 1) -> "EngineServer":
        """Arm `n` one-shot KV-transfer failures: each of the next `n`
        `_transfer_bind` attempts dies before any KV lands and retries with
        backoff on a freshly scheduler-chosen decoder (bounded by
        `max_transfer_retries`, then loud)."""
        self._transfer_fault_budget += int(n)
        return self
