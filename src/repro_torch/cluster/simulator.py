"""Discrete-event cluster simulator for conversation-level serving.

The simulator owns all *mechanism* — prefill queues, continuous-batching
decode iterations, chunked prefill interleave, KV transfers, tool-call
timers, prefix caches, energy integration, failures — and delegates every
*placement* decision to a `repro_torch.core.Scheduler` through the observable
`ClusterView` only. The same scheduler classes drive the port's engine
(`repro_torch.engine`), so policy code is exercised identically at both scales.

Fidelity notes (mapped to the paper):
 * Prefiller: FIFO job queue; job latency from the offline-profiled curve
   (§3.1); chunked so energy/util integrate smoothly.
 * Decoder: iteration-level continuous batching. Iteration latency from
   NodeCostModel.decode_iteration_s(batch, active KV bytes, prefill chunk)
   — reproducing Fig. 4/5 (memory saturation, collocation interference,
   prefix-cache effects).
 * Remote turn-2+ prefill (AMPD-wrong / FullDisagg) pays the bidirectional
   KV move (§2.2) and, for FullDisagg, the full-context recompute.
 * Failures: a dead decoder's conversations recover by deterministic replay
   — re-prefill the journaled context on the prefiller and rebind; exactly
   ConServe's one-shot mechanism, reused (DESIGN.md §5).
 * Decode rotation: decoder iterations are single-token and jobs leave the
   batch the moment their output completes, so the simulator is structurally
   a continuous rotation — conversation ends pump the admission queue at the
   iteration (= chunk cut) where the slot freed, `Scheduler.select_refill`
   orders mid-tail refills through the shared `Runtime._pump`, and the
   engine's lane observables (`masked_forward_fraction`,
   `slot_busy_fraction`) are maintained on `NodeState` at this fidelity too
   (masked forwards are 0 by construction; see `_iterate`).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.conversation import Conversation, TurnView, view_of
from repro_torch.core.events import (EV_NODE_FAILURE, EV_RECOVERY, EV_TOKENS,
                               EV_TURN_FINISH)
from repro_torch.core.metrics import ConversationRecord, TurnRecord
from repro_torch.core.runtime import (Admission, AdmissionQueue, DECODING, DONE,
                                PREFILLING, PrefixKVPool, Runtime,
                                ServeSession, TOOL_WAIT, TRANSFERRING)
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.signals import NODE_ACTIVE, ClusterView, NodeState

from .hardware import NodeCostModel

# Simulated nodes are KV-headroom-limited by default; a finite slot count is
# opt-in (SimNode.n_slots) because slot exhaustion is an engine-level
# artifact the cost model has no analogue for unless declared.
UNBOUNDED_SLOTS = 1 << 30


# --------------------------------------------------------------------------- #
# Node runtime state
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class PrefillJob:
    cid: int
    turn_idx: int
    n_tokens: int            # tokens to (re)compute
    context_tokens: int      # total context after this prefill
    enqueued_s: float
    on_done: Callable[[float], None]
    extra_busy_s: float = 0.0  # KV I/O the node stalls on (remote turns: the
    #                            inbound history read + outbound write-back,
    #                            §5.5's "memory-heavy work on the prefiller")
    warm_prefix: bool = False  # turn-1 prefix served from the node's prefix
    #                            KV pool (observed hit at admission): only
    #                            n_tokens past the pooled preamble are
    #                            compute; the cost model's cached_prefix
    #                            (context - n_tokens) covers the rest


@dataclasses.dataclass
class DecodeJob:
    cid: int
    turn_idx: int
    remaining_prefill: int   # append tokens still to chunk through
    remaining_decode: int
    context_tokens: int      # current KV length for this conversation
    turn_arrival_s: float
    first_token_s: Optional[float] = None
    cold_prefix: bool = False


@dataclasses.dataclass
class SimNode:
    node_id: int
    role: str                          # "prefill" | "decode" | "mixed"
    cost: NodeCostModel
    n_slots: Optional[int] = None      # finite KV slot count (None=unbounded)
    # token budget for the node-level prefix KV pool (0 = no pool), SEPARATE
    # from kv_capacity — same contract as ReplicaEngine.prefix_pool_tokens.
    # The simulator's pool stores no rows (caches=None), only the observed
    # token volume + reuse counters, keyed by preamble identity; it ages
    # under the same shared eviction rule as the engine's.
    prefix_pool_tokens: int = 0
    prefix_pool: Optional[PrefixKVPool] = None
    state: NodeState = None
    prefill_q: List[PrefillJob] = dataclasses.field(default_factory=list)
    decode_jobs: Dict[int, DecodeJob] = dataclasses.field(default_factory=dict)
    busy_until_s: float = 0.0
    iterating: bool = False
    slow_factor: float = 1.0           # straggler injection
    alive: bool = True
    # incarnation counter: bumped at every revival so completion callbacks
    # dispatched against a PREVIOUS incarnation read as stale (the node
    # died and rejoined while the work was notionally in flight)
    gen: int = 0
    # energy accounting
    energy_j: float = 0.0
    last_energy_t: float = 0.0
    busy_s: float = 0.0

    def integrate_energy(self, now: float, active_power_w: float):
        dt = max(now - self.last_energy_t, 0.0)
        self.energy_j += dt * active_power_w
        self.last_energy_t = now


# --------------------------------------------------------------------------- #
# Simulator
# --------------------------------------------------------------------------- #
class ClusterSimulator(Runtime):
    def __init__(self, scheduler: Scheduler, nodes: List[SimNode],
                 chunk_tokens: int = 8192, decoder_chunk_tokens: int = 2944,
                 track_token_times: bool = False,
                 tool_deadline_s: Optional[float] = None,
                 tool_timeout_action: str = "evict",
                 strict_accounting: bool = False,
                 max_transfer_retries: int = 3,
                 transfer_retry_backoff_s: float = 0.01,
                 quarantine_k: Optional[float] = None,
                 quarantine_window: int = 3,
                 quarantine_rejoin_k: Optional[float] = None):
        """tool_deadline_s / tool_timeout_action: TOOL_WAIT watchdog, same
        contract as EngineServer — off by default (None); "evict" frees the
        waiting conversation's KV for parked work (the tool return re-admits
        by deterministic replay, the dead-binding path), "fail" raises
        loudly. Nothing parks forever on a tool that never returns.
        strict_accounting: engine-parity drift detection — at every
        conversation end, assert the structural accounting invariants
        (`check_accounting`).
        max_transfer_retries / transfer_retry_backoff_s: bound on one-shot
        KV-transfer attempts per binding, same contract (and same
        exhaustion error) as EngineServer — see `inject_transfer_faults`.
        quarantine_k / quarantine_window / quarantine_rejoin_k: the
        observed-straggler quarantine trigger (Runtime contract; None
        disables it) — see EngineServer for the semantics."""
        assert tool_timeout_action in ("evict", "fail")
        self.sched = scheduler
        self.tool_deadline_s = tool_deadline_s
        self.tool_timeout_action = tool_timeout_action
        self.strict_accounting = strict_accounting
        self.max_transfer_retries = int(max_transfer_retries)
        self.transfer_retry_backoff_s = float(transfer_retry_backoff_s)
        self.quarantine_k = quarantine_k
        self.quarantine_window = int(quarantine_window)
        self.quarantine_rejoin_k = quarantine_rejoin_k
        self.nodes = {n.node_id: n for n in nodes}
        for n in nodes:
            cap = n.cost.kv_capacity_tokens()
            n.state = NodeState(node_id=n.node_id, role=n.role,
                                kv_capacity_tokens=cap,
                                slot_capacity=n.n_slots or UNBOUNDED_SLOTS)
            if n.prefix_pool_tokens > 0 and n.prefix_pool is None:
                n.prefix_pool = PrefixKVPool(n.prefix_pool_tokens)
        self.chunk_tokens = chunk_tokens
        self.decoder_chunk_tokens = decoder_chunk_tokens
        self.track_token_times = track_token_times
        curve = nodes[0].cost.prefill_curve()
        self.view = ClusterView({n.node_id: n.state for n in nodes}, curve)

        self._events: List[Tuple[float, int, Callable]] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.records: Dict[int, ConversationRecord] = {}
        self.sessions: Dict[int, ServeSession] = {}
        self._admission: Dict[int, AdmissionQueue] = {
            n.node_id: AdmissionQueue(n.node_id) for n in nodes}
        self._convs: Dict[int, Conversation] = {}
        self._bound: Dict[int, int] = {}
        self._turn_recs: Dict[int, List[TurnRecord]] = {}
        self.kv_transfer_bytes = 0.0
        self.n_kv_transfers = 0
        self.bind_counts: Dict[int, int] = {}
        self.log: List[str] = []
        # conversations evicted by the tool-deadline watchdog: their KV is
        # gone but the binding is remembered; tool return recovers by replay
        self._evicted: set = set()
        self.n_tool_evictions = 0
        # one-shot KV-transfer fault state (engine parity)
        self._bind_attempts: Dict[int, int] = {}
        self._transfer_fault_budget = 0
        self.n_transfer_retries = 0

    # ----- admission (Runtime contract) ----------------------------------------
    def _can_admit(self, node_id: int, adm: Admission) -> bool:
        """Ground truth for the cost-model backend: the node is alive, has a
        free KV slot (finite only when declared) and enough token headroom
        for the work's context. Work that can never fit fails loudly."""
        st = self.nodes[node_id].state
        if self._never_fits(node_id, adm):
            # mirror the engine's (and SlotKVCache.acquire()'s) message
            # style: name the conversation, the node, and the headroom it
            # could never fit into — at offer time, not from a later pump
            raise RuntimeError(
                f"conversation {adm.cid} can never fit on node {node_id}: "
                f"needs {adm.need_tokens} KV tokens but the node holds "
                f"{st.kv_capacity_tokens} total ({st.used_slots}/"
                f"{st.slot_capacity} slots used, {st.kv_headroom_tokens} KV "
                f"tokens of headroom); no amount of queueing or refill can "
                f"admit it")
        return (st.alive and st.free_slots > 0
                and st.kv_headroom_tokens >= adm.need_tokens)

    def _never_fits(self, node_id: int, adm: Admission) -> bool:
        return adm.need_tokens > self.nodes[node_id].state.kv_capacity_tokens

    def _reserve(self, st: NodeState, need_tokens: int):
        """Admitted work holds its slot + token reservation until the KV
        actually lands (_start_turn turn 0 converts reserved -> active)."""
        st.used_slots += 1
        st.reserved_kv_tokens += need_tokens

    # ----- event plumbing ------------------------------------------------------
    def at(self, t: float, fn: Callable):
        heapq.heappush(self._events, (max(t, self.now), next(self._seq), fn))

    def call_at(self, t: float, fn: Callable) -> "ClusterSimulator":
        """Engine-parity alias for `at` (the hook chaos drivers arm
        time-scheduled faults through on either backend)."""
        self.at(t, fn)
        return self

    @property
    def now_s(self) -> float:
        return self.now

    def run(self, until: Optional[float] = None):
        self.run_pending(until=until)
        if until is None:
            self.close()  # flushes idle energy, then rejects late submits
        else:
            for n in self.nodes.values():
                n.integrate_energy(self.now, n.cost.tier.idle_w)
        return self

    def run_pending(self, max_events: Optional[int] = None,
                    until: Optional[float] = None) -> int:
        """Incremental drive (Runtime contract): pop up to `max_events`
        pending events without closing, so staged submissions keep landing
        between calls. An event past `until` stays in the heap."""
        n = 0
        while self._events and (max_events is None or n < max_events):
            if until is not None and self._events[0][0] > until:
                break
            t, _, fn = heapq.heappop(self._events)
            self.now = t
            fn()
            n += 1
        return n

    def close(self):
        # flush idle energy to the end of the run before sealing the clock
        for n in self.nodes.values():
            n.integrate_energy(self.now, n.cost.tier.idle_w)
        super().close()

    # ----- workload entry -------------------------------------------------------
    def submit(self, convs: List[Conversation]):
        self._assert_accepting()
        for c in convs:
            self._convs[c.cid] = c
            self.records[c.cid] = ConversationRecord(c.cid, c.arrival_s)
            self._make_session(c.cid, c.arrival_s)
            self._turn_recs[c.cid] = []
            self.at(c.arrival_s, lambda c=c: self._on_arrival(c))
        return self

    # ----- arrival / prefill ------------------------------------------------------
    def _on_arrival(self, conv: Conversation):
        pl = self.sched.place_first_prefill(view_of(conv), self.view)
        node = self.nodes[pl.node_id]
        if node.role == "mixed":
            # collocated: the conversation RESIDES on the mixed node from its
            # first prefill chunk on, so arrival itself passes admission
            self._offer(pl.node_id,
                        Admission(conv.cid, conv.first_input_len,
                                  lambda nid, conv=conv:
                                  self._admit_arrival(conv, nid),
                                  kind="arrival"),
                        self.now)
            return
        # dedicated prefiller: jobs stream through a FIFO without holding
        # long-term KV residency; backpressure applies at the decoder bind
        self._admit_arrival(conv, pl.node_id)

    # ----- prefix KV pool (simulator mirror) -----------------------------------
    def _pool_key(self, conv: Conversation):
        """The simulator's pool key is the preamble IDENTITY — it has no
        token bytes to content-hash (the engine keys on `prefix_hash` of the
        actual tokens; the trace generator guarantees the two coincide:
        same (preamble_id, length) => byte-identical prefix)."""
        if conv.preamble_id is None or conv.preamble_tokens <= 0:
            return None
        return (conv.preamble_id, conv.preamble_tokens)

    def _pool_prefix_hit(self, node: SimNode, conv: Conversation) -> int:
        """OBSERVED pool hit at admission time: the pooled preamble length
        this turn-1 prefill job skips (0 = miss / no pool / no preamble).
        A hit records on the entry's reuse counters — it feeds the job."""
        key = self._pool_key(conv)
        if key is None or node.prefix_pool is None:
            return 0
        if node.prefix_pool.get(key) is None:  # get() records the hit
            return 0
        self._sync_pool_state(node)
        return conv.preamble_tokens

    def _pool_populate(self, node: SimNode, conv: Conversation):
        """Miss-path completion: install the preamble's token volume under
        the shared eviction rule (no-op if another conversation populated
        it first, or the node died while the job was in flight)."""
        key = self._pool_key(conv)
        if key is None or node.prefix_pool is None or not node.alive:
            return
        node.prefix_pool.put(key, None, conv.preamble_tokens,
                             conv.preamble_tokens)
        self._sync_pool_state(node)

    def _sync_pool_state(self, node: SimNode):
        """Mirror the node's prefix-pool ground truth into the NodeState
        observables (same mirror contract as the engine backend)."""
        pool = node.prefix_pool
        if pool is None:
            return
        st = node.state
        st.pooled_prefix_tokens = pool.pooled_tokens
        st.pooled_prefix_entries = pool.n_entries
        st.pooled_prefix_hits = pool.total_hits
        st.pooled_prefix_evictions = pool.n_evictions

    def _admit_arrival(self, conv: Conversation, node_id: int):
        node = self.nodes[node_id]
        mixed = node.node_id if node.role == "mixed" else None
        if mixed is not None:
            # the slot lands the FULL context either way (pooled rows fold
            # in); only the prefill COMPUTE charge below shrinks on a hit
            self._reserve(node.state, conv.first_input_len)
        self.sessions[conv.cid].transition(PREFILLING, self.now)
        pooled = self._pool_prefix_hit(node, conv)

        def on_done(t, conv=conv, node=node, mixed=mixed, pooled=pooled):
            if not pooled:
                self._pool_populate(node, conv)
            self._after_first_prefill(conv, t, mixed_node=mixed)

        job = PrefillJob(
            cid=conv.cid, turn_idx=0,
            n_tokens=conv.first_input_len - pooled,
            context_tokens=conv.first_input_len, enqueued_s=self.now,
            on_done=on_done, warm_prefix=pooled > 0)
        self._enqueue_prefill(node, job)

    def _enqueue_prefill(self, node: SimNode, job: PrefillJob):
        node.state.queued_prefill_tokens += job.n_tokens
        if node.role == "mixed":
            # collocated: prefill chunks ride the decode iterations
            dj = DecodeJob(cid=job.cid, turn_idx=job.turn_idx,
                           remaining_prefill=job.n_tokens, remaining_decode=0,
                           context_tokens=job.context_tokens,
                           turn_arrival_s=job.enqueued_s,
                           cold_prefix=not job.warm_prefix)
            dj._prefill_done = job.on_done  # type: ignore[attr-defined]
            node.decode_jobs[(job.cid << 8) + job.turn_idx] = dj
            self._kick_iteration(node)
        else:
            node.prefill_q.append(job)
            self._kick_prefiller(node)

    def _kick_prefiller(self, node: SimNode):
        if node.iterating or not node.prefill_q or not node.alive:
            return
        node.iterating = True
        gen = node.gen
        job = node.prefill_q.pop(0)
        dur = node.cost.prefill_s(job.context_tokens,
                                  cached_prefix=job.context_tokens - job.n_tokens)
        dur = dur * node.slow_factor + job.extra_busy_s
        node.integrate_energy(self.now, node.cost.tier.idle_w)

        def done():
            if not node.alive:
                # the prefiller died mid-job: the computation never landed —
                # re-place the job on a healthy prefill-capable node
                node.iterating = False
                node.state.queued_prefill_tokens -= job.n_tokens
                self._replace_prefill_job(node.node_id, job)
                return
            if node.gen != gen:
                # the node died AND rejoined while the job was in flight:
                # the computation still never landed — re-place it, but
                # leave the NEW incarnation's iterating flag alone (it owns
                # the flag now)
                node.state.queued_prefill_tokens -= job.n_tokens
                self._replace_prefill_job(node.node_id, job)
                return
            node.integrate_energy(
                self.now, node.cost.power_w(1.0, memory_bound=False))
            node.busy_s += dur
            node.state.queued_prefill_tokens -= job.n_tokens
            node.iterating = False
            job.on_done(self.now)
            self._kick_prefiller(node)

        self.at(self.now + dur, done)

    def _after_first_prefill(self, conv: Conversation, t: float,
                             mixed_node: Optional[int] = None):
        if mixed_node is not None:
            # collocated: the conversation already lives on the mixed replica
            self._bound[conv.cid] = mixed_node
            g = self.nodes[mixed_node].gen
            self.at(t, lambda: self._start_turn(conv, 0, mixed_node,
                                                arrival_t=conv.arrival_s,
                                                gen=g))
            return
        # the one-shot KV binding passes admission on the chosen decoder:
        # when it is full (no slot / headroom for this context) the binding
        # parks in the decoder's admission queue and is re-offered as
        # conversations end — backpressure, not silent overcommit
        pl = self.sched.bind_decoder(view_of(conv), self.view)
        self._offer(pl.node_id,
                    Admission(conv.cid, conv.first_input_len,
                              lambda nid, conv=conv, t=t,
                              kv=pl.kv_transfer:
                              self._bind(conv, nid, max(t, self.now), kv)),
                    t)

    def _bind(self, conv: Conversation, node_id: int, t: float,
              kv_transfer: bool):
        dec = self.nodes[node_id]
        if kv_transfer and self._transfer_fault_budget > 0:
            # armed one-shot transfer fault (engine parity): the attempt
            # dies before any KV lands; the binding retries with
            # exponential backoff on a decoder the scheduler chooses
            # FRESH at retry time, bounded by max_transfer_retries
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
            self.sessions[conv.cid].transition(TRANSFERRING, t)
            backoff = self.transfer_retry_backoff_s * (2 ** (attempt - 1))
            self.log.append(
                f"t={t:.3f} KV transfer to node {node_id} FAILED for cid "
                f"{conv.cid} (attempt {attempt}); retrying in "
                f"{backoff:.3f}s")

            def retry(conv=conv):
                pl = self.sched.bind_decoder(view_of(conv), self.view)
                self._offer(pl.node_id,
                            Admission(conv.cid, conv.first_input_len,
                                      lambda nid, kv=pl.kv_transfer:
                                      self._bind(conv, nid, self.now, kv)),
                            self.now)

            self.at(t + backoff, retry)
            return
        self._bind_attempts.pop(conv.cid, None)
        self._reserve(dec.state, conv.first_input_len)
        self._bound[conv.cid] = node_id
        self.sessions[conv.cid].node_id = node_id
        self.bind_counts[node_id] = self.bind_counts.get(node_id, 0) + 1
        self.records[conv.cid].n_kv_transfers += int(kv_transfer)
        delay = 0.0
        if kv_transfer:
            self.sessions[conv.cid].transition(TRANSFERRING, t)
            delay = self._transfer(conv.first_input_len, dec)
        self.at(t + delay, lambda g=dec.gen: self._start_turn(
            conv, 0, node_id, arrival_t=conv.arrival_s, gen=g))

    def _transfer(self, n_tokens: int, node: SimNode) -> float:
        self.n_kv_transfers += 1
        self.kv_transfer_bytes += n_tokens * node.cost.model.kv_bytes_per_token
        return node.cost.kv_transfer_s(n_tokens)

    # ----- turns -----------------------------------------------------------------
    def _start_turn(self, conv: Conversation, turn_idx: int, node_id: int,
                    prefilled: bool = True, cold: bool = False,
                    arrival_t: Optional[float] = None,
                    gen: Optional[int] = None):
        """Begin decoding turn `turn_idx` on `node_id`. If not `prefilled`,
        the turn's append tokens still need (chunked) prefill on the node.
        `arrival_t` is when the turn became RUNNABLE (tool returned /
        conversation arrived) — queue and transfer waits count toward its
        TTFT. `gen` is the target's incarnation at schedule time: a landing
        on a node that died (even if it has since rejoined cold — the KV
        never arrived) recovers by replay."""
        node = self.nodes[node_id]
        if not node.alive or (gen is not None and node.gen != gen):
            # the node died while this start was in flight (e.g. mid
            # KV-transfer): the failure's victim scan only sees installed
            # decode jobs, so the landing itself must observe the corpse —
            # recover by replay instead of stranding a job nothing iterates
            self._recover(conv, turn_idx)
            return
        turn = conv.turns[turn_idx]
        ctx = sum(t.append_tokens + t.output_tokens
                  for t in conv.turns[: turn_idx + 1]) - turn.output_tokens
        if turn_idx == 0:
            node.state.active_kv_tokens += conv.first_input_len
            node.state.active_conversations += 1
            # admission reservation becomes live KV
            node.state.reserved_kv_tokens = max(
                0, node.state.reserved_kv_tokens - conv.first_input_len)
        self.sessions[conv.cid].transition(DECODING, self.now, force=True)
        dj = DecodeJob(cid=conv.cid, turn_idx=turn_idx,
                       remaining_prefill=0 if prefilled else turn.append_tokens,
                       remaining_decode=turn.output_tokens,
                       context_tokens=ctx,
                       turn_arrival_s=self.now if arrival_t is None
                       else arrival_t,
                       cold_prefix=cold)
        node.decode_jobs[(conv.cid << 8) + turn_idx] = dj
        self._kick_iteration(node)

    def _on_turn_tokens_done(self, node: SimNode, dj: DecodeJob):
        conv = self._convs[dj.cid]
        turn = conv.turns[dj.turn_idx]
        rec = TurnRecord(turn_idx=dj.turn_idx, arrival_s=dj.turn_arrival_s,
                         first_token_s=dj.first_token_s or self.now,
                         last_token_s=self.now,
                         n_output_tokens=turn.output_tokens)
        self._turn_recs[conv.cid].append(rec)
        # the simulator emits at turn granularity (it owns token COUNTS,
        # not token bytes): one tokens event per completed turn
        self._publish(EV_TOKENS, self.now, cid=conv.cid,
                      turn_idx=dj.turn_idx, node_id=node.node_id,
                      n_tokens=turn.output_tokens,
                      first_token_s=rec.first_token_s)
        self._publish(EV_TURN_FINISH, self.now, cid=conv.cid,
                      turn_idx=dj.turn_idx, node_id=node.node_id,
                      n_output_tokens=turn.output_tokens)
        node.state.active_kv_tokens += turn.output_tokens
        if dj.turn_idx + 1 < conv.n_turns:
            self.sessions[conv.cid].transition(TOOL_WAIT, self.now)
            self.sessions[conv.cid].turn_idx = dj.turn_idx + 1
            self.at(self.now + turn.tool_time_s,
                    lambda: self._on_turn_arrival(conv, dj.turn_idx + 1))
            if self.tool_deadline_s is not None:
                dl = self.now + self.tool_deadline_s
                self.at(dl, lambda: self._tool_watchdog(
                    conv, dj.turn_idx + 1, dl))
        else:
            self._finish_conversation(conv, node)

    def _finish_conversation(self, conv: Conversation, node: SimNode):
        rec = self.records[conv.cid]
        rec.turns = self._turn_recs[conv.cid]
        self.sessions[conv.cid].transition(DONE, self.now, force=True)
        node.state.active_kv_tokens -= conv.peak_context_tokens()
        node.state.active_conversations -= 1
        node.state.used_slots = max(0, node.state.used_slots - 1)
        self.sched.on_conversation_end(conv.cid, self.view)
        if self.strict_accounting:
            self.check_accounting()
        # occupancy freed: re-offer parked admissions (backpressure)
        self._pump(node.node_id, self.now)
        # a DRAINING node whose last resident tail just left re-activates
        self._maybe_finish_draining(node.node_id, self.now)

    def _on_turn_arrival(self, conv: Conversation, turn_idx: int):
        bound = self._bound[conv.cid]
        if conv.cid in self._evicted:
            # tool returned to an evicted binding (deadline watchdog freed
            # the KV): re-admit by replay, exactly the dead-binding path
            self._evicted.discard(conv.cid)
            self._recover(conv, turn_idx)
            return
        if not self.nodes[bound].alive:
            # tool returned to a dead binding: lazy recovery by replay
            self._recover(conv, turn_idx)
            return
        turn = conv.turns[turn_idx]
        ctx = sum(t.append_tokens + t.output_tokens
                  for t in conv.turns[:turn_idx])
        ready_t = self.now
        tv = TurnView(cid=conv.cid, turn_idx=turn_idx,
                      append_tokens=turn.append_tokens, context_tokens=ctx)
        pl = self.sched.place_turn(tv, bound, self.view)
        self.records[conv.cid].n_kv_transfers += int(pl.kv_transfer)
        if pl.node_id == bound:
            # local append-prefill, chunked into the decoder's iterations
            node = self.nodes[bound]
            node.state.active_kv_tokens += turn.append_tokens
            self.sessions[conv.cid].transition(PREFILLING, self.now)
            self._start_turn(conv, turn_idx, bound, prefilled=False)
            return
        # remote turn prefill (AMPD wrong prediction / FullDisagg)
        self.records[conv.cid].n_remote_turns += 1
        if pl.kv_transfer:
            self.sessions[conv.cid].transition(TRANSFERRING, self.now)
        pf = self.nodes[pl.node_id]
        dec = self.nodes[bound]
        dec.state.active_kv_tokens += turn.append_tokens
        full_recompute = self.sched.name == "full_disagg"
        n_new = (ctx + turn.append_tokens) if full_recompute else turn.append_tokens
        # decoder -> prefiller history read + eventual write-back: this KV
        # I/O occupies the prefiller (memory-heavy work mixed into its
        # compute-bound pipeline — §5.5's utilization-drop mechanism)
        t_out = self._transfer(ctx, pf) if pl.kv_transfer else 0.0
        t_back = self._transfer(ctx + turn.append_tokens, dec) \
            if pl.kv_transfer else 0.0
        extra = 0.0 if full_recompute else t_out + t_back

        def enqueue():
            self.sessions[conv.cid].transition(PREFILLING, self.now)
            job = PrefillJob(
                cid=conv.cid, turn_idx=turn_idx, n_tokens=n_new,
                context_tokens=ctx + turn.append_tokens, enqueued_s=self.now,
                on_done=lambda t: back(), extra_busy_s=extra)
            self._enqueue_prefill(pf, job)

        def back():
            # prefiller -> decoder write-back of the new (and, for AMPD,
            # reused) KV entries
            self.at(self.now + t_back,
                    lambda g=dec.gen: self._start_turn(conv, turn_idx,
                                                       bound,
                                                       prefilled=True,
                                                       arrival_t=ready_t,
                                                       gen=g))

        self.at(self.now + t_out, enqueue)

    # ----- decoder iterations -------------------------------------------------
    def _kick_iteration(self, node: SimNode):
        if node.iterating or not node.decode_jobs or not node.alive:
            return
        node.iterating = True
        self._iterate(node)

    def _iterate(self, node: SimNode):
        if not node.decode_jobs or not node.alive:
            node.iterating = False
            if node.alive:
                # the rotation just went idle: a DRAINING node whose last
                # resident tail left re-activates here (the finish hook ran
                # while `iterating` was still set)
                self._maybe_finish_draining(node.node_id, self.now)
            return
        gen = node.gen
        jobs = list(node.decode_jobs.values())
        decoding = [j for j in jobs if j.remaining_prefill == 0
                    and j.remaining_decode > 0]
        prefilling = [j for j in jobs if j.remaining_prefill > 0]
        batch = len(decoding)
        active_kv = sum(j.context_tokens for j in jobs)
        chunk_budget = self.decoder_chunk_tokens if node.role != "prefill" \
            else self.chunk_tokens
        chunk = 0
        cold = False
        for j in prefilling:
            take = min(j.remaining_prefill, chunk_budget - chunk)
            chunk += take
            cold = cold or j.cold_prefix
            if chunk >= chunk_budget:
                break
        dur = node.cost.decode_iteration_s(batch, active_kv, chunk,
                                           cached_chunk=not cold)
        dur *= node.slow_factor
        node.integrate_energy(self.now, node.cost.tier.idle_w)

        def step_done():
            if not node.alive:
                node.iterating = False
                return
            if node.gen != gen:
                # the node died and rejoined mid-iteration: this completion
                # belongs to the previous incarnation (its jobs were
                # recovered at the failure); the new incarnation owns the
                # iterating flag
                return
            node.integrate_energy(
                self.now, node.cost.power_w(1.0, memory_bound=(batch > 0)))
            node.busy_s += dur
            # observable TBT signal (straggler detection reads this)
            if batch:
                ema = node.state.observed_tbt_ema_s
                node.state.observed_tbt_ema_s = (0.9 * ema + 0.1 * dur) \
                    if ema else dur
                # one observed decode chunk: advance the straggler-
                # quarantine machine on the EMA that just updated
                self._observe_chunk_tbt(node.node_id, self.now)
                # rotation observables, mirroring the engine's lane-step
                # counters: the cost model emits one token per live job per
                # iteration and jobs leave the batch the moment they finish,
                # so the simulator is structurally already a continuous
                # rotation — every emitting lane-step is live
                # (masked_forward_fraction == 0 by construction) and
                # slot_busy_fraction tracks batch over declared slots
                node.state.decode_scan_steps += 1
                node.state.decode_lane_steps_emitting += batch
                node.state.decode_lane_steps_live += batch
            # consume prefill chunk
            left = chunk
            for j in list(prefilling):
                take = min(j.remaining_prefill, left)
                j.remaining_prefill -= take
                left -= take
                if getattr(j, "_prefill_done", None) is not None:
                    # mixed-node turn-1 prefill counts toward the queue signal
                    node.state.queued_prefill_tokens = max(
                        0, node.state.queued_prefill_tokens - take)
                if j.remaining_prefill == 0 and j.remaining_decode == 0:
                    # collocated turn-1 prefill job completed
                    cb = getattr(j, "_prefill_done", None)
                    node.decode_jobs.pop((j.cid << 8) + j.turn_idx, None)
                    if cb:
                        cb(self.now)
                if left <= 0:
                    break
            # emit one token per decoding sequence
            for j in decoding:
                if j.first_token_s is None:
                    j.first_token_s = self.now
                j.remaining_decode -= 1
                j.context_tokens += 1
                if j.remaining_decode == 0:
                    node.decode_jobs.pop((j.cid << 8) + j.turn_idx, None)
                    self._on_turn_tokens_done(node, j)
            self._iterate(node)

        self.at(self.now + dur, step_done)

    # ----- faults / elasticity (observation-driven) ----------------------------
    def inject_failure(self, node_id: int, at_s: float):
        self.at(at_s, lambda: self._fail(node_id))
        return self

    # engine-API parity, so benchmarks drive both backends uniformly
    fail_replica = inject_failure

    def _fail(self, node_id: int):
        node = self.nodes[node_id]
        if not node.alive:
            raise RuntimeError(f"node {node_id} failed twice")
        node.integrate_energy(self.now, node.cost.tier.idle_w)
        node.alive = False
        node.state.alive = False
        self._lifecycle_streaks.pop(node_id, None)
        victims = {j.cid for j in node.decode_jobs.values()}
        # sever TOOL_WAIT bindings to the corpse NOW: lazy alive-checks at
        # tool return would be fooled by a revival (the new incarnation's KV
        # is cold — the old slot contents are gone). The existing evicted ->
        # replay path in _on_turn_arrival re-admits them honestly.
        for cid, bnid in self._bound.items():
            if (bnid == node_id and cid not in victims
                    and cid not in self._evicted
                    and self.sessions[cid].state == TOOL_WAIT
                    and not self.records[cid].done):
                self._evicted.add(cid)
        # a dead mixed node's in-iteration turn-1 prefills vanish with the
        # decode jobs: release their share of the backlog observable (the
        # victims re-place it on whatever node recovery chooses)
        for dj in node.decode_jobs.values():
            if getattr(dj, "_prefill_done", None) is not None:
                node.state.queued_prefill_tokens = max(
                    0, node.state.queued_prefill_tokens - dj.remaining_prefill)
        node.decode_jobs.clear()
        if node.prefix_pool is not None:
            # pooled preamble rows die with the node's KV: recovered and
            # future conversations re-populate through the normal miss path
            # (the cumulative hit/eviction counters survive)
            node.prefix_pool.invalidate_all()
        node.state.active_kv_tokens = 0
        node.state.active_conversations = 0
        node.state.used_slots = 0
        node.state.reserved_kv_tokens = 0
        self._sync_pool_state(node)
        self.log.append(f"t={self.now:.1f} node {node_id} FAILED; "
                        f"recovering {len(victims)} in-flight conversations "
                        f"by replay (tool-waiting ones recover lazily)")
        self._publish(EV_NODE_FAILURE, self.now, node_id=node_id,
                      n_victims=len(victims))
        # a dead prefiller's queued jobs never ran: re-place each on a
        # healthy prefill-capable node (mid-flight jobs re-place from their
        # completion callback, which observes the death)
        if node.prefill_q:
            jobs, node.prefill_q = list(node.prefill_q), []
            for job in jobs:
                node.state.queued_prefill_tokens -= job.n_tokens
                self._replace_prefill_job(node_id, job)
        # work parked in the dead node's admission queue will never be
        # pumped — re-place each through the SAME scheduler decision point
        # that placed it originally (shared Runtime mechanism; raises loudly
        # when the target is dead too, or no healthy candidate exists)
        self._drain_dead_node(node_id, self.now)
        for cid in victims:
            conv = self._convs[cid]
            done_turns = len(self._turn_recs[cid])
            self._recover(conv, min(done_turns, conv.n_turns - 1))

    def revive_node(self, node_id: int, at_s: float):
        """Schedule a failed node's COLD rejoin at logical time `at_s` (same
        contract as EngineServer.recover_replica): resident counters are
        already zero from the failure and stay zero, pooled prefix rows stay
        invalidated, cumulative counters (busy_s, energy_j, bind_counts,
        replayed_prefill_tokens, pool hit/eviction totals) survive. The node
        re-enters `ClusterView.nodes()` and every admission queue is pumped.
        Reviving an alive node raises; fail -> revive -> fail cycles are
        legal (per-node incarnation generations keep stale completions from
        the previous life off the new one)."""
        self.at(at_s, lambda: self._revive(node_id))
        return self

    # engine-API parity, so benchmarks drive both backends uniformly
    recover_replica = revive_node

    def _revive(self, node_id: int):
        node = self.nodes[node_id]
        if node.alive:
            raise RuntimeError(
                f"node {node_id} is already alive; only a failed node can "
                f"rejoin")
        node.alive = True
        node.state.alive = True
        node.state.lifecycle = NODE_ACTIVE
        # the observed-TBT history belongs to the previous incarnation
        node.state.observed_tbt_ema_s = 0.0
        self._lifecycle_streaks.pop(node_id, None)
        node.gen += 1
        node.iterating = False
        node.last_energy_t = self.now  # the dead interval drew no power
        self._rejoin_node(node_id, self.now, reason="from_dead")

    def inject_slowdown(self, node_id: int, factor: float,
                        at_s: Optional[float] = None):
        """Stretch `node_id`'s measured iteration/prefill durations by
        `factor` (slow, not wrong: outputs stay byte-identical). The
        stretched durations feed `observed_tbt_ema_s`, which is exactly
        what the observed-straggler quarantine conditions on. `factor=1.0`
        ends the slowdown. Applies now, or at logical `at_s` if given."""
        def arm():
            self.nodes[node_id].slow_factor = float(factor)
        if at_s is None:
            arm()
        else:
            self.at(at_s, arm)
        return self

    def inject_transfer_faults(self, n: int = 1):
        """Make the next `n` KV-transfer binds fail once each (engine-API
        parity). Each faulted bind retries with bounded exponential backoff;
        `max_transfer_retries` consecutive faults on one conversation
        exhaust the budget and raise loudly."""
        self._transfer_fault_budget += int(n)
        return self

    def _node_has_inflight(self, node_id: int) -> bool:
        node = self.nodes[node_id]
        if node.decode_jobs or node.prefill_q or node.iterating:
            return True
        # TOOL_WAIT sessions still bound here hold slots (resident tails)
        return any(bnid == node_id and not self.records[cid].done
                   and cid not in self._evicted
                   for cid, bnid in self._bound.items())

    def check_accounting(self) -> None:
        """Structural occupancy invariants, checked after every conversation
        completes when `strict_accounting=True` (engine-API parity). Every
        quantity here is a counter the simulator already maintains."""
        for nid, node in self.nodes.items():
            st = node.state
            q = len(self._admission[nid])
            if st.queued_conversations != q:
                raise AssertionError(
                    f"node {nid}: queued_conversations={st.queued_conversations}"
                    f" but admission queue holds {q}")
            for name in ("active_kv_tokens", "active_conversations",
                         "used_slots", "reserved_kv_tokens"):
                v = getattr(st, name)
                if v < 0:
                    raise AssertionError(f"node {nid}: {name}={v} < 0")
            if not node.alive:
                if q or st.active_kv_tokens or st.active_conversations \
                        or st.used_slots or st.reserved_kv_tokens:
                    raise AssertionError(
                        f"dead node {nid} holds resident state: "
                        f"queue={q} kv={st.active_kv_tokens} "
                        f"convs={st.active_conversations} "
                        f"slots={st.used_slots} "
                        f"reserved={st.reserved_kv_tokens}")
            elif st.lifecycle != NODE_ACTIVE and q:
                raise AssertionError(
                    f"{st.lifecycle} node {nid} holds {q} parked "
                    f"admissions; quarantine must drain them to peers")

    def _replace_admission(self, adm: Admission, now: float) -> Optional[int]:
        """Re-place one admission drained off a dead node through the same
        decision point that placed it (Runtime._drain_dead_node guards the
        returned target)."""
        cv = view_of(self._convs[adm.cid])
        if adm.kind == "arrival":
            return self.sched.place_first_prefill(cv, self.view).node_id
        return self.sched.bind_decoder(cv, self.view).node_id

    def _replace_prefill_job(self, dead_node_id: int, job: PrefillJob):
        """Re-enqueue a dead prefiller's job on a healthy prefill-capable
        node. The job's completion callback carries its continuation, so
        the downstream bind/turn plumbing is untouched."""
        pl = self.sched.place_first_prefill(view_of(self._convs[job.cid]),
                                            self.view)
        target = self.nodes[pl.node_id]
        if not target.alive:
            raise RuntimeError(
                f"re-placement of prefill job for conversation {job.cid} "
                f"off dead node {dead_node_id} chose node {pl.node_id}, "
                f"which is also dead; schedulers must place on live nodes "
                f"only")
        self.log.append(f"t={self.now:.1f} re-placed prefill job "
                        f"(cid {job.cid}) from dead node {dead_node_id} "
                        f"onto node {pl.node_id}")
        self._enqueue_prefill(target, job)

    def _tool_watchdog(self, conv: Conversation, next_idx: int,
                       deadline_t: float):
        """TOOL_WAIT deadline (same contract as EngineServer._tool_watchdog):
        fires `tool_deadline_s` after the session entered TOOL_WAIT before
        turn `next_idx`. No-op when the tool already returned (or the
        binding died/was evicted in the meantime); otherwise evicts the
        conversation's KV for waiting work, or fails loudly."""
        cid = conv.cid
        sess = self.sessions[cid]
        if (sess.state != TOOL_WAIT or sess.turn_idx != next_idx
                or cid in self._evicted):
            return
        bound = self._bound.get(cid)
        if bound is None or not self.nodes[bound].alive:
            return  # binding already dead; the tool return replays anyway
        if self.tool_timeout_action == "fail":
            raise RuntimeError(
                f"conversation {cid} exceeded the tool deadline: turn "
                f"{next_idx} still TOOL_WAIT at t={deadline_t:.3f} "
                f"(tool_deadline_s={self.tool_deadline_s}); "
                f"tool_timeout_action='fail'")
        node = self.nodes[bound]
        ctx = sum(t.append_tokens + t.output_tokens
                  for t in conv.turns[:next_idx])
        node.state.active_kv_tokens -= ctx
        node.state.active_conversations -= 1
        node.state.used_slots = max(0, node.state.used_slots - 1)
        self._evicted.add(cid)
        self.records[cid].n_tool_evictions += 1
        self.n_tool_evictions += 1
        self.log.append(
            f"t={deadline_t:.3f} tool deadline: evicted cid {cid} from "
            f"node {bound} (turn {next_idx} still waiting); KV freed for "
            f"parked work, tool return re-admits by replay")
        self._pump(bound, self.now)
        self._maybe_finish_draining(bound, self.now)

    def _recover(self, conv: Conversation, turn_idx: int):
        """Deterministic replay: re-prefill the journaled context on the
        prefiller, rebind to a healthy decoder (exactly ConServe's one-shot
        mechanism), then resume the interrupted/pending turn. Replay tokens
        are charged to the prefiller's `replayed_prefill_tokens`, and the
        trigger->resume latency to the record's `recovery_latency_s`."""
        self.records[conv.cid].recovered = True
        t0 = self.now
        # the interrupted turn never emitted (the sim publishes at turn
        # completion only), but subscribers tracking in-flight state still
        # observe the rewind from the owned transition point
        self._publish(EV_RECOVERY, self.now, cid=conv.cid, turn_idx=turn_idx)
        self.sessions[conv.cid].transition(PREFILLING, self.now, force=True)
        ctx = sum(t.append_tokens + t.output_tokens
                  for t in conv.turns[:turn_idx]) \
            + conv.turns[turn_idx].append_tokens
        pl = self.sched.place_first_prefill(view_of(conv), self.view)
        pf = self.nodes[pl.node_id]
        pf.state.replayed_prefill_tokens += ctx

        def redo(t, conv=conv, turn_idx=turn_idx, ctx=ctx):
            pl2 = self.sched.bind_decoder(view_of(conv), self.view)
            dec2 = self.nodes[pl2.node_id]
            self._bound[conv.cid] = pl2.node_id
            self.sessions[conv.cid].node_id = pl2.node_id
            self.bind_counts[pl2.node_id] = \
                self.bind_counts.get(pl2.node_id, 0) + 1
            dec2.state.active_kv_tokens += ctx
            dec2.state.active_conversations += 1
            dec2.state.used_slots += 1
            delay = self._transfer(ctx, dec2) if pl2.kv_transfer else 0.0
            self.at(t + delay,
                    lambda g=dec2.gen: self._resume_turn(
                        conv, turn_idx, pl2.node_id, t0, gen=g))

        job = PrefillJob(cid=conv.cid, turn_idx=turn_idx, n_tokens=ctx,
                         context_tokens=ctx, enqueued_s=self.now,
                         on_done=redo)
        self._enqueue_prefill(pf, job)

    def _resume_turn(self, conv: Conversation, turn_idx: int, node_id: int,
                     recover_t0: Optional[float] = None,
                     gen: Optional[int] = None):
        node = self.nodes[node_id]
        if not node.alive or (gen is not None and node.gen != gen):
            # the recovery target itself died before the resume landed:
            # recover again toward whatever is still healthy (the first
            # attempt's latency stays open — only successful resumes close)
            self._recover(conv, turn_idx)
            return
        turn = conv.turns[turn_idx]
        if recover_t0 is not None:
            self.records[conv.cid].recovery_latency_s.append(
                self.now - recover_t0)
        self.sessions[conv.cid].transition(DECODING, self.now, force=True)
        dj = DecodeJob(cid=conv.cid, turn_idx=turn_idx, remaining_prefill=0,
                       remaining_decode=turn.output_tokens,
                       context_tokens=sum(
                           t.append_tokens + t.output_tokens
                           for t in conv.turns[:turn_idx]) + turn.append_tokens,
                       turn_arrival_s=self.now)
        node.decode_jobs[(conv.cid << 8) + turn_idx] = dj
        self._kick_iteration(node)

    def add_decoder(self, cost: NodeCostModel,
                    n_slots: Optional[int] = None) -> int:
        nid = max(self.nodes) + 1
        node = SimNode(node_id=nid, role="decode", cost=cost,
                       n_slots=n_slots, last_energy_t=self.now)
        cap = cost.kv_capacity_tokens()
        node.state = NodeState(node_id=nid, role="decode",
                               kv_capacity_tokens=cap,
                               slot_capacity=n_slots or UNBOUNDED_SLOTS)
        self.nodes[nid] = node
        self.view._nodes[nid] = node.state
        self._admission[nid] = AdmissionQueue(nid)
        self.log.append(f"t={self.now:.1f} scaled out: decoder {nid}")
        return nid

    # ----- results ----------------------------------------------------------------
    def total_energy_j(self) -> float:
        return sum(n.energy_j for n in self.nodes.values())

    def results(self) -> List[ConversationRecord]:
        return [r for r in self.records.values() if r.done]
