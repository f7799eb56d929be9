"""Condition-triggered replica kills and a fixed-cost logical clock for the
serving engine, as mixins over an `EngineServer` (the port's, or any
server with the same hooks: `_begin_decode`, `_finish_turn`,
`_rejoin_node`, `_stretched`).

`FailWhen` kills the replica that hosts a conversation the moment that
conversation enters a chosen stage of a turn: a structural trigger that
does not depend on measured event times, so a replay must re-prefill
exactly the turns completed before it. `FixedStepClock` charges every
measured step (prefill, append-prefill, decode chunk, replay prefill) a
fixed cost instead of its measured time: two engines, or one engine on two
devices, then place, kill and recover at the same logical moments, and
their bookkeeping can be compared exactly.

    class Killed(FailWhen, EngineServer): pass
    srv = Killed(sched, replicas, victim_cid=1, min_turn=1)
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.runtime import DECODING, TOOL_WAIT


class FailWhen:
    """Kill the replica hosting a conversation the first time that
    conversation enters `stage` (DECODING or TOOL_WAIT) of a turn with
    index >= `min_turn`, 1 ns after it enters: before any completion of
    the in-flight work, which lands at measured offsets. `victim_cid` and
    `victim_node` narrow the trigger to one conversation or one replica
    (None: any). With `rejoin_after_s` the killed replica is recovered that
    many logical seconds after the kill.

    `killed` holds (cid, turn, node, t) of the kill (None until it fires)
    and `at_rejoin` the rejoining node's state at the moment it rejoins."""

    def __init__(self, *a, victim_cid: Optional[int] = None,
                 victim_node: Optional[int] = None, min_turn: int = 0,
                 stage: str = DECODING,
                 rejoin_after_s: Optional[float] = None, **kw):
        if stage not in (DECODING, TOOL_WAIT):
            raise ValueError(f"stage must be {DECODING} or {TOOL_WAIT}, "
                             f"not {stage!r}")
        super().__init__(*a, **kw)
        self._victim_cid = victim_cid
        self._victim_node = victim_node
        self._min_turn = min_turn
        self._stage = stage
        self._rejoin_after_s = rejoin_after_s
        self.killed = None
        self.at_rejoin = {}

    def _maybe_fail(self, cid: int, turn_idx: int):
        if self.killed is not None or turn_idx < self._min_turn:
            return
        if self._victim_cid is not None and cid != self._victim_cid:
            return
        bound = self._slots.get(cid)
        if bound is None or self.sessions[cid].state != self._stage:
            return
        node = bound[0]
        if self._victim_node is not None and node != self._victim_node:
            return
        t = self._now + 1e-9
        self.killed = (cid, turn_idx, node, t)
        self.fail_replica(node, t)
        if self._rejoin_after_s is not None:
            self.recover_replica(node, t + self._rejoin_after_s)

    def _begin_decode(self, conv, turn_idx, next_tok, ready_t,
                      arrival_t=None):
        super()._begin_decode(conv, turn_idx, next_tok, ready_t,
                              arrival_t=arrival_t)
        if self._stage == DECODING:
            self._maybe_fail(conv.cid, turn_idx)

    def _finish_turn(self, task, t):
        super()._finish_turn(task, t)
        if self._stage == TOOL_WAIT:
            self._maybe_fail(task.conv.cid, task.turn_idx + 1)

    def _rejoin_node(self, node_id, now, *, reason):
        st = self.states[node_id]
        self.at_rejoin = dict(
            node_id=node_id, reason=reason, alive=st.alive,
            lifecycle=st.lifecycle, kv=st.active_kv_tokens,
            slots=st.used_slots, convs=st.active_conversations,
            ema=st.observed_tbt_ema_s)
        return super()._rejoin_node(node_id, now, reason=reason)


class FixedStepClock:
    """Every measured step advances its node's logical clock by `step_s`
    (times any injected slowdown) instead of its measured time. Transfers
    keep their bytes-over-link cost, which does not depend on timing."""

    step_s = 0.01

    def _stretched(self, node_id: int, dt: float) -> float:
        return super()._stretched(node_id, self.step_s)
