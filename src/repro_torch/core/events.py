"""Event bus for the serving runtimes: subscriber hooks fired from the
runtime's OWN transition points.

The paper's observability stance extends to streaming: everything a live
front end can report is a read of state the runtime already owns — the
session state machine's transitions, the decode rotation's per-(cid, turn)
token streams (`_TurnTask.stream` on the engine; turn-granularity counts on
the simulator), admission parks/admits, node failures and recovery rewinds.
The bus therefore carries REFERENCES to those moments, never a second
bookkeeping path: no counter lives here, and a runtime with zero
subscribers pays one dict lookup per potential publish
(`Runtime._publish` checks `EventBus.wants` before building the event).

Event kinds (the `data` payload names state owned elsewhere):

* ``session``      — a `ServeSession.transition` fired:
                     ``{"state", "prev"}`` (+ cid / turn_idx / node_id).
* ``tokens``       — decode emission. Engine: ``{"tokens": [ids...],
                     "per_token_s"}`` per chunk share, with the turn's
                     opening prefill-argmax token published at stage time —
                     concatenated per (cid, turn) the payloads reproduce
                     `_TurnTask.stream` byte-for-byte. Simulator:
                     ``{"n_tokens": N}`` once per completed turn (the sim
                     emits at turn granularity; it has no token bytes).
* ``turn_finish``  — a turn completed and was recorded
                     (``{"n_output_tokens"}``).
* ``admission_park``  — work parked in a node's admission queue
                     (``{"kind", "need_tokens"}``).
* ``admission_admit`` — a previously parked admission ran
                     (``{"kind", "need_tokens"}``).
* ``node_failure`` — a node died (``{"n_victims"}``).
* ``node_join``    — a node (re)entered ACTIVE service: revival of a dead
                     replica or an observed-EMA recovery out of quarantine
                     (``{"reason": "from_dead" | "from_quarantine"}``).
* ``node_quarantine`` — a node's observed_tbt_ema_s exceeded k× the fleet
                     median over the configured window and it left the
                     schedulable set (``{"observed_tbt_ema_s",
                     "fleet_median_tbt_s", "k"}``).
* ``recovery``     — a conversation REWOUND for deterministic replay: every
                     token already published for the named in-flight turn is
                     stale and will re-stream byte-identically. Subscribers
                     holding per-(cid, turn) accumulations must reset that
                     key (the gateway does); completed turns never rewind.
* ``span``         — an interval the engine measured (`repro_torch.engine
                     .trace`): ``{"name", "span_id", "parent", "host_t0_ns",
                     "host_t1_ns"}`` plus ``"t0"`` (the logical start, for
                     spans on the server's logical clock) and the span's own
                     attributes; `t` is the logical end (for a host-clock
                     span, the logical instant it was published at), and
                     cid / turn_idx / node_id name the conversation, turn and
                     replica it belongs to. ``parent`` is the id of the span
                     whose work caused it (None at the top).

Spans are OPT-IN BY NAME: only a subscriber that names ``span`` in its
`kinds` receives them; a wildcard subscriber (``kinds=None``, as the live
gateway's) does not, so subscribing to everything never switches tracing
on. With no ``span`` subscriber every span site makes one `wants` lookup
and builds nothing else.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# ----- event kinds -----------------------------------------------------------
EV_SESSION = "session"
EV_TOKENS = "tokens"
EV_TURN_FINISH = "turn_finish"
EV_ADMISSION_PARK = "admission_park"
EV_ADMISSION_ADMIT = "admission_admit"
EV_NODE_FAILURE = "node_failure"
EV_NODE_JOIN = "node_join"
EV_NODE_QUARANTINE = "node_quarantine"
EV_RECOVERY = "recovery"
EV_SPAN = "span"

EVENT_KINDS = (EV_SESSION, EV_TOKENS, EV_TURN_FINISH, EV_ADMISSION_PARK,
               EV_ADMISSION_ADMIT, EV_NODE_FAILURE, EV_NODE_JOIN,
               EV_NODE_QUARANTINE, EV_RECOVERY, EV_SPAN)
# kinds a wildcard subscriber does not receive: only a subscriber that names
# them does (see the module docstring)
OPT_IN_KINDS = (EV_SPAN,)


@dataclasses.dataclass(frozen=True)
class ServeEvent:
    """One observed runtime moment. `t` is the runtime's LOGICAL clock at the
    transition point (both backends run logical time); `data` carries the
    kind-specific payload documented in the module docstring."""
    kind: str
    t: float
    cid: Optional[int] = None
    turn_idx: Optional[int] = None
    node_id: Optional[int] = None
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)


class EventBus:
    """Synchronous fan-out of `ServeEvent`s to subscribers.

    Subscribers are plain callables invoked inline at the transition point,
    so a subscriber observes state exactly as it was at the moment the
    runtime owned it (no queueing, no reordering). A subscriber must not
    mutate runtime state — the bus is a read path.

    `wants(kind)` is the zero-cost guard runtimes check before building an
    event: with no subscriber for `kind` (and, for a kind that is not
    opt-in, no wildcard subscriber) the hot paths skip payload construction
    entirely.
    """

    def __init__(self):
        # kind -> subscriber list; the None key holds wildcard subscribers
        self._subs: Dict[Optional[str], List[Callable[[ServeEvent], None]]] = {}

    def subscribe(self, fn: Callable[[ServeEvent], None],
                  kinds: Optional[Sequence[str]] = None
                  ) -> Callable[[], None]:
        """Register `fn` for the given `kinds` (None = every kind). Returns
        an unsubscribe callable. Unknown kind names are rejected loudly —
        a typo'd kind would otherwise subscribe to silence forever."""
        keys: Tuple[Optional[str], ...]
        if kinds is None:
            keys = (None,)
        else:
            for k in kinds:
                if k not in EVENT_KINDS:
                    raise ValueError(
                        f"unknown event kind {k!r}; valid kinds: "
                        f"{', '.join(EVENT_KINDS)}")
            keys = tuple(kinds)
        for k in keys:
            self._subs.setdefault(k, []).append(fn)

        def unsubscribe():
            for k in keys:
                subs = self._subs.get(k)
                if subs and fn in subs:
                    subs.remove(fn)

        return unsubscribe

    def wants(self, kind: str) -> bool:
        if kind in OPT_IN_KINDS:
            return bool(self._subs.get(kind))
        return bool(self._subs.get(None) or self._subs.get(kind))

    def publish(self, ev: ServeEvent):
        for fn in self._subs.get(ev.kind, ()):
            fn(ev)
        if ev.kind not in OPT_IN_KINDS:
            for fn in self._subs.get(None, ()):
                fn(ev)
