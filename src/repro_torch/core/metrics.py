"""Conversation-level metrics (§1, §5.1).

* TTFET — time-to-first-effective-token: arrival -> first token of the
  conversation's FINAL, user-visible reply turn. Intermediate turns emit
  tool calls the user never reads; TTFET is a property of the conversation.
* Last-turn TBT — mean time-between-tokens within the final turn.
* E2E — arrival -> last token of the final turn.
Conventional per-turn TTFT / TBT distributions are also recorded for
comparison with prior work (they conflate tool-call turns with the reply).
SLO threshold: 5× the interference-free single-request baseline per metric
(standard practice; §5.3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class TurnRecord:
    turn_idx: int
    arrival_s: float = 0.0      # turn became runnable (tool returned)
    first_token_s: float = 0.0  # TTFT reference point
    last_token_s: float = 0.0
    n_output_tokens: int = 0
    token_times: Optional[List[float]] = None  # optional full trace

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def tbt_s(self) -> float:
        if self.n_output_tokens <= 1:
            return 0.0
        return (self.last_token_s - self.first_token_s) / (self.n_output_tokens - 1)


@dataclasses.dataclass
class ConversationRecord:
    cid: int
    arrival_s: float
    turns: List[TurnRecord] = dataclasses.field(default_factory=list)
    n_kv_transfers: int = 0
    n_remote_turns: int = 0
    recovered: bool = False  # re-prefilled after a decoder failure
    # one entry per recovery: trigger (replica death / tool return to a dead
    # or evicted binding) -> decode of the interrupted turn resumed
    recovery_latency_s: List[float] = dataclasses.field(default_factory=list)
    n_tool_evictions: int = 0  # tool-deadline watchdog freed this slot

    @property
    def done(self) -> bool:
        return bool(self.turns)

    @property
    def ttfet_s(self) -> float:
        """First token of the final (user-visible) turn, from arrival."""
        return self.turns[-1].first_token_s - self.arrival_s

    @property
    def last_turn_tbt_s(self) -> float:
        return self.turns[-1].tbt_s

    @property
    def e2e_s(self) -> float:
        return self.turns[-1].last_token_s - self.arrival_s


def gmean(xs: Sequence[float]) -> float:
    xs = [max(x, 1e-9) for x in xs]
    if not xs:
        return float("nan")
    return float(math.exp(sum(math.log(x) for x in xs) / len(xs)))


def p95(xs: Sequence[float]) -> float:
    return float(np.percentile(xs, 95)) if len(xs) else float("nan")


@dataclasses.dataclass
class SLOThresholds:
    """5× the single-request, interference-free baseline per metric."""
    ttfet_s: float
    last_tbt_s: float
    e2e_s: float
    multiplier: float = 5.0

    def violations(self, recs: Sequence[ConversationRecord]) -> Dict[str, float]:
        n = max(len(recs), 1)
        v_ttfet = sum(r.ttfet_s > self.multiplier * self.ttfet_s for r in recs)
        v_tbt = sum(r.last_turn_tbt_s > self.multiplier * self.last_tbt_s
                    for r in recs)
        v_e2e = sum(r.e2e_s > self.multiplier * self.e2e_s for r in recs)
        return {"ttfet": v_ttfet / n, "last_tbt": v_tbt / n, "e2e": v_e2e / n}


def summarize(recs: Sequence[ConversationRecord],
              slo: Optional[SLOThresholds] = None,
              energy_joules: Optional[float] = None,
              total_tokens: Optional[int] = None) -> Dict[str, float]:
    """total_tokens: tokens processed (input+output) for tokens/joule; falls
    back to generated output tokens when not provided."""
    recs = [r for r in recs if r.done]
    ttfet = [r.ttfet_s for r in recs]
    tbt = [r.last_turn_tbt_s for r in recs if r.last_turn_tbt_s > 0]
    e2e = [r.e2e_s for r in recs]
    out = {
        "n_conversations": len(recs),
        "ttfet_gmean": gmean(ttfet), "ttfet_p95": p95(ttfet),
        "last_tbt_gmean": gmean(tbt), "last_tbt_p95": p95(tbt),
        "e2e_gmean": gmean(e2e), "e2e_p95": p95(e2e),
        "kv_transfers_per_conv": float(np.mean(
            [r.n_kv_transfers for r in recs])) if recs else 0.0,
        "remote_turns_per_conv": float(np.mean(
            [r.n_remote_turns for r in recs])) if recs else 0.0,
    }
    # failure-recovery view: how many conversations replayed, and how long
    # each recovery took (trigger -> interrupted turn's decode resumed).
    # Keys are always present (stable benchmark schemas); zeros when the
    # run was failure-free.
    rec_lat = [l for r in recs for l in r.recovery_latency_s]
    out.update({
        "n_recovered": int(sum(r.recovered for r in recs)),
        "n_tool_evictions": int(sum(r.n_tool_evictions for r in recs)),
        "recovery_latency_mean_s": float(np.mean(rec_lat)) if rec_lat else 0.0,
        "recovery_latency_p95_s": p95(rec_lat) if rec_lat else 0.0,
    })
    if slo is not None:
        out.update({f"slo_viol_{k}": v
                    for k, v in slo.violations(recs).items()})
    if energy_joules is not None and energy_joules > 0:
        if total_tokens is None:
            total_tokens = sum(t.n_output_tokens for r in recs for t in r.turns)
        out["tokens_per_joule"] = total_tokens / energy_joules
        out["energy_joules"] = energy_joules
    return out


def per_conversation_slo_violations(
        loaded: Sequence[ConversationRecord],
        baseline: Dict[int, ConversationRecord],
        multiplier: float = 5.0) -> Dict[str, float]:
    """SLO per §5.3 at conversation granularity: each conversation is judged
    against 5× ITS OWN interference-free execution (same turns, no batching
    or queueing) — the conversation-level analogue of the per-request
    baseline."""
    n = max(len(loaded), 1)
    v = {"ttfet": 0, "last_tbt": 0, "e2e": 0}
    for r in loaded:
        b = baseline[r.cid]
        v["ttfet"] += r.ttfet_s > multiplier * max(b.ttfet_s, 1e-6)
        v["last_tbt"] += r.last_turn_tbt_s > multiplier * max(
            b.last_turn_tbt_s, 1e-4)
        v["e2e"] += r.e2e_s > multiplier * max(b.e2e_s, 1e-6)
    return {k: c / n for k, c in v.items()}


def per_turn_distributions(recs: Sequence[ConversationRecord]
                           ) -> Dict[str, np.ndarray]:
    """Conventional per-turn TTFT/TBT pools across all turns (Fig. 11)."""
    ttft = np.array([t.ttft_s for r in recs for t in r.turns])
    tbt = np.array([t.tbt_s for r in recs for t in r.turns
                    if t.n_output_tokens > 1])
    return {"ttft": np.sort(ttft), "tbt": np.sort(tbt)}
