"""Percentile arithmetic, frozen: a copy of `p95` and `gmean` of
`repro_torch.core.metrics` (numpy's linear-interpolation percentile), and
the conversation-level quantities the end-to-end metrics take from the
served records (TTFET, each turn's TTFT, the final turn's time between
tokens), computed here from plain timestamps."""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(xs, q)) if len(xs) else float("nan")


def p95(xs: Sequence[float]) -> float:
    return percentile(xs, 95)


def gmean(xs: Sequence[float]) -> float:
    xs = [max(x, 1e-9) for x in xs]
    if not xs:
        return float("nan")
    return float(math.exp(sum(math.log(x) for x in xs) / len(xs)))


def turn_tbt_s(turn: Dict) -> float:
    """Mean time between tokens of one turn: (last - first) / (n - 1), 0
    for a turn of one token (as `TurnRecord.tbt_s`)."""
    n = turn["n_output_tokens"]
    if n <= 1:
        return 0.0
    return (turn["last_token_s"] - turn["first_token_s"]) / (n - 1)


def conversation_metrics(convs: Sequence[Dict]) -> Dict[str, float]:
    """The latency metrics over finished conversations, each
    {"arrival_s", "turns": [{"arrival_s", "first_token_s", "last_token_s",
    "n_output_tokens"}]} on the server's logical clock: TTFET (arrival ->
    first token of the final turn), every turn's TTFT (runnable -> first
    token) and the final turn's time between tokens (turns of one token
    left out, as `summarize` leaves them out)."""
    ttfet = [c["turns"][-1]["first_token_s"] - c["arrival_s"] for c in convs]
    ttft = [t["first_token_s"] - t["arrival_s"]
            for c in convs for t in c["turns"]]
    tbt = [turn_tbt_s(c["turns"][-1]) for c in convs]
    tbt = [x for x in tbt if x > 0]
    return {"ttfet_p95_s": p95(ttfet), "turn_ttft_p95_s": p95(ttft),
            "last_tbt_p95_ms": 1e3 * p95(tbt),
            "n_ttfet": len(ttfet), "n_ttft": len(ttft), "n_tbt": len(tbt),
            "ttfet_median_s": percentile(ttfet, 50),
            "turn_ttft_median_s": percentile(ttft, 50),
            "last_tbt_median_ms": 1e3 * percentile(tbt, 50)}
