"""The traffic generator, frozen: a copy of the agentic trace generator
(`TraceConfig`, `generate_conversation` and the Poisson arrivals of
`generate_trace` in `repro_torch.traces.agentic`), drawing the same numbers
from the same seed, plus what a cell needs around it:

* the shapes (turn counts, lengths, tool times) and the arrival times are
  drawn from the mix's own `shape_seed`, so every run serves the same
  work in the same order; the run seed makes the token content and the
  weights. (A seed that reordered the shapes changed the work: the window's
  logical span, and so which conversations it admits, moved with the
  order, and one heavy-tailed conversation more or less moved the p95.)
* a conversation whose context would pass `max_ctx` ends at its last turn
  that fits (`cut_to_ctx`), and the cut is counted.

A conversation here is plain data (`Shape`); `system.to_program` turns it
into the program's own type.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# the generator's parameters, with `TraceConfig`'s defaults
GENERATOR_DEFAULTS = dict(
    first_input_median=14_000.0, first_input_sigma=0.35,
    first_input_max=32_000, append_median=220.0, append_sigma=0.8,
    append_max=4_000, output_median=60.0, output_sigma=1.1, output_max=2_000,
    mean_turns=9.0, max_turns=40, tool_mean_s=1.5, preamble_tokens=0,
    n_preambles=1, preamble_share=1.0)


@dataclasses.dataclass
class Shape:
    """One conversation: its arrival (logical seconds) and its turns as
    (append_tokens, output_tokens, tool_time_s)."""
    cid: int
    arrival_s: float
    turns: List[Tuple[int, int, float]]
    preamble_id: Optional[int] = None
    preamble_tokens: int = 0

    @property
    def output_tokens(self) -> int:
        return sum(t[1] for t in self.turns)

    def context_after(self, i: int) -> int:
        """KV rows after turn i: every append and every output so far."""
        return sum(a + o for a, o, _ in self.turns[:i + 1])


def _lognormal(rng, median, sigma, cap) -> int:
    v = rng.lognormal(np.log(median), sigma)
    return int(np.clip(v, 1, cap))


def draw_conversation(p: Dict, rng: np.random.RandomState, cid: int,
                      arrival_s: float) -> Shape:
    """`generate_conversation`, draw for draw."""
    n_turns = int(np.clip(rng.geometric(1.0 / p["mean_turns"]), 1,
                          p["max_turns"]))
    turns = []
    for i in range(n_turns):
        append = (_lognormal(rng, p["first_input_median"],
                             p["first_input_sigma"], p["first_input_max"])
                  if i == 0 else
                  _lognormal(rng, p["append_median"], p["append_sigma"],
                             p["append_max"]))
        out = _lognormal(rng, p["output_median"], p["output_sigma"],
                         p["output_max"])
        tool = (float(rng.exponential(p["tool_mean_s"]))
                if i < n_turns - 1 else 0.0)
        turns.append((append, out, tool))
    pid, ptok = None, 0
    if p["preamble_tokens"] > 0 and rng.uniform() < p["preamble_share"]:
        pid = int(rng.randint(p["n_preambles"]))
        ptok = int(p["preamble_tokens"])
        a, o, t = turns[0]
        turns[0] = (a + ptok, o, t)
    return Shape(cid, arrival_s, turns, pid, ptok)


def draw_trace(n: int, rate_conv_per_s: float, params: Dict,
               seed: int) -> List[Shape]:
    """`generate_trace(n, rate, TraceConfig(seed=seed, **params))` with
    Poisson arrivals: the shape, then the gap to the next arrival, from one
    generator."""
    p = {**GENERATOR_DEFAULTS, **params}
    rng = np.random.RandomState(seed)
    t, out = 0.0, []
    for cid in range(n):
        out.append(draw_conversation(p, rng, cid, t))
        t += float(rng.exponential(1.0 / rate_conv_per_s))
    return out


def cut_to_ctx(shape: Shape, max_ctx: int) -> Tuple[Shape, bool]:
    """End the conversation at its last turn whose context fits max_ctx
    (the first turn always stays: the mix's cap keeps it inside). The kept
    final turn has no tool call after it. Returns (shape, was it cut)."""
    keep = 1
    while (keep < len(shape.turns)
           and shape.context_after(keep) <= max_ctx):
        keep += 1
    if shape.context_after(0) > max_ctx:
        raise ValueError(f"conversation {shape.cid}: its first turn "
                         f"({shape.context_after(0)} tokens) cannot fit "
                         f"max_ctx {max_ctx}; lower the mix's caps")
    if keep == len(shape.turns):
        return shape, False
    turns = list(shape.turns[:keep])
    a, o, _ = turns[-1]
    turns[-1] = (a, o, 0.0)
    return dataclasses.replace(shape, turns=turns), True


def build(mix: Dict, max_ctx: int) -> Tuple[List[Shape], int]:
    """The cell's conversations: the mix's shapes and arrivals, cut to
    max_ctx. Returns (shapes, number cut)."""
    if mix["arrival"] != "poisson":
        raise ValueError(f"arrival process {mix['arrival']!r} is not "
                         f"generated (poisson)")
    shapes = draw_trace(mix["n_conversations"], mix["rate_conv_per_s"],
                        mix.get("generator", {}), mix["shape_seed"])
    out, n_cut = [], 0
    for s in shapes:
        s, cut = cut_to_ctx(s, max_ctx)
        out.append(s)
        n_cut += cut
    return out, n_cut
