"""Synthetic agentic traces matching the paper's workload characterization
(§3, Fig. 1 — SWE-bench_bm25_13K replayed through swe-agent):

  * turn-1 input: tens of thousands of tokens (task + repository context),
    concentrated around the 13k retrieval budget;
  * turn-2+ appends: task-relevant tool output only, O(10^2) tokens;
  * outputs: high-variance, heavy-tailed (unpredictable at scheduling time);
  * turn counts: geometric-ish with a long tail;
  * tool latencies between turns (the conversation leaves compute but its KV
    stays pinned).

Calibrated so mean first input ≈ 15k and mean per-conversation decoder
volume ≈ 1k tokens, reproducing §5.1's provisioning sanity check.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.core.conversation import Conversation, Turn
from repro_torch.core.provisioning import WorkloadStats


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    seed: int = 0
    # turn-1 prompt: lognormal centered near the 13k retrieval budget
    # (median 14k, sigma .35 -> mean ≈ 15k = §5.1's L_in, so the prefiller
    # saturation rate R* = 25k/15k ≈ 1.67 conv/s matches the paper's axis)
    first_input_median: float = 14_000.0
    first_input_sigma: float = 0.35
    first_input_max: int = 32_000
    # turn 2+ appends: hundreds of tokens
    append_median: float = 220.0
    append_sigma: float = 0.8
    append_max: int = 4_000
    # outputs: heavy-tailed, unpredictable
    output_median: float = 60.0
    output_sigma: float = 1.1
    output_max: int = 2_000
    # turns per conversation
    mean_turns: float = 9.0
    max_turns: int = 40
    # tool latency between turns
    tool_mean_s: float = 1.5
    # Shared preamble (agentic fleets launch many conversations from the
    # same system-prompt / tool-schema prefix). preamble_tokens > 0 gives a
    # `preamble_share` fraction of conversations a shared prefix of that
    # length inside turn 1, drawn uniformly from `n_preambles` distinct
    # identities. The preamble EXTENDS turn 1 (sampled task prompt stays
    # intact) so the non-preamble token distribution is unchanged.
    preamble_tokens: int = 0
    n_preambles: int = 1
    preamble_share: float = 1.0


def _lognormal(rng, median, sigma, cap) -> int:
    v = rng.lognormal(np.log(median), sigma)
    return int(np.clip(v, 1, cap))


def generate_conversation(cfg: TraceConfig, rng: np.random.RandomState,
                          cid: int, arrival_s: float) -> Conversation:
    n_turns = int(np.clip(rng.geometric(1.0 / cfg.mean_turns), 1,
                          cfg.max_turns))
    turns: List[Turn] = []
    for i in range(n_turns):
        append = (_lognormal(rng, cfg.first_input_median,
                             cfg.first_input_sigma, cfg.first_input_max)
                  if i == 0 else
                  _lognormal(rng, cfg.append_median, cfg.append_sigma,
                             cfg.append_max))
        out = _lognormal(rng, cfg.output_median, cfg.output_sigma,
                         cfg.output_max)
        tool = float(rng.exponential(cfg.tool_mean_s)) if i < n_turns - 1 else 0.0
        turns.append(Turn(append_tokens=append, output_tokens=out,
                          tool_time_s=tool))
    pid: Optional[int] = None
    ptok = 0
    if cfg.preamble_tokens > 0 and rng.uniform() < cfg.preamble_share:
        pid = int(rng.randint(cfg.n_preambles))
        ptok = int(cfg.preamble_tokens)
        t0 = turns[0]
        turns[0] = Turn(append_tokens=t0.append_tokens + ptok,
                        output_tokens=t0.output_tokens,
                        tool_time_s=t0.tool_time_s)
    return Conversation(cid=cid, arrival_s=arrival_s, turns=turns,
                        preamble_id=pid, preamble_tokens=ptok)


def generate_trace(n_conversations: int, rate_conv_per_s: float,
                   cfg: Optional[TraceConfig] = None,
                   arrival_process: str = "poisson",
                   pace_tokens_per_s: float = 25_000.0) -> List[Conversation]:
    """arrival_process:
      'poisson'    — Poisson arrivals at rate_conv_per_s;
      'saturation' — deterministic 1/rate inter-arrivals;
      'paced'      — the paper's 1.634 conv/s synthesized pattern: each
        inter-arrival equals the previous conversation's turn-1 prefill
        service time (first_input / T_p), holding the prefiller EXACTLY at
        its saturation throughput without exceeding it (§5.1, §5.3)."""
    cfg = cfg or TraceConfig()
    rng = np.random.RandomState(cfg.seed)
    t = 0.0
    convs = []
    for cid in range(n_conversations):
        c = generate_conversation(cfg, rng, cid, t)
        convs.append(c)
        if arrival_process == "poisson":
            t += float(rng.exponential(1.0 / rate_conv_per_s))
        elif arrival_process == "paced":
            t += c.first_input_len / pace_tokens_per_s
        else:
            t += 1.0 / rate_conv_per_s
    return convs


# ----- named scenario library ------------------------------------------------
# Seeded generators for the agentic patterns the paper's serving claims are
# exercised against. Each returns a plain `Conversation` list (the runtimes'
# only input), fully determined by (name, n_conversations, seed, scale):
# the same call is byte-identical across processes, which is what lets the
# gateway's live-streamed output be compared against an offline replay.
#
# `scale` picks the token regime: "paper" = the §3 characterization above
# (13k-ish first inputs); "engine" = the reduced-model regime the real-JAX
# backend serves in tests/CI (peak context bounded under the replicas'
# max_ctx=1024).

_ENGINE_SCALE = dict(first_input_median=150.0, first_input_max=500,
                     append_median=24.0, append_max=64,
                     output_median=10.0, output_max=32,
                     mean_turns=3.0, max_turns=6, tool_mean_s=0.05)


def _scale_cfg(scale: str, seed: int, **overrides) -> TraceConfig:
    if scale not in ("paper", "engine"):
        raise ValueError(f"unknown scale {scale!r}; use 'paper' or 'engine'")
    base = dict(_ENGINE_SCALE) if scale == "engine" else {}
    base.update(overrides)
    return TraceConfig(seed=seed, **base)


def pareto_burst(n_conversations: int, seed: int = 0, scale: str = "paper",
                 alpha: float = 1.3,
                 mean_gap_s: Optional[float] = None) -> List[Conversation]:
    """Heavy-tailed arrivals: Pareto inter-arrival gaps (shape `alpha`,
    mean `mean_gap_s`) — long quiet stretches punctuated by bursts that
    pile conversations onto the admission queues, the regime where
    backpressure observables (not predictions) drive placement."""
    cfg = _scale_cfg(scale, seed)
    rng = np.random.RandomState(seed + 101)
    gap = mean_gap_s if mean_gap_s is not None else (
        0.2 if scale == "engine" else 0.6)
    t, convs = 0.0, []
    for cid in range(n_conversations):
        convs.append(generate_conversation(cfg, rng, cid, t))
        # Lomax sample has mean 1/(alpha-1); rescale to the target mean gap
        t += gap * (alpha - 1.0) * float(rng.pareto(alpha))
    return convs


def supervisor_worker_dag(n_conversations: int, seed: int = 0,
                          scale: str = "paper",
                          workers_per_supervisor: int = 3,
                          dispatch_latency_s: Optional[float] = None):
    """Supervisor→worker DAG: each supervisor conversation spawns child
    (worker) conversations whose arrivals GATE on a tool return of the
    parent — a child dispatched from turn g cannot arrive before the
    parent's cumulative tool time through turn g has elapsed (the
    generatively-known part of the gating; serving latency only pushes the
    real return later). Returns ``(convs, edges)`` where edges are
    ``(parent_cid, gate_turn_idx, child_cid)`` so tests can assert the
    invariant directly."""
    cfg = _scale_cfg(scale, seed)
    rng = np.random.RandomState(seed + 202)
    dispatch = dispatch_latency_s if dispatch_latency_s is not None else (
        0.01 if scale == "engine" else 0.25)
    sup_gap = 0.5 if scale == "engine" else 5.0
    convs: List[Conversation] = []
    edges = []
    cid, t = 0, 0.0
    while cid < n_conversations:
        sup = generate_conversation(cfg, rng, cid, t)
        convs.append(sup)
        sup_cid = cid
        cid += 1
        for j in range(min(workers_per_supervisor, n_conversations - cid)):
            gate = int(rng.randint(sup.n_turns))
            cum_tool = sum(tn.tool_time_s for tn in sup.turns[:gate + 1])
            child = generate_conversation(
                cfg, rng, cid, t + cum_tool + dispatch * (j + 1))
            convs.append(child)
            edges.append((sup_cid, gate, cid))
            cid += 1
        t += float(rng.exponential(sup_gap))
    return convs, edges


def supervisor_worker(n_conversations: int, seed: int = 0,
                      scale: str = "paper",
                      **kw) -> List[Conversation]:
    return supervisor_worker_dag(n_conversations, seed=seed, scale=scale,
                                 **kw)[0]


def hitl_longpark(n_conversations: int, seed: int = 0, scale: str = "paper",
                  park_share: float = 0.25,
                  park_s: Optional[float] = None) -> List[Conversation]:
    """Human-in-the-loop: a `park_share` fraction of conversations has one
    tool boundary stretched to a long wait (a person reviewing), so its KV
    sits pinned in TOOL_WAIT for orders of magnitude longer than a tool
    call — the pattern that makes conversation-level residency decisions
    matter."""
    cfg = _scale_cfg(scale, seed)
    rng = np.random.RandomState(seed + 303)
    park = park_s if park_s is not None else (
        1.0 if scale == "engine" else 120.0)
    gap = 0.3 if scale == "engine" else 1.0
    t, convs = 0.0, []
    for cid in range(n_conversations):
        c = generate_conversation(cfg, rng, cid, t)
        parked = rng.uniform() < park_share
        if parked and c.n_turns > 1:
            # pick a non-final turn; its tool call becomes the HITL wait
            i = int(rng.randint(c.n_turns - 1))
            c.turns[i] = Turn(append_tokens=c.turns[i].append_tokens,
                              output_tokens=c.turns[i].output_tokens,
                              tool_time_s=park * float(rng.uniform(0.5, 1.5)))
        convs.append(c)
        t += float(rng.exponential(gap))
    return convs


def shared_preamble_fleet(n_conversations: int, seed: int = 0,
                          scale: str = "paper", n_preambles: int = 3,
                          preamble_share: float = 0.8) -> List[Conversation]:
    """Agentic fleet launched from a handful of shared system-prompt /
    tool-schema preambles, arriving in tight bursts — the shape that
    exercises the prefix KV pool (turn-1 prefills past a pooled preamble
    compute only the delta)."""
    over = dict(preamble_tokens=2_000, n_preambles=n_preambles,
                preamble_share=preamble_share)
    if scale == "engine":
        # keep peak context under the test replicas' max_ctx=1024 even with
        # the preamble extending turn 1
        over.update(preamble_tokens=64, first_input_max=400)
    cfg = _scale_cfg(scale, seed, **over)
    rng = np.random.RandomState(seed + 404)
    burst, in_gap = 4, (0.002 if scale == "engine" else 0.01)
    gap = 0.5 if scale == "engine" else 4.0
    t, convs = 0.0, []
    for cid in range(n_conversations):
        if cid and cid % burst == 0:
            t += float(rng.exponential(gap))
        else:
            t += in_gap
        convs.append(generate_conversation(cfg, rng, cid, t))
    return convs


SCENARIOS = {
    "pareto_burst": pareto_burst,
    "supervisor_worker": supervisor_worker,
    "hitl_longpark": hitl_longpark,
    "shared_preamble_fleet": shared_preamble_fleet,
}


def make_scenario(name: str, n_conversations: int, seed: int = 0,
                  scale: str = "paper", cid_offset: int = 0,
                  arrival_offset_s: float = 0.0,
                  **kwargs) -> List[Conversation]:
    """Build a named scenario. `cid_offset` / `arrival_offset_s` shift the
    generated ids and arrival clock so multiple scenarios can be combined
    into one workload without colliding."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; available: "
                         f"{', '.join(sorted(SCENARIOS))}")
    convs = SCENARIOS[name](n_conversations, seed=seed, scale=scale,
                            **kwargs)
    for c in convs:
        c.cid += cid_offset
        c.arrival_s += arrival_offset_s
    return convs


def workload_stats(convs: List[Conversation]) -> WorkloadStats:
    """Measured stats for the provisioning equations (§4.1)."""
    first = float(np.mean([c.first_input_len for c in convs]))
    vol = float(np.mean([c.decoder_token_volume for c in convs]))
    peak = float(np.mean([c.peak_context_tokens() for c in convs]))
    # lifetime approximation: tool time + decode at 1k tok/s + prefill time
    life = float(np.mean([
        sum(t.tool_time_s for t in c.turns)
        + c.total_output_tokens / 1_000.0
        + c.first_input_len / 25_000.0
        for c in convs]))
    return WorkloadStats(mean_first_input=first, mean_decoder_volume=vol,
                         mean_lifetime_s=life, mean_peak_kv_tokens=peak)
