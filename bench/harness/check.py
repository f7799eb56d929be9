"""The comparison that decides `correct`: once the window has closed and
the program is freed, a sample of the window's finished conversations,
drawn from the seed with the longest in it, is run once through the plain
reference (prompt turns and served tokens as one sequence), and each
served token's logit is compared with the reference's best at its
position. The number compared is the share of served tokens that are not
the reference's first choice (`miss_share`); the widest and the mean gap
are read beside it. The control (the reference under its lower precision
choosing the tokens at the same positions) is read the same way, and
`compare` judges the program's numbers and the control's alike.

The turn inputs are worked out again here: `turn_tokens` is a frozen copy
of how the server draws a turn's tokens from the run seed
(`EngineServer._turn_tokens` and its preamble block)."""
from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import traffic


def turn_tokens(seed: int, s: traffic.Shape, idx: int, vocab: int
                ) -> np.ndarray:
    n = s.turns[idx][0]
    rng = np.random.RandomState((seed * 1000003 + s.cid * 9973 + idx * 7919)
                                % (2 ** 31))
    toks = rng.randint(0, vocab, size=n).astype(np.int32)
    if idx == 0 and s.preamble_id is not None and s.preamble_tokens > 0:
        prng = np.random.RandomState(
            (seed * 1000003 + 0x5eed + s.preamble_id * 104729) % (2 ** 31))
        toks[:s.preamble_tokens] = prng.randint(
            0, vocab, size=s.preamble_tokens).astype(np.int32)
    return toks


def sequence(seed: int, s: traffic.Shape, streams: Sequence[List[int]],
             vocab: int) -> Tuple[List[int], List[int], List[int]]:
    """(the tokens the conversation fed, the positions whose logits chose
    a served token, those served tokens). A turn's stream is the prefill's
    token then the decoded ones; all but its last were fed back."""
    seq, at, served = [], [], []
    for i, stream in enumerate(streams):
        seq.extend(int(t) for t in turn_tokens(seed, s, i, vocab))
        for j, tok in enumerate(stream):
            if j:
                seq.append(int(stream[j - 1]))
            at.append(len(seq) - 1)
            served.append(int(tok))
    return seq, at, served


def pick(shapes: Sequence[traffic.Shape], seed: int, min_tokens: int,
         max_convs: int) -> List[traffic.Shape]:
    """The longest conversation, then others in an order drawn from the
    seed, until the sample holds min_tokens served tokens or max_convs
    conversations."""
    if not shapes:
        return []
    longest = max(shapes, key=lambda s: (s.context_after(len(s.turns) - 1),
                                         -s.cid))
    rest = [s for s in shapes if s is not longest]
    order = np.random.default_rng(seed).permutation(len(rest))
    out = [longest]
    n = longest.output_tokens + len(longest.turns)
    for i in order:
        if n >= min_tokens or len(out) >= max_convs:
            break
        out.append(rest[i])
        n += rest[i].output_tokens + len(rest[i].turns)
    return out


def reference(conf: Dict):
    return importlib.import_module(f"bench.reference.{conf['reference']}")


def gaps(ref, weights, m: Dict, seq, at, served, device,
         control: bool = False, **sizes):
    """At each position, how far the reference's logit of the served
    token lies below its best; with `control`, also the gap of the token
    that the control (the reference with its weights under `ref.fp8_cast`
    and its matrix products' inputs under `ref.fp8_rows`) puts first."""
    tokens = torch.as_tensor(seq)
    logits = ref.logits_at(weights, m, tokens, at, device, **sizes)
    best = logits.max(-1).values

    def gap(pick_):
        got = logits.gather(-1, pick_[:, None].long())[:, 0]
        return (best - got).double().cpu().numpy()

    pick_ = torch.as_tensor(served, device=logits.device)
    if ((pick_ < 0) | (pick_ >= m["vocab_size"])).any():
        served_gaps = np.array([np.inf])
    else:
        served_gaps = gap(pick_)
    if not control:
        return served_gaps, None
    other = ref.logits_at(weights, m, tokens, at, device, cast=ref.fp8_cast,
                          cast_in=ref.fp8_rows, **sizes)
    return served_gaps, gap(other.argmax(-1))


def numbers(g: np.ndarray) -> Dict[str, float]:
    """What a sample's per-token gaps read: the share of tokens that are
    not the reference's first choice, the widest gap and the mean gap."""
    g = np.asarray(g, np.float64)
    if g.size == 0:
        return {"miss_share": 0.0, "logit_gap": 0.0, "mean_gap": 0.0}
    return {"miss_share": float(np.mean(g > 0)), "logit_gap": float(g.max()),
            "mean_gap": float(g.mean())}


def judge(conf: Dict, weights, seed: int, sample: Sequence[traffic.Shape],
          streams: Dict[int, List[List[int]]], device,
          control: bool = False, **sizes) -> Dict:
    """The program's numbers over the sample (`numbers` of every served
    token's gap) and, with `control`, the control's under "control": the
    reference computed in float8 (weights and every matrix product's
    input) put in the program's place. `sizes`
    (block, rows) bound the reference's working memory."""
    m = conf["model"]
    ref = reference(conf)
    ref.exact_matmuls()
    prog, ctl = [], []
    for s in sample:
        seq, at, served = sequence(seed, s, streams[s.cid], m["vocab_size"])
        g, gc = gaps(ref, weights, m, seq, at, served, device, control,
                     **sizes)
        prog.append(g)
        if control:
            ctl.append(gc)
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0)  # noqa: E731
    out = {**numbers(cat(prog)), "n_tokens": int(sum(len(g) for g in prog)),
           "n_conversations": len(sample)}
    if control:
        out["control"] = numbers(cat(ctl))
    return out


def compare(check: Dict, judged: Dict, n_unfinished: int) -> Dict:
    """Each number compared beside its limit: the share of served tokens
    that are not the reference's first choice, the window's conversations
    left unfinished, and the tokens sampled. `correct` holds when every
    one is within its limit."""
    if check.get("max_miss_share") is None:
        raise ValueError("this configuration has no limit read for "
                         "max_miss_share")
    return {
        "miss_share": {"value": judged["miss_share"],
                       "limit": check["max_miss_share"]},
        "unfinished": {"value": n_unfinished, "limit": 0},
        "sampled_tokens": {"value": judged["n_tokens"], "limit": 1,
                           "at_least": True}}


def passes(compared: Dict) -> bool:
    return all((v["value"] >= v["limit"]) if v.get("at_least")
               else (v["value"] <= v["limit"]) for v in compared.values())
