"""Decode steps' share of the card's roofline, in %: each step's bound
(the larger of its FLOPs over the bf16 peak and its bytes over the HBM
bandwidth, counted at every live slot's length) summed over the decode
chunks of the profiled sub-window, over the device time of those calls
(the union of the kernels inside each `bench.decode` range)."""


def _args(sp):
    return {k: sp.info[k] for k in ("lengths", "emit", "rem")}


def read(ctx):
    c, pk, m, tr = ctx["counts"], ctx["peaks"], ctx["model"], ctx["trace"]
    if pk is None or tr is None:
        return None
    spans = [sp for sp in ctx["spans"] if sp.name == "decode" and sp.profiled]
    n, dev = tr.calls_busy_s("decode")
    if not spans or n != len(spans) or not dev:
        return None
    bound = sum(c.bound_s(*c.decode_step_counts(m, live), pk)
                for sp in spans for live in c.live_steps(**_args(sp)))
    return 100.0 * bound / dev
