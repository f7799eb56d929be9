"""Turn-1 prefills' share of the card's bf16 peak, in %: the model FLOPs
of the profiled sub-window's turn-1 prefills (at their live lengths) over
the device time of those calls (the union of the kernels inside each
`bench.prefill` range) and the peak."""


def read(ctx):
    c, pk, tr = ctx["counts"], ctx["peaks"], ctx["trace"]
    if pk is None or tr is None:
        return None
    spans = [sp for sp in ctx["spans"] if sp.name == "prefill" and sp.profiled]
    n, dev = tr.calls_busy_s("prefill")
    if not spans or n != len(spans) or not dev:
        return None
    flops = sum(c.prefill_flops(ctx["model"], sp.info["len"]) for sp in spans)
    return 100.0 * flops / dev / pk["bf16_flops"]
