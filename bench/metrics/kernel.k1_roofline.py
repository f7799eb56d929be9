"""K1 (split-KV flash decode attention) against its roofline, in %: every
layer's bound at each profiled decode step's live lengths, over the device
time of the `decode_split_kernel` and `decode_combine_kernel` launches in
the profiled sub-window."""

KERNELS = ("decode_split_kernel", "decode_combine_kernel")



def _args(sp):
    return {k: sp.info[k] for k in ("lengths", "emit", "rem")}


def read(ctx):
    c, pk, m, tr = ctx["counts"], ctx["peaks"], ctx["model"], ctx["trace"]
    if pk is None or tr is None:
        return None
    bound = 0.0
    for sp in ctx["spans"]:
        if sp.name == "decode" and sp.profiled:
            for live in c.live_steps(**_args(sp)):
                bound += m["n_layers"] * c.bound_s(c.k1_flops(m, live),
                                                   c.k1_bytes(m, live), pk)
    dev = tr.kernel_s(*KERNELS)
    return 100.0 * bound / dev if bound and dev else None
