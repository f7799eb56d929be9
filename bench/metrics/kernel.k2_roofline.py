"""K2 (flash prefill attention) against its roofline, in %: every layer's
bound at each profiled turn-1 prefill's live length, over the device time
of the `prefill_*_kernel` launches in the profiled sub-window."""

KERNELS = ("prefill_mma_kernel", "prefill_f32_kernel")


def read(ctx):
    c, pk, m, tr = ctx["counts"], ctx["peaks"], ctx["model"], ctx["trace"]
    if pk is None or tr is None:
        return None
    bound = 0.0
    for sp in ctx["spans"]:
        if sp.name == "prefill" and sp.profiled:
            s = sp.info["len"]
            bound += m["n_layers"] * c.bound_s(c.k2_flops(m, s),
                                               c.k2_bytes(m, s), pk)
    dev = tr.kernel_s(*KERNELS)
    return 100.0 * bound / dev if bound and dev else None
