"""K2's append instance against its roofline, in %: every layer's bound at
each profiled append's live lengths, over the device time of the
`append_mma_kernel` and `append_combine_kernel` launches in the profiled
sub-window. An append of s tokens on a prefix of p live rows: the larger
of the operations of the live causal pairs, 4·H·D·s·(p + (s + 1)/2), and
the bytes of the p + s K/V rows at the cache's dtype with q read and o
written once in the model's dtype. Nothing to read where no append was
profiled, or where the program has no such kernel."""

KERNELS = ("append_mma_kernel", "append_combine_kernel")


def read(ctx):
    c, pk, m, tr = ctx["counts"], ctx["peaks"], ctx["model"], ctx["trace"]
    if pk is None or tr is None:
        return None
    h, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    b = c.DTYPE_BYTES[m["dtype"]]
    kv = c.DTYPE_BYTES[m.get("kv_cache_dtype") or m["dtype"]]
    bound = 0.0
    for sp in ctx["spans"]:
        if sp.name == "append" and sp.profiled:
            s, p = sp.info["len"], sp.info["prev"]
            flops = 4.0 * h * hd * s * (p + (s + 1) / 2)
            nbytes = 2.0 * (p + s) * hkv * hd * kv + 2.0 * s * h * hd * b
            bound += m["n_layers"] * c.bound_s(flops, nbytes, pk)
    dev = tr.kernel_s(*KERNELS)
    return 100.0 * bound / dev if bound and dev else None
