"""Mean host-clock span of an append (`ReplicaEngine.append_prefill`) in
the window, in ms: the benchmark's span around the call, which ends in the
replica's device synchronize."""


def read(ctx):
    s = [sp.t1 - sp.t0 for sp in ctx["spans"] if sp.name == "append"]
    return 1e3 * sum(s) / len(s) if s else None
