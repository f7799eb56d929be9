"""Host-clock ms per decode step: the benchmark's spans around the
window's decode chunks (`ReplicaEngine.decode_steps`) over the steps they
ran (the longest share of each chunk)."""


def read(ctx):
    t = steps = 0
    for sp in ctx["spans"]:
        if sp.name == "decode":
            emit = sp.info["emit"]
            if emit.any():
                t += sp.t1 - sp.t0
                steps += int(sp.info["rem"][emit].max())
    return 1e3 * t / steps if steps else None
