"""Share of the profiled sub-window in which no kernel ran on the card, in
%: the window minus the union of the kernel intervals."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
