"""p95 over the window's conversations of their admission wait (seconds
in QUEUED, `Runtime.queue_waits()`), on the server's logical clock."""
import numpy as np


def read(ctx):
    waits = list(ctx["waits"].values())
    return float(np.percentile(waits, 95)) if waits else None
