"""MiB of KV cache moved per window conversation: the bytes the server
counted over the window's transfers (`nbytes_of` of each package) per
transfer, times the transfers each window conversation made."""


def read(ctx):
    w = ctx["window"]
    if w.n_transfers == 0:
        return None
    return w.transfer_bytes / w.n_transfers * ctx["transfers_per_conv"] / 2**20
