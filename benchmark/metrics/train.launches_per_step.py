"""The card's operations (kernels, memsets, copies) per train step in
the traced stretch."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["trace"].device:
        return None
    return len(ctx["trace"].device) / ctx["steps"]
