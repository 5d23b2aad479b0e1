"""The card's operations (kernels, memsets, copies) per search step in
the traced stretch."""


def read(ctx):
    if ctx["kind"] != "search" or not ctx["trace"].device:
        return None
    return len(ctx["trace"].device) / ctx["steps"]
