"""The card's busy µs per search step in the traced stretch: the sum of
its operations' durations."""


def read(ctx):
    if ctx["kind"] != "search" or not ctx["trace"].device:
        return None
    return sum(e.dur for e in ctx["trace"].device) / ctx["steps"]
