"""The card's busy µs per train step in the traced stretch: the sum of
its operations' durations."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["trace"].device:
        return None
    return sum(e.dur for e in ctx["trace"].device) / ctx["steps"]
