"""The share of the traced search stretch in which no operation ran on
the card, in %."""


def read(ctx):
    if ctx["kind"] != "search" or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
