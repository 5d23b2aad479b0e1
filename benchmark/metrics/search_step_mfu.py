"""The whole search step's share of the card's peak: the boards a step
has to value (every game's four afterstates, and below each needy root
its whole tree, sum over d = 1 .. depth of (4 * width) ** d boards) at
``harness/roofline.py::search_bytes`` each, over 3.35 TB/s, over the
traced stretch's wall time.  The first step of each call, whose boards
before it the benchmark does not see, is counted as its roots alone."""

from reference import features

from harness import roofline


def read(ctx):
    if ctx["kind"] != "search" or not ctx["trace"].device:
        return None
    t = ctx["traffic"]
    tree = sum((4 * t["width"]) ** d for d in range(1, t["depth"] + 1))
    boards = 4 * ctx["games"] * ctx["steps"] + tree * sum(ctx["needy_roots"])
    ts = features.tuples_from_config(ctx["config"]["tuples"])
    return roofline.share(roofline.search_bytes(boards, len(ts.cells)),
                          ctx["window_s"])
