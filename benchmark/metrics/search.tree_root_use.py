"""The share, in %, of the roots the search tree ran that needed it, in
the traced stretch: the program's ``search.roots_needy`` over its
``search.roots_expanded`` counter (a tier's roots, padded to whole
chunks).  Reported where the stretch ran on the card, as every
per-layer metric of a search cell."""

from harness import spans


def read(ctx):
    if ctx["kind"] != "search" or not ctx["trace"].device:
        return None
    c = spans.program_counters()
    if not c or not c.get("search.roots_expanded"):
        return None
    return 100.0 * c.get("search.roots_needy", 0) / \
        c["search.roots_expanded"]
