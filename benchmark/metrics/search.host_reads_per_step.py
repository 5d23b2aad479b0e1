"""The program's reads that wait for the card, per search step, in the
traced stretch: its ``host_reads`` over its ``search.steps`` counter
(the tier choice's read and the segment's read).  Reported where the
stretch ran on the card, as every per-layer metric of a search cell."""

from harness import spans


def read(ctx):
    if ctx["kind"] != "search" or not ctx["trace"].device:
        return None
    c = spans.program_counters()
    if not c or not c.get("search.steps"):
        return None
    return c.get("host_reads", 0) / c["search.steps"]
