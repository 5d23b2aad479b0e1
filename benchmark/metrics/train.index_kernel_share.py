"""The share, in %, of the train actor's afterstates (4 a step of each
env) whose feature indices the program gave its index kernel's wrapper
in the traced stretch: its ``td.index_rows`` counter over 4 x envs x
steps.  Reported where the stretch ran on the card; a program without
the counter reports nothing."""

from harness import spans


def read(ctx):
    if ctx["kind"] != "train" or not ctx["trace"].device:
        return None
    c = spans.program_counters()
    if not c or "td.index_rows" not in c:
        return None
    return 100.0 * c["td.index_rows"] / (4 * ctx["envs"] * ctx["steps"])
