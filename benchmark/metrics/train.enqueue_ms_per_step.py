"""The host's time to enqueue one train step: the benchmark's span
around each segment call, from the call to its return (before the
episode read that waits for the card), over the segment's steps; taken
on untraced segments just before the traced stretch."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["spans_s"]:
        return None
    return 1e3 * sum(ctx["spans_s"]) / ctx["span_steps"]
