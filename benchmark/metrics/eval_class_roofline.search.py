"""``eval_class``'s share of its bound in search: the calls' index and
output bytes (``harness/roofline.py::eval_class_bytes``, the touched
table entries left out, so a lower bound) over 3.35 TB/s, over the time
of the card's ``eval_class`` kernels in the traced stretch."""

from harness import roofline, trace


def read(ctx):
    if ctx["kind"] != "search":
        return None
    calls = ctx["calls"].get("eval_class", [])
    us = trace.kernel_us(ctx["trace"], "eval_class")
    if not calls or us <= 0:
        return None
    return roofline.share(roofline.eval_class_bytes(calls), us * 1e-6)
