"""``grad_class``'s share of its bound in training: the calls' bytes
(``harness/roofline.py::grad_class_bytes``) over 3.35 TB/s, over the
time of the card's ``grad_class`` kernels in the traced stretch.  The
valid rows are the stretch's env-steps less the episodes it completed
(a game's first step has no previous afterstate to update)."""

from harness import roofline, trace


def read(ctx):
    if ctx["kind"] != "train":
        return None
    calls = ctx["calls"].get("grad_class", [])
    us = trace.kernel_us(ctx["trace"], "grad_class")
    if not calls or us <= 0:
        return None
    valid = ctx["steps"] * ctx["envs"] - ctx["episodes_done"]
    return roofline.share(roofline.grad_class_bytes(calls, valid), us * 1e-6)
