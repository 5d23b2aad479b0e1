"""The whole train step's share of the card's peak: the steps' bytes
(``harness/roofline.py::train_step_bytes``) over 3.35 TB/s, over the
traced stretch's wall time."""

from reference import features

from harness import roofline


def read(ctx):
    if ctx["kind"] != "train" or not ctx["trace"].device:
        return None
    ts = features.tuples_from_config(ctx["config"]["tuples"])
    nbytes = roofline.train_step_bytes(ctx["envs"], len(ts.whole),
                                       len(ts.canon)) * ctx["steps"]
    return roofline.share(nbytes, ctx["window_s"])
