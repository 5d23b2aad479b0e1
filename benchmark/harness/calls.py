"""The shapes of the program's kernel calls in the traced stretch.

A roofline needs the bytes of each call, and the trace does not carry
a hand-written kernel's arguments.  So, in the traced stretch only, the
benchmark puts a recorder in front of the program's kernel wrappers in
``tpu2048_torch.ops.kernels`` (``eval_class``, ``grad_class``): it
notes the shapes of each call's arguments and calls the wrapper.  It
launches nothing and reads nothing from the card.  A wrapper that a
later program no longer has is not recorded, and its roofline is left
out.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List


@contextlib.contextmanager
def recording(module, names) -> Dict[str, List[tuple]]:
    """``with recording(kernels, ["eval_class"]) as log:`` ->
    ``log["eval_class"]``: one tuple of argument shapes per call (a
    shape for a tensor, the value for anything else)."""
    log: Dict[str, List[tuple]] = defaultdict(list)
    saved = {}
    for name in names:
        orig = getattr(module, name, None)
        if orig is None:
            continue

        def wrapper(*args, __orig=orig, __name=name, **kw):
            log[__name].append(tuple(
                tuple(a.shape) if hasattr(a, "shape") else a for a in args))
            return __orig(*args, **kw)

        # the wrappers count their launches in an attribute of their own
        # name; the recorder carries it while it stands in
        wrapper.__dict__.update(orig.__dict__)
        saved[name] = orig
        setattr(module, name, wrapper)
    try:
        yield log
    finally:
        for name, orig in saved.items():
            orig.__dict__.update(getattr(module, name).__dict__)
            setattr(module, name, orig)
