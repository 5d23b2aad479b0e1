"""Faults planted under the timed path, to show that the check sees them.

Each is a context manager that patches the program for its duration:

* ``unchanged``: a call that returns its state unchanged (a train
  segment, or a search segment);
* ``half``: half of the batch left out, the mean taken over the rest
  (the train step updates from the first half of its envs only; the
  search trees only the first half of the games' roots);
* ``altered``: an answer altered where it is produced (the search's
  chosen afterstate of game 0 is turned over, so that its move lands
  on another board).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, value):
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def unchanged(kind: str):
    if kind == "train":
        from tpu2048_torch.agent import td

        def make(*args, **kw):
            return lambda state: state

        with _patched(td, "make_train_segment", make):
            yield
    else:
        from tpu2048_torch.train import trial

        orig = trial._make_eval_segment

        def make(*args, **kw):
            seg = orig(*args, **kw)

            def segment(st, weights):
                return st

            segment.search_stats = seg.search_stats
            return segment

        with _patched(trial, "_make_eval_segment", make):
            yield


@contextlib.contextmanager
def half(kind: str):
    if kind == "train":
        from tpu2048_torch.agent import td

        orig = td.make_train_step

        def make(*args, **kw):
            step = orig(*args, **kw)

            def wrapped(state):
                n = state.prev_valid.shape[0]
                keep = torch.arange(n, device=state.prev_valid.device) < n // 2
                return step(state._replace(prev_valid=state.prev_valid & keep))

            return wrapped

        with _patched(td, "make_train_step", make):
            yield
    else:
        from tpu2048_torch.train import trial

        orig = trial.make_compacted_estimator

        def make(*args, **kw):
            est = orig(*args, **kw)

            def wrapped(roots, key, need):
                r = need.shape[0]
                games = torch.arange(r, device=need.device) % (r // 4)
                return est(roots, key, need & (games < r // 8))

            wrapped.tier_counts = est.tier_counts
            wrapped.tree = est.tree
            return wrapped

        with _patched(trial, "make_compacted_estimator", make):
            yield


@contextlib.contextmanager
def altered(kind: str):
    if kind == "train":
        raise ValueError("a train cell gives no answer one by one")
    from tpu2048_torch.train import trial

    orig = trial.engf.canonicalize_chosen

    def wrapped(aft_codes, best_dir):
        out = orig(aft_codes, best_dir).clone()
        out[0] = out[0].flip(0)
        return out

    with _patched(trial.engf, "canonicalize_chosen", wrapped):
        yield


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
