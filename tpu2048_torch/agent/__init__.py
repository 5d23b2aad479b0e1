"""The TD(0) n-tuple actor-learner on torch tensors (``tpu2048/agent``)."""

from .td import (
    Metrics,
    Recorder,
    TDState,
    evaluate_boards,
    init_td_state,
    make_train_step,
    select_greedy,
)

__all__ = [
    "Metrics",
    "Recorder",
    "TDState",
    "evaluate_boards",
    "init_td_state",
    "make_train_step",
    "select_greedy",
]
