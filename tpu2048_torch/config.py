"""Typed configuration of the port (``tpu2048/config.py``).

A copy of the reference's frozen dataclasses and their dict helpers,
field for field, so that the two packages read each other's stored
configs: ``AgentConfig``, ``TrainConfig``, ``SearchConfig``,
``MeshConfig``, ``StorageConfig``, ``to_dict``, ``agent_config_from_dict``
and ``train_config_from_dict``.  The comments are the
reference's; where they speak of Pallas kernels or the TPU, the port's
counterpart is its CUDA kernels on the card (``ops/kernels.py``).
``tests/test_torch_shared.py`` holds the copy equal to its original.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict


@dataclass(frozen=True)
class AgentConfig:
    """TD(0) n-tuple learner hyperparameters.

    Defaults are the CHAMPION recipe (n=5 features, temporal-coherence
    optimizer with meta-rate alpha=1.0, per-move 8-image scatter
    symmetry — the best-quality configuration per QUALITY.md, beating
    the reference's best published agent at half the episode budget).
    To reproduce the reference's own rule instead, set
    ``optimizer="sgd", alpha=0.25`` (its defaults,
    ``r_learning.py:90-91`` / ``dash_utils.py:29-38``); the decay
    schedule fields below only apply in sgd mode.
    """

    n: int = 5
    alpha: float = 1.0
    decay: float = 0.75
    decay_step: int = 10000
    low_alpha_limit: float = 0.01
    # "mean": collision-aware batched TD — each table entry's summed
    # update is divided by its hit count this step, which keeps the
    # per-entry effective learning rate at the sequential reference's
    # alpha/num_feat no matter how many lockstep envs collide on it
    # (stability fix for mini-batch TD; SURVEY §7 hard part 2).
    # "sum": raw scatter-add, exactly the reference numerics at
    # num_envs=1 (used by the sequential-equivalence tests).
    # (A row-local "rowmean" variant — normalizing only within-board
    # collisions to drop the dense hit-count scatter/gather pair —
    # was tried by the reference and REJECTED:
    # cross-env collisions are systematic, not rare — every fresh run
    # starts all envs synchronized, and the all-empty cross/block
    # pattern is shared by many boards on every step — and without
    # their normalization the summed updates blow the early-game
    # entries up by orders of magnitude within a few steps.)
    update_mode: str = "mean"
    # How the D4 symmetry updates are realized:
    # "periodic": scatter identity features only on the hot path and
    #   fold the accumulated delta through the 7 non-identity table
    #   transforms once per jitted segment (bandwidth-cheap transposes;
    #   mathematically the same total update, arriving with at most
    #   steps_per_call delay) — the TPU-fast default.
    # "scatter": per-step 8-image scatter, the reference's exact
    #   per-move semantics (used by sequential-equivalence tests);
    #   highest sample efficiency per QUALITY.md — the default.
    # "none": no symmetry coupling at all (ablation).
    sym_mode: str = "scatter"
    # How "scatter" (per-move 8-image) updates are realized:
    # "canonical": weights live at ONE representative entry per D4
    #   orbit (the orbit-minimal index, features/canonical.py); reads
    #   and updates of the big 16^5/14^6 gather classes become a single
    #   sparse gather/scatter with the symmetry carried by the index
    #   normalization itself — per-move 8-image semantics at O(batch)
    #   cost, no dense table passes.  The small MXU classes keep their
    #   matmul path with a class-local fold.  The default (fastest;
    #   same per-entry numerics as "fold"/"index" under "mean", exact
    #   orbit-stabilizer totals under "sum").
    # "fold": scatter IDENTITY features into a dense per-step delta and
    #   add its 7 non-identity D4 table transforms (reshape+transpose
    #   copies at HBM bandwidth) — the same per-move totals as the
    #   8-image scatter (f32 summation order aside), at 1/8th the index
    #   traffic; the dense passes over the table dominate at n=6.
    # "index": explicit (N, 8, F) symmetry-image indices, the reference's
    #   literal per-move scatter order (kept for sequential-equivalence
    #   tests and bitwise reproduction of round-2 runs).
    # NOTE: "canonical" stores the table in canonical-orbit form; use
    # features.canonical.to_dense_table when exporting weights to an
    # identity-index consumer (trial, native engine, watch bodies) —
    # store/checkpoint.load_agent_dense does this automatically.
    sym_impl: str = "canonical"
    # How weight-table lookups/updates hit the hardware (identical
    # numerics up to ~2^-18 rounding, see tpu2048/ops/dispatch.py):
    # "auto": fused Pallas kernels on TPU, gather elsewhere;
    # "gather": XLA gather/scatter; "onehot": two-level one-hot MXU
    # matmuls in plain XLA; "pallas": fused Pallas kernels with
    # VMEM-resident tables (in the port: the CUDA kernels' wrappers
    # on any device, their plain versions on CPU tensors).
    table_ops: str = "auto"
    # Board representation in the train step (identical rollouts):
    # "cells": (N,4,4) int8 boards (reference-shaped, portable);
    # "codes": (N,4) int32 packed row codes — no rot90 relayouts,
    # half the LUT gather traffic (engine/fast.py).
    engine_mode: str = "codes"
    # Weight-update rule:
    # "sgd": alpha-scheduled TD(0), the reference's rule
    #   (r_learning.py:240-241 + decay schedule);
    # "tc": temporal coherence — per-weight adaptive learning rate
    #   |E|/A where E sums signed and A absolute TD deltas (Jaskowski
    #   2016, arXiv:1604.05085).  Self-annealing: use alpha=1.0 and no
    #   decay schedule (the schedule is skipped in this mode).
    optimizer: str = "tc"
    # Precision of the ACTOR's value pass over the 4 candidate
    # afterstates (codes-engine train path):
    # "bf16x2": two-pass split kernel, ~2^-18 relative — numerically
    #   exact-grade selection AND bootstrap in one pass (the
    #   conservative mode).
    # "bf16": single-pass bf16 MXU classes for SELECTION (~2^-8 — the
    #   greedy argmax only flips on near-ties, where both moves are
    #   near-equally good), with the TD bootstrap value re-derived at
    #   full precision for the chosen afterstate from the indices
    #   already in hand — TD math stays exact while the 4N-row
    #   selection pass takes the cheaper single pass.  The default
    #   (quality A/B'd against "bf16x2" at identical seeds, QUALITY.md
    #   round 5).  The gather classes are plain f32 gathers (exact) in
    #   either mode.
    actor_precision: str = "bf16"


@dataclass(frozen=True)
class TrainConfig:
    """Vectorized training loop configuration."""

    num_envs: int = 8192
    steps_per_call: int = 64  # jit-rolled steps per host iteration
    ring_size: int = 8192  # completed-episode metrics ring buffer
    # Envs with full (move, spawn) trajectory recording; -1 (default)
    # records ALL envs so the saved best game is the TRUE best game of
    # the run, like the reference's best-game save
    # (r_learning.py:299-306) — at 8192 envs x 16384 steps the two int8
    # logs cost 268 MB of HBM.  Set a small count to trade capture
    # coverage for memory on tight configurations.
    record_envs: int = -1
    max_record_steps: int = 16384
    seed: int = 0
    episodes: int = 100000  # target completed episodes
    checkpoint_every: int = 1000  # in completed episodes (ref cadence)
    log_every: int = 100


@dataclass(frozen=True)
class SearchConfig:
    """Expectimax parameters (reference ``look_forward`` signature)."""

    depth: int = 0
    width: int = 1
    since_empty: int = 6


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh / sharding configuration."""

    data: int = 1  # environments sharded along this axis
    model: int = 1  # optional weight-table sharding (TP analogue)


@dataclass(frozen=True)
class StorageConfig:
    backend: str = "local"  # "local" | "s3" | "memory"
    root: str = "~/.tpu2048"
    bucket: str = ""


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def agent_config_from_dict(d: Dict[str, Any]) -> AgentConfig:
    names = {f.name for f in dataclasses.fields(AgentConfig)}
    return AgentConfig(**{k: v for k, v in d.items() if k in names})


def train_config_from_dict(d: Dict[str, Any]) -> TrainConfig:
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in d.items() if k in names})
