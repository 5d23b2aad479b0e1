"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

``JaxDraws`` is a draw source (``tpu2048_torch.draws.Draws``) that
replays the JAX reference's own key schedule, so the port plays the
same games from the same draws as ``tpu2048``:

  * ``trial.py:200-201``: ``k_init, key = split(PRNGKey(seed))``;
    ``new_codes`` draws from ``split(k_init, 4)`` (``fast.py:288-293``);
  * per step ``key, k_est, k_spawn = split(key, 3)`` (``trial.py:85``);
    the random policy draws ``uniform(k_est, (4, n))`` and
    ``spawn_codes`` draws from ``ku, kv = split(k_spawn)``
    (``fast.py:261-269``).

``JaxTrainDraws`` replays the train step's schedule likewise.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

# six xdist workers share the machine
torch.set_num_threads(2)


@jax.jit
def _split3(key):
    key, k_est, k_spawn = jax.random.split(key, 3)
    return key, k_est, k_spawn


@partial(jax.jit, static_argnums=1)
def _spawn_uv(key, n):
    ku, kv = jax.random.split(key)
    return jax.random.uniform(ku, (n,)), jax.random.uniform(kv, (n,))


@partial(jax.jit, static_argnums=1)
def _new_draws(key, n):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return (jax.random.randint(k1, (n,), 0, 16),
            jax.random.uniform(k2, (n,)),
            jax.random.randint(k3, (n,), 0, 15),
            jax.random.uniform(k4, (n,)))


@partial(jax.jit, static_argnums=1)
def _uniform(key, shape):
    return jax.random.uniform(key, shape)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


class JaxDraws:
    """Replays the reference trial's draws from ``PRNGKey(seed)``.
    ``k_init``, ``k_est`` and ``k_spawn`` may also be set directly to
    replay one engine call's key."""

    def __init__(self, seed: int = 0):
        self.k_init, self.key = jax.random.split(jax.random.PRNGKey(seed))
        self.k_est = self.k_spawn = None

    def split(self) -> None:
        self.key, self.k_est, self.k_spawn = _split3(self.key)

    def uniform(self, shape):
        return _t(_uniform(self.k_est, tuple(shape)))

    def spawn(self, n: int):
        return tuple(_t(a) for a in _spawn_uv(self.k_spawn, n))

    def new(self, n: int):
        return tuple(_t(a).to(torch.int32) if a.dtype != np.float32
                     else _t(a) for a in _new_draws(self.k_init, n))


@jax.jit
def _split2(key):
    return tuple(jax.random.split(key))


@partial(jax.jit, static_argnums=1)
def _weights_uniform(key, total):
    return jax.random.uniform(key, (total,), jnp.float32)


class JaxTrainDraws:
    """Replays the reference train step's draws from ``key``:

      * ``init_td_state``: ``kw, ke = split(key)``; the weights are
        ``uniform(kw) * 0.01`` and ``init_env_codes`` draws from
        ``split(ke, 4)`` (``td.py:195-201``); the state keeps ``key``;
      * per step ``key, k_spawn, k_reset = split(key, 3)``
        (``td.py:400``): spawns from ``split(k_spawn)``, the auto-reset
        from ``split(k_reset, 4)``.

    ``key`` is the state's key: a JAX state's ``key`` replays the
    steps that follow it."""

    def __init__(self, key):
        self.key = key
        self.kw, self.ke = _split2(key)
        self.k_spawn = self.k_reset = None

    def split(self) -> None:
        self.key, self.k_spawn, self.k_reset = _split3(self.key)

    def uniform(self, shape):
        (total,) = shape
        return _t(_weights_uniform(self.kw, total))

    def spawn(self, n: int):
        return tuple(_t(a) for a in _spawn_uv(self.k_spawn, n))

    def _new(self, key, n):
        return tuple(_t(a).to(torch.int32) if a.dtype != np.float32
                     else _t(a) for a in _new_draws(key, n))

    def new(self, n: int):
        return self._new(self.ke, n)

    def reset(self, n: int):
        return self._new(self.k_reset, n)


def rand_boards(n: int, seed: int = 0, high: int = 12) -> np.ndarray:
    """(n, 4, 4) int8 boards of exponents in [0, high), ~30% empty,
    with a full board and an empty board at the front."""
    rng = np.random.default_rng(seed)
    boards = rng.integers(1, high, (n, 4, 4)).astype(np.int8)
    boards[2:][rng.random((n - 2, 4, 4)) < 0.3] = 0
    boards[1] = 0
    return boards


def dyadic_weights(total: int, seed: int = 0) -> np.ndarray:
    """Integers in [0, 40] times 2^-12: every sum of up to 2^12 of them
    is exact in f32, in any order, so two evaluators that differ only
    in summation order give identical values."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 41, total) * 2.0**-12).astype(np.float32)
