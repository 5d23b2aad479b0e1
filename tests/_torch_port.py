"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

``JaxDraws`` is a draw source (``tpu2048_torch.draws.Draws``) that
replays the JAX reference's own key schedule, so the port plays the
same games from the same draws as ``tpu2048``:

  * ``trial.py:200-201``: ``k_init, key = split(PRNGKey(seed))``;
    ``new_codes`` draws from ``split(k_init, 4)`` (``fast.py:288-293``);
  * per step ``key, k_est, k_spawn = split(key, 3)`` (``trial.py:85``);
    the random policy draws ``uniform(k_est, (4, n))`` and
    ``spawn_codes`` draws from ``ku, kv = split(k_spawn)``
    (``fast.py:261-269``);
  * the search estimator takes ``k_est`` (``trial.py:130``) as a
    ``JaxSearchKey``: a chunked root batch splits it
    (``expectimax.py:234``), and each tree level draws from
    ``split(fold_in(key, depth))`` (``:151``, ``:112-119``).

``JaxTrainDraws`` replays the train step's schedule likewise, and
``jax_cfg`` gives the JAX package the twin of a port config.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpu2048.config as jax_config

# six xdist workers share the machine
torch.set_num_threads(2)


def jax_cfg(cfg):
    """The JAX package's config of the same class and fields as the
    port's ``cfg`` (``tpu2048_torch.config``), for the JAX side of a
    comparison."""
    return getattr(jax_config, type(cfg).__name__)(
        **dataclasses.asdict(cfg))


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


@partial(jax.jit, static_argnums=(1, 2, 3))
def _level(key, depth, b, width):
    k_spawn, k_rec = jax.random.split(jax.random.fold_in(key, depth))
    kp, kv = jax.random.split(k_spawn)
    noise = jax.random.uniform(kp, (b, 16), minval=1e-6, maxval=1.0)
    return noise, jax.random.uniform(kv, (b, width)), k_rec


@partial(jax.jit, static_argnums=1)
def _split_n(key, n):
    return jax.random.split(key, n)


class JaxSearchKey:
    """A search key (``tpu2048_torch.draws.SearchKey``) that replays
    the reference tree's draws from the JAX key ``key``."""

    def __init__(self, key):
        self.key = key

    def chunks(self, n: int):
        return [JaxSearchKey(k) for k in _split_n(self.key, n)]

    def level(self, depth: int, b: int, width: int):
        noise, u, k_rec = _level(self.key, depth, b, width)
        return _t(noise), _t(u), JaxSearchKey(k_rec)


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

    def search(self):
        return JaxSearchKey(self.k_est)


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


# -- the train state of both packages, compared ------------------------------

TOL = 2.0**-17


def np_of(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(got, want, name):
    """Within 2^-17 relative, or 2^-17 of ``want``'s largest entry."""
    got, want = np_of(got), np_of(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


def assert_eq(got, want, name):
    np.testing.assert_array_equal(np_of(got), np_of(want), err_msg=name)


def assert_train_state(st, js, tcfg, logs=True):
    """The port's train state against JAX's: every integer bitwise
    (the engine state, the previous afterstate's indices, the schedule
    counters, the metrics rings without their trash slot, which every
    unfinished lane writes in no set order, and the recorder; its logs
    without the port's spill column, unless ``logs`` is false); alpha
    bitwise; the bootstrap values and the tables within ``TOL``."""
    for f in st.env._fields:
        assert_eq(getattr(st.env, f), getattr(js.env, f), f"env.{f}")
    for f in ("prev_idx", "prev_valid", "prev_cidx", "prev_cmult",
              "top_tile", "next_decay", "alpha"):
        assert_eq(getattr(st, f), getattr(js, f), f)
    assert_close(st.prev_value, js.prev_value, "prev_value")
    for f in ("weights", "opt_e", "opt_a"):
        assert_close(getattr(st, f), getattr(js, f), f)
    ring = tcfg.ring_size
    for f in st.metrics._fields:
        a, b = np_of(getattr(st.metrics, f)), np_of(getattr(js.metrics, f))
        if a.ndim:
            a, b = a[:ring], b[:ring]
        assert_eq(a, b, f"metrics.{f}")
    s = tcfg.max_record_steps
    rec, jrec = st.recorder, js.recorder
    for f in rec._fields:
        a, b = getattr(rec, f), getattr(jrec, f)
        if f in ("moves", "spawns"):
            if not logs:
                continue
            a = a[:, :s]
        assert_eq(a, b, f"recorder.{f}")


class JaxTrainFns:
    """The JAX train step (staged and unstaged) and segment of a port
    config pair, each jitted once."""

    def __init__(self):
        self._fns = {}

    def get(self, acfg, tcfg, what):
        """``what``: "step" (staged), "unstaged" or "segment"."""
        key = (acfg, tcfg, what)
        if key not in self._fns:
            from tpu2048.agent import td as jtd
            from tpu2048.features import ntuple as jnt

            ts, ja, jt = jnt.get_tuple_set(acfg.n), jax_cfg(acfg), jax_cfg(tcfg)
            if what == "segment":
                fn = jtd.make_train_segment(ts, ja, jt)
            else:
                fn = jtd.make_train_step(ts, ja, jt, staged=what == "step")
            self._fns[key] = jax.jit(fn)
        return self._fns[key]


def fresh_state(acfg, tcfg, seed):
    """A fresh JAX train state of ``acfg`` from ``PRNGKey(seed)``."""
    from tpu2048.agent import td as jtd
    from tpu2048.features import ntuple as jnt

    return jtd.init_td_state(jnt.get_tuple_set(acfg.n), jax_cfg(acfg),
                             jax_cfg(tcfg), jax.random.PRNGKey(seed))


def check_segment(jaxfns, acfg, tcfg, js):
    """One segment of the port and of JAX from the JAX state ``js``,
    held together (``assert_train_state``).  Returns (the port's state,
    JAX's state) after it."""
    from tpu2048_torch.agent import td as ttd
    from tpu2048_torch.features import ntuple as tnt
    from tpu2048_torch.store.checkpoint import td_state_from_numpy

    st = td_state_from_numpy(js, "cpu")
    st = ttd.make_train_segment(tnt.get_tuple_set(acfg.n), acfg, tcfg,
                                JaxTrainDraws(js.key))(st)
    js = jaxfns.get(acfg, tcfg, "segment")(js)
    assert_train_state(st, js, tcfg)
    return st, js


def check_step(jaxfns, acfg, tcfg, js, staged=True):
    """One step of the port and of JAX from the JAX state ``js``, held
    together: staged, with its ``RecStep`` rows bitwise and the logs
    left to the merge; or unstaged, logs and best game included.
    Returns (the port's state, JAX's state) after it."""
    from tpu2048_torch.agent import td as ttd
    from tpu2048_torch.features import ntuple as tnt
    from tpu2048_torch.store.checkpoint import td_state_from_numpy

    st = td_state_from_numpy(js, "cpu")
    step = ttd.make_train_step(tnt.get_tuple_set(acfg.n), acfg, tcfg,
                               JaxTrainDraws(js.key), staged=staged)
    jstep = jaxfns.get(acfg, tcfg, "step" if staged else "unstaged")
    if staged:
        (st, rs), (js, jr) = step(st), jstep(js)
        for f in rs._fields:
            assert_eq(getattr(rs, f), getattr(jr, f), f"RecStep.{f}")
    else:
        st, js = step(st), jstep(js)
    assert_train_state(st, js, tcfg, logs=not staged)
    return st, js


class AfterSegment:
    """Learner settings by name -> JAX's state after one segment from a
    fresh state of that setting, the segment held against the port's
    (``check_segment``); computed once each.  Seeds follow the
    settings' order, from ``seed0``."""

    def __init__(self, variants, tcfg, seed0):
        self.variants, self.tcfg, self.seed0 = variants, tcfg, seed0
        self.jaxfns = JaxTrainFns()
        self._after = {}

    def __call__(self, name):
        if name not in self._after:
            acfg = self.variants[name]
            seed = self.seed0 + list(self.variants).index(name)
            js = fresh_state(acfg, self.tcfg, seed)
            self._after[name] = check_segment(self.jaxfns, acfg, self.tcfg,
                                              js)[1]
        return self._after[name]


def near_terminal_state(acfg, tcfg, seed):
    """A JAX train state of ``acfg`` whose boards are one or two moves
    from game over: checkerboards of two tile values with one or two
    holes.  Half the envs are 10 moves past the record limit, so their
    logs overflow."""
    from tpu2048.agent import td as jtd
    from tpu2048.engine import core as jcore
    from tpu2048.engine import fast as jfast
    from tpu2048.features import ntuple as jnt

    js = jtd.init_td_state(jnt.get_tuple_set(acfg.n), jax_cfg(acfg),
                           jax_cfg(tcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    m = tcfg.num_envs
    a = rng.integers(1, 7, m)[:, None, None]
    boards = np.where((np.add.outer(np.arange(4), np.arange(4)) % 2) == 0,
                      a, a + 1).astype(np.int8)
    for b in boards:
        b.reshape(16)[rng.choice(16, rng.integers(1, 3), replace=False)] = 0
    odo = jnp.asarray(np.where(np.arange(m) % 2 == 0, 0,
                               tcfg.max_record_steps + 10), jnp.int32)
    score = jnp.zeros(m, jnp.int32)
    if acfg.engine_mode == "codes":
        env = jfast.EnvStateC(codes=jfast.codes_from_boards(
            jnp.asarray(boards)), score=score, odometer=odo)
    else:
        env = jcore.EnvState(boards=jnp.asarray(boards), score=score,
                             odometer=odo)
    return js._replace(env=env, recorder=js.recorder._replace(
        starts=jnp.asarray(boards)))


def replay(rec) -> int:
    """The score of a recorder's best game, replayed move by move;
    every move must change the board and every spawn land on an empty
    cell."""
    from tpu2048_torch.engine.core import np_move

    board, score = np_of(rec.best_start).copy(), 0
    for t in range(int(rec.best_len)):
        board, delta, changed = np_move(board, int(rec.best_moves[t]))
        assert changed, f"illegal replay move at step {t}"
        sp = int(rec.best_spawns[t]) & 0xFF
        flat = board.reshape(16).copy()  # np_move may return a strided view
        assert flat[sp & 0xF] == 0
        flat[sp & 0xF] = (sp >> 4) + 1
        board = flat.reshape(4, 4)
        score += delta
    return score
