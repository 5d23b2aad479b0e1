"""The engine's ``afterstates_codes`` and ``chosen_delta``, and the
breakdown, scaling and index-check twins
(``scripts/torch_bench_{engine,train,canon}_breakdown.py``,
``torch_bench_scaling.py``, ``torch_check_indices.py``), against the
JAX package on the CPU.

  * ``afterstates_codes`` and ``chosen_delta`` bitwise JAX's on the same
    boards, every direction (the twins of ``tests/test_fast_engine.py:51``,
    ``:128`` and ``:174``);
  * each engine-breakdown body rolled 8 steps at 64 envs, bitwise the
    reference's body (``scripts/bench_engine_breakdown.py:54-105``) in
    a ``lax.scan`` on JAX's keys, replayed through the draw seam;
  * the canonical breakdown's pieces against a jnp transcription of the
    reference's lines (``scripts/bench_canon_breakdown.py``, cited at
    each) at n=4 and n=5 with 64 envs: integers bitwise, floats within
    2^-17 relative (of the largest entry); the sorted-dedup update
    equal to the sparse one within 2^-17;
  * every script at a tiny size with ``--device cpu``, all at once: its
    row labels, in order, the reference script's (as ``chip_smoke.py``
    phase 22 holds them, a check that itself fails on a row left out),
    no jax or ``tpu2048`` module loaded; the scaling twin's JSON line
    has the reference's keys; the index check exact with and without
    TF32, and exiting 1 on a mismatch; without a card and without
    ``--device`` each script raises, and ``--backend nccl`` without a
    card per rank raises.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_bench
from _torch_port import (JaxTrainDraws, _split2, _split3, assert_close,
                         assert_eq, dyadic_weights, rand_boards)
from tpu2048.engine import fast as jfast
from tpu2048.features import canonical as jcanon
from tpu2048.features import ntuple as jnt
from tpu2048.features.symmetry import symmetrize_class_sum as jfold
from tpu2048.ops import dispatch as jdisp
from tpu2048.ops import fold_kernel as fk
from tpu2048_torch.engine import fast as tfast
from tpu2048_torch.features import canonical as tcanon
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.ops import dispatch as tdisp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# twin script -> (reference script, arguments of its tiny CPU run)
SCRIPTS = {
    "torch_bench_engine_breakdown.py": ("bench_engine_breakdown.py", [16]),
    "torch_bench_train_breakdown.py": ("bench_train_breakdown.py", [5, 32]),
    "torch_bench_canon_breakdown.py": ("bench_canon_breakdown.py", [5, 32]),
    "torch_bench_scaling.py": ("bench_scaling.py", ["--worlds", 1, 2]),
    "torch_check_indices.py": ("check_indices_tpu.py", []),
}
# seconds for the scripts' runs, then they are killed
LIMIT = 240


def _load(script: str):
    spec = importlib.util.spec_from_file_location(
        script[:-3], os.path.join(REPO, "scripts", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def engine_script():
    return _load("torch_bench_engine_breakdown.py")


@pytest.fixture(scope="module")
def canon_script():
    return _load("torch_bench_canon_breakdown.py")


def _codes(n: int, seed: int) -> np.ndarray:
    """(n, 4) int32 codes of random boards, a dead board (no legal
    move) in front so that a roll resets it."""
    boards = rand_boards(n, seed=seed, high=8)
    boards[0] = np.where(np.add.outer(np.arange(4), np.arange(4)) % 2, 1, 2)
    return np.array(jfast.codes_from_boards(jnp.asarray(boards)))


# -- afterstates_codes and chosen_delta --------------------------------------


def test_afterstates_codes_match_jax_bitwise():
    codes = _codes(256, seed=2)
    want = jfast.afterstates_codes(jnp.asarray(codes))
    got = tfast.afterstates_codes(torch.from_numpy(codes))
    for name, g, w in zip(("aft", "delta", "legal"), got, want):
        assert_eq(g, w, name)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert got[2].dtype == torch.bool
    # directions 1 and 3 come back transposed, as afterstates_full's
    full = tfast.afterstates_full(torch.from_numpy(codes))
    for g, f in zip(got, full):
        assert_eq(g, f, "afterstates_full")


@pytest.mark.parametrize("direction", [0, 1, 2, 3, "mixed"])
def test_chosen_delta_matches_jax_bitwise(direction):
    codes = _codes(256, seed=3)
    n = codes.shape[0]
    if direction == "mixed":
        best = np.random.default_rng(4).integers(0, 4, n).astype(np.int32)
    else:
        best = np.full(n, direction, np.int32)
    tcodes = np.array(jfast.transpose_codes(jnp.asarray(codes)))
    want = jfast.chosen_delta(jnp.asarray(codes), jnp.asarray(tcodes),
                              jnp.asarray(best))
    got = tfast.chosen_delta(torch.from_numpy(codes),
                             torch.from_numpy(tcodes), torch.from_numpy(best))
    assert got.dtype == torch.int32
    assert_eq(got, want, "chosen_delta")
    # the chosen direction's delta of the full expansion
    _aft, delta, _legal = tfast.afterstates_codes(torch.from_numpy(codes))
    assert_eq(got, delta[torch.from_numpy(best).long(), torch.arange(n)],
              "delta")
    assert np.asarray(want).any()


# -- the engine breakdown's bodies -------------------------------------------


class _BodyDraws(JaxTrainDraws):
    """A body's draws from its key ``k2``: per step ``k2, ks =
    split(k2)`` (``ways=2``) or ``k2, ks, kr = split(k2, 3)`` (``ways=3``),
    a spawn from ``ks``, fresh boards from ``kr``."""

    def __init__(self, key, ways: int):
        super().__init__(key)
        self.ways = ways

    def split(self) -> None:
        if self.ways == 2:
            self.key, self.k_spawn = _split2(self.key)
        else:
            self.key, self.k_spawn, self.k_reset = _split3(self.key)

    def new(self, n: int):
        return self.reset(n)


def _jax_bodies(n: int) -> dict:
    """``scripts/bench_engine_breakdown.py:54-105``, each body of a
    ``(codes, key)`` carry, and the ways its key splits per step."""

    def gathers_only(cd, k2):
        aft, legal, _t = jfast.afterstates_nc(cd)
        nc = jnp.where(legal.any(axis=0)[:, None], aft[0], cd)
        return nc, jax.random.fold_in(k2, 0)

    def spawn_only(cd, k2):
        k2, ks = jax.random.split(k2)
        nc, _, _ = jfast.spawn_codes(cd, ks)
        nc = nc.at[:, 0].set(0)
        return nc, k2

    def gathers_spawn(cd, k2):
        aft, legal, _t = jfast.afterstates_nc(cd)
        k2, ks = jax.random.split(k2)
        nc, _, _ = jfast.spawn_codes(aft[0], ks)
        return nc, k2

    def full(cd, k2):
        aft, legal, _t = jfast.afterstates_nc(cd)
        done = ~legal.any(axis=0)
        k2, ks, kr = jax.random.split(k2, 3)
        nc, _, _ = jfast.spawn_codes(aft[0], ks)
        nc = jnp.where(done[:, None], jfast.new_codes(n, kr), nc)
        return nc, k2

    def full_scored(cd, k2):
        aft, legal, tc = jfast.afterstates_nc(cd)
        bd = jnp.argmax(legal, axis=0).astype(jnp.int32)
        delta = jfast.chosen_delta(cd, tc, bd)
        done = ~legal.any(axis=0)
        k2, ks, kr = jax.random.split(k2, 3)
        nc, _, _ = jfast.spawn_codes(aft[0], ks)
        nc = nc + (delta[:, None] * 0).astype(nc.dtype)
        nc = jnp.where(done[:, None], jfast.new_codes(n, kr), nc)
        return nc, k2

    def gathers_quad(cd, k2):
        aft, delta, legal = jfast.afterstates_codes(cd)
        nc = jnp.where(legal.any(axis=0)[:, None], aft[0], cd)
        nc = nc + (delta[0][:, None] * 0).astype(nc.dtype)
        return nc, jax.random.fold_in(k2, 0)

    def full_quad(cd, k2):
        aft, delta, legal = jfast.afterstates_codes(cd)
        done = ~legal.any(axis=0)
        k2, ks, kr = jax.random.split(k2, 3)
        nc, _, _ = jfast.spawn_codes(aft[0], ks)
        nc = nc + (delta[0][:, None] * 0).astype(nc.dtype)
        nc = jnp.where(done[:, None], jfast.new_codes(n, kr), nc)
        return nc, k2

    return {"gathers only": (gathers_only, 2),
            "gathers quad (+scores)": (gathers_quad, 2),
            "full quad (+scores)": (full_quad, 3),
            "spawn only": (spawn_only, 2),
            "gathers + spawn": (gathers_spawn, 2),
            "full step": (full, 3),
            "full + chosen score": (full_scored, 3)}


def test_engine_breakdown_rows_are_the_references(engine_script):
    assert list(_jax_bodies(8)) == [r[0] for r in engine_script.ROWS]


@pytest.mark.parametrize("row", range(7))
def test_engine_body_matches_jax_bitwise(engine_script, row):
    k, n = 8, 64
    name, body = engine_script.ROWS[row]
    jbody, ways = _jax_bodies(n)[name]
    codes = _codes(n, seed=10 + row)
    key = jax.random.PRNGKey(row)

    @jax.jit
    def scan(cd, key):
        (cd, key), _ = jax.lax.scan(lambda c, _: (jbody(*c), None),
                                    (cd, key), None, length=k)
        return cd

    want = np.asarray(scan(jnp.asarray(codes), key))
    got = engine_script.roll(body, torch.from_numpy(codes),
                             _BodyDraws(key, ways), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, codes)


# -- the canonical breakdown's pieces ----------------------------------------


def _pieces(n: int, seed: int) -> dict:
    """The same inputs for both packages: 64 boards, their features,
    dw, a validity mask, tables with nonzero TC sums."""
    rng = np.random.default_rng(seed)
    ts = jnt.get_tuple_set(n)
    cells = rand_boards(64, seed=seed).reshape(64, 16)
    total = ts.total
    a = np.abs(rng.standard_normal(total)).astype(np.float32) * 1e-3
    a[rng.random(total) < 0.3] = 0.0
    return {
        "ts": ts, "tts": tnt.get_tuple_set(n), "cells": cells,
        "dw": (rng.standard_normal(64) * 1e-3).astype(np.float32),
        "valid": rng.random(64) < 0.8,
        "w": (rng.random(total, dtype=np.float32) * 0.01),
        "e": (rng.standard_normal(total) * 1e-3).astype(np.float32),
        "a": a, "alpha": np.float32(0.5),
    }


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _jax_tc_blocks(ts, classes, grads, fold, w, e, a, alpha, i, d, v):
    """``bench_canon_breakdown.py:109-133`` (``blocks_fold_tc``), the
    class pair folded by ``fold``."""
    for c, (dsum_b, hits_b) in zip(classes.matmul, grads(i, d, v)):
        size1 = c.h * c.l
        pair = jnp.stack([dsum_b.reshape(c.g, size1),
                          hits_b.reshape(c.g, size1)])
        pair = fold(ts, c, pair)
        nsz = c.g * size1
        dbar = pair[0].reshape(nsz) / jnp.maximum(pair[1].reshape(nsz), 1.0)
        w_blk = jax.lax.dynamic_slice(w, (c.start,), (nsz,))
        e_blk = jax.lax.dynamic_slice(e, (c.start,), (nsz,))
        a_blk = jax.lax.dynamic_slice(a, (c.start,), (nsz,))
        lr = jnp.where(a_blk > 0, jnp.abs(e_blk) /
                       jnp.maximum(a_blk, 1e-30), 1.0)
        w = jax.lax.dynamic_update_slice(
            w, w_blk + alpha * lr * dbar, (c.start,))
        e = jax.lax.dynamic_update_slice(e, e_blk + dbar, (c.start,))
        a = jax.lax.dynamic_update_slice(
            a, a_blk + jnp.abs(dbar), (c.start,))
    return w, e, a


def _jax_sparse_tc(w, e, a, alpha, ci, d, v):
    """``bench_canon_breakdown.py:143-155`` (``sparse_tc``)."""
    per = jnp.broadcast_to(d[:, None], ci.shape)
    per = jnp.where(v[:, None], per, 0.0)
    contrib = jnp.broadcast_to(v[:, None], ci.shape).astype(jnp.float32)
    hits = jnp.zeros_like(w).at[ci].add(contrib, mode="drop")
    per = per / jnp.maximum(hits[ci], 1.0)
    e_g, a_g = e[ci], a[ci]
    lr = jnp.where(a_g > 0, jnp.abs(e_g) / jnp.maximum(a_g, 1e-30), 1.0)
    w = w.at[ci].add(alpha * lr * per, mode="drop")
    e = e.at[ci].add(per, mode="drop")
    a = a.at[ci].add(jnp.abs(per), mode="drop")
    return w, e, a


def _jax_entry_reduce(keys, vals, drop_key):
    """``bench_canon_breakdown.py:169-188`` (``_entry_reduce``)."""
    m = keys.shape[0]
    ks, vs = jax.lax.sort([keys, vals], num_keys=1)
    ar = jnp.arange(m, dtype=jnp.int32)
    neq = ks[1:] != ks[:-1]
    is_first = jnp.concatenate([jnp.ones((1,), bool), neq])
    is_last = jnp.concatenate([neq, jnp.ones((1,), bool)])
    first_pos = jax.lax.cummax(jnp.where(is_first, ar, -1))
    last_pos = jnp.flip(jax.lax.cummin(jnp.flip(jnp.where(is_last, ar, m))))
    cs = jnp.cumsum(vs)
    ca = jnp.cumsum(jnp.abs(vs))
    prev = jnp.where(first_pos > 0, first_pos - 1, 0)
    seg_sum = cs[last_pos] - jnp.where(first_pos > 0, cs[prev], 0.0)
    seg_abs = ca[last_pos] - jnp.where(first_pos > 0, ca[prev], 0.0)
    count = (last_pos - first_pos + 1).astype(jnp.float32)
    tgt = jnp.where(is_first & (ks < drop_key), ks, drop_key)
    return tgt, seg_sum, seg_abs, count, ks


def _jax_dedup_tc(total, w, e, a, alpha, ci, d, v):
    """``bench_canon_breakdown.py:190-214`` (``dedup_tc``), its stacked
    form (every table here is under 32 M entries)."""
    per = jnp.broadcast_to(d[:, None], ci.shape)
    keys = jnp.where(v[:, None], ci, total).reshape(-1)
    tgt, seg_sum, seg_abs, cnt, ks = _jax_entry_reduce(
        keys, per.reshape(-1), total)
    add = seg_sum / cnt
    add_abs = seg_abs / cnt
    e_g, a_g = e[ks], a[ks]
    lr = jnp.where(a_g > 0, jnp.abs(e_g) / jnp.maximum(a_g, 1e-30), 1.0)
    wea = jnp.stack([w, e, a])
    upd = jnp.stack([alpha * lr * add, add, add_abs])
    wea = wea.at[:, tgt].add(upd, mode="drop", unique_indices=True)
    return wea[0], wea[1], wea[2]


def _hold_tables(got, want, name):
    for x, g, w in zip("wea", got, want):
        assert_close(g, w, f"{name} {x}")


@pytest.mark.parametrize("n", [4, 5])
def test_canon_indices_bitwise(n):
    p = _pieces(n, seed=n)
    jidx = jnt.feature_indices(p["ts"], jnp.asarray(p["cells"]))
    assert_eq(tnt.feature_indices(p["tts"], torch.from_numpy(p["cells"])),
              jidx, "feature_indices")
    jc, jm = jcanon.canonical_gather_indices(p["ts"], jnp.asarray(p["cells"]))
    tc, tm = tcanon.canonical_gather_indices(p["tts"],
                                             torch.from_numpy(p["cells"]))
    assert_eq(tc, jc, "canonical indices")
    assert_eq(tm, jm, "multiplicities")
    assert tc.shape[1] == (4 if n == 5 else 0)


@pytest.mark.parametrize("n", [4, 5])
def test_tc_update_matches_reference_lines(canon_script, n):
    """One class block's TC rule (``bench_canon_breakdown.py:122-131``)."""
    p = _pieces(n, seed=20 + n)
    start, nsz = 1000, 65536
    dbar = (np.random.default_rng(n).standard_normal(nsz) * 1e-3
            ).astype(np.float32)
    w, e, a, alpha, db = _j(p["w"], p["e"], p["a"], p["alpha"], dbar)
    w_blk = jax.lax.dynamic_slice(w, (start,), (nsz,))
    e_blk = jax.lax.dynamic_slice(e, (start,), (nsz,))
    a_blk = jax.lax.dynamic_slice(a, (start,), (nsz,))
    lr = jnp.where(a_blk > 0, jnp.abs(e_blk) / jnp.maximum(a_blk, 1e-30), 1.0)
    want = (jax.lax.dynamic_update_slice(w, w_blk + alpha * lr * db, (start,)),
            jax.lax.dynamic_update_slice(e, e_blk + db, (start,)),
            jax.lax.dynamic_update_slice(a, a_blk + jnp.abs(db), (start,)))
    tw, te, ta, talpha, tdb = _t(p["w"], p["e"], p["a"], p["alpha"], dbar)
    got = canon_script.tc_update(tw, te, ta, talpha, start, tdb)
    assert got[0] is tw  # in place
    _hold_tables(got, want, "tc_update")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n", [4, 5])
def test_class_chains_match_reference_lines(canon_script, n, fused):
    """The unfused chain against the reference's lines with its plain
    fold; the fused one against the same lines with the reference's
    fold kernel (``fold_kernel.py:435``, in interpret mode)."""
    p = _pieces(n, seed=30 + n)
    classes, grads = jdisp.make_class_grads(p["ts"], "auto")
    idx = jnt.feature_indices(p["ts"], jnp.asarray(p["cells"]))
    if fused:
        def fold(ts, c, pair):
            return fk.fold_class_pair(ts, c, pair, interpret=True)
    else:
        def fold(ts, c, pair):
            return jfold(ts, c.feat0, c.g, pair)
    want = _jax_tc_blocks(p["ts"], classes, grads, fold,
                          *_j(p["w"], p["e"], p["a"], p["alpha"]), idx,
                          *_j(p["dw"], p["valid"]))
    tclasses, tgrads = tdisp.make_class_grads(p["tts"], "auto")
    chain = (canon_script.blocks_fused_tc if fused
             else canon_script.blocks_fold_tc)
    got = chain(p["tts"], tclasses, tgrads,
                *_t(p["w"], p["e"], p["a"], p["alpha"]),
                torch.from_numpy(np.array(idx)), *_t(p["dw"], p["valid"]))
    _hold_tables(got, want, "class chain")
    assert not np.array_equal(got[0].numpy(), p["w"])


def _cidx(p):
    jc, _ = jcanon.canonical_gather_indices(p["ts"], jnp.asarray(p["cells"]))
    return np.asarray(jc)


def test_sparse_tc_matches_reference_lines(canon_script):
    p = _pieces(5, seed=40)
    ci = _cidx(p)
    want = _jax_sparse_tc(*_j(p["w"], p["e"], p["a"], p["alpha"], ci,
                              p["dw"], p["valid"]))
    tabs = _t(p["w"], p["e"], p["a"])
    got = canon_script.sparse_tc(*tabs, *_t(p["alpha"], ci, p["dw"],
                                            p["valid"]))
    assert got[0] is tabs[0]  # in place
    _hold_tables(got, want, "sparse_tc")


def test_entry_reduce_matches_reference_lines(canon_script):
    p = _pieces(5, seed=50)
    ci = _cidx(p)
    total = p["ts"].total
    keys = np.where(p["valid"][:, None], ci, total).reshape(-1)
    vals = np.broadcast_to(p["dw"][:, None], ci.shape).reshape(-1)
    want = _jax_entry_reduce(*_j(keys, vals), total)
    got = canon_script._entry_reduce(*_t(keys, vals), total)
    for name, g, w in zip(("tgt", "count", "ks"), (got[0], got[3], got[4]),
                          (want[0], want[3], want[4])):
        assert_eq(g, w, name)
    for name, g, w in zip(("seg_sum", "seg_abs"), got[1:3], want[1:3]):
        assert_close(g, w, name)
    assert (np.asarray(want[0]) == total).any()  # dropped keys


def test_dedup_tc_matches_reference_lines_and_sparse_tc(canon_script):
    p = _pieces(5, seed=60)
    ci = _cidx(p)
    total = p["ts"].total
    want = _jax_dedup_tc(total, *_j(p["w"], p["e"], p["a"], p["alpha"], ci,
                                    p["dw"], p["valid"]))
    args = _t(p["alpha"], ci, p["dw"], p["valid"])
    got = canon_script.dedup_tc(total, *_t(p["w"], p["e"], p["a"]), *args)
    _hold_tables(got, want, "dedup_tc")
    sparse = canon_script.sparse_tc(*_t(p["w"], p["e"], p["a"]), *args)
    _hold_tables(got, sparse, "dedup_tc against sparse_tc")


@pytest.mark.parametrize("n", [4, 5])
def test_actor_and_engine_bodies_match_reference_lines(canon_script, n):
    """``bench_canon_breakdown.py:231-235`` and ``:239-250``, the codes
    they carry; dyadic weights make every value exact, so the argmax
    takes the same move in both."""
    ts, tts = jnt.get_tuple_set(n), tnt.get_tuple_set(n)
    w = dyadic_weights(ts.total, seed=n)
    codes = _codes(64, seed=70 + n)
    jev = jdisp.make_evaluator(ts, "auto", canonical=True)
    tperm = jnp.asarray(np.arange(16).reshape(4, 4).T.reshape(16))

    def body_actor(cd, w):
        aft, delta, legal, _t = jfast.afterstates_full(cd)
        c4 = jfast.cells_from_codes(aft)
        c4 = jnp.stack([c4[0], c4[1][..., tperm], c4[2], c4[3][..., tperm]])
        vals = jev(w, c4)
        masked = jnp.where(legal, vals, -jnp.inf)
        bd = jnp.argmax(masked, axis=0).astype(jnp.int32)
        ar = jnp.arange(cd.shape[0])
        nc = jfast.canonicalize_chosen(aft[bd, ar], bd)
        return jnp.where(legal.any(0)[:, None], nc, cd)

    def body_engine(cd):
        aft, delta, legal, _t = jfast.afterstates_full(cd)
        return jnp.where(legal.any(0)[:, None], aft[0], cd)

    tev = tdisp.make_evaluator(tts, "auto", canonical=True)
    jc, tc = jnp.asarray(codes), torch.from_numpy(codes)
    for _ in range(3):
        jc = jax.jit(body_actor)(jc, jnp.asarray(w))
        tc = canon_script.actor(tev, torch.from_numpy(w), tc)
        assert_eq(tc, jc, "actor")
    assert_eq(torch_bench.first_move(tc), body_engine(jc), "engine")


# -- the scripts -------------------------------------------------------------

# runs a script as ``python script args`` would, then, if it exited 0,
# prints the jax and tpu2048 modules it loaded as the last line
_WRAP = """
import json, runpy, sys
script = sys.argv[1]
sys.argv = sys.argv[1:]
try:
    runpy.run_path(script, run_name="__main__")
except SystemExit as e:
    if e.code not in (None, 0):
        raise
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "tpu2048"))))
"""


@pytest.fixture(scope="module")
def script_runs(tmp_path_factory):
    """Every script at its tiny size with ``--device cpu``, all started
    at once: {script: (exit code, stdout lines, stderr)}."""
    cwd = str(tmp_path_factory.mktemp("scripts"))
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop("PYTHONPATH", None)
    procs = {s: subprocess.Popen(
        [sys.executable, "-c", _WRAP, os.path.join(REPO, "scripts", s),
         *map(str, args), "--device", "cpu"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for s, (_ref, args) in SCRIPTS.items()}
    out = {}
    try:
        for s, p in procs.items():
            stdout, stderr = p.communicate(timeout=LIMIT)
            out[s] = (p.returncode, stdout.splitlines(), stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return out


def _ran(script_runs, script):
    rc, lines, stderr = script_runs[script]
    assert rc == 0, stderr[-3000:]
    assert json.loads(lines[-1]) == [], f"{script} loaded {lines[-1]}"
    assert lines[0] == "cpu"
    return lines[1:-1]


@pytest.mark.parametrize("script", [
    "torch_bench_engine_breakdown.py", "torch_bench_train_breakdown.py",
    "torch_bench_canon_breakdown.py"])
def test_breakdown_runs_on_cpu_with_the_references_rows(script_runs,
                                                        script):
    lines = _ran(script_runs, script)
    labels, _rows = chip_smoke._row_labels(script, SCRIPTS[script][0],
                                           ["cpu"] + lines)
    assert len(labels) == len(_rows) >= 7
    # each row's launches and device time: not measured on the CPU
    for label in labels:
        assert any(ln.startswith(f"# {label}: launches and device us per ")
                   and ln.endswith("not measured (no card)")
                   for ln in lines), label
    if script == "torch_bench_canon_breakdown.py":
        assert [x for x in labels if x.startswith("eval[")] == [
            "eval[pallas canon=1] 4N", "eval[pallas canon=0] 4N",
            "eval[gather canon=1] 4N"]
        assert "scan: class chain FUSED fold" in labels
        assert "sparse gather-class TC" in labels


def test_smoke_holds_each_row_to_the_reference(script_runs):
    """``chip_smoke._breakdown_rows`` (phase 22) on the canonical twin's
    lines, its cost lines made to read as the card's: every row passes;
    a row left out, a row added, a non-finite number, a missing cost
    line or one that counts no launch fails."""
    script, ref = ("torch_bench_canon_breakdown.py",
                   SCRIPTS["torch_bench_canon_breakdown.py"][0])
    lines = ["NVIDIA H100 80GB HBM3, 700.00 W"] + [
        re.sub(r"launches and device us per (\w+) not measured \(no card\)",
               r"3.00 launches, 4.00 device us per \1", ln)
        for ln in _ran(script_runs, script)]
    rows = chip_smoke._breakdown_rows(script, ref, lines)
    assert len(rows) == 20 and "scan: class chain FUSED fold" in rows
    fused = next(ln for ln in lines
                 if ln.startswith("scan: class chain FUSED fold:"))
    merge = next(ln for ln in lines if ln.startswith("staged merge"))
    broken = [
        [ln for ln in lines if ln != fused],
        lines + ["extra row:     1.00 ms"],
        [ln.replace(ln.rsplit(": ", 1)[1], "  nan ms") if ln == merge
         else ln for ln in lines],
        [ln for ln in lines if not ln.startswith("# staged merge")],
        [ln.replace("3.00 launches", "0.00 launches")
         if ln.startswith("# afterstates_full") else ln for ln in lines],
    ]
    for bad in broken:
        with pytest.raises(AssertionError):
            chip_smoke._breakdown_rows(script, ref, bad)


def test_scaling_prints_the_references_keys(script_runs):
    """``bench_scaling.py:94-99``'s line at worlds 1 and 2."""
    lines = _ran(script_runs, "torch_bench_scaling.py")
    result = json.loads(lines[-1])
    assert list(result) == ["metric", "rows", "allreduce_mb_per_step",
                            "note"]
    assert result["metric"] == "virtual_mesh_partition_overhead"
    assert [list(r) for r in result["rows"]] == [
        ["devices", "env_steps_per_sec", "overhead_vs_1dev"]] * 2
    assert [r["devices"] for r in result["rows"]] == [1, 2]
    assert result["rows"][0]["overhead_vs_1dev"] == 1.0
    assert all(r["env_steps_per_sec"] > 0 for r in result["rows"])
    assert "CPU" in result["note"] and "TPU" not in result["note"]
    assert [ln.split(":")[0] for ln in lines[:-1]] == ["data=1", "data=2"]


def test_index_check_exact_with_and_without_tf32(script_runs):
    lines = _ran(script_runs, "torch_check_indices.py")
    rows = [ln for ln in lines if " n=" in ln]
    assert len(rows) == 12 and all(ln.endswith(" OK") for ln in rows)
    assert sum("tf32 allowed" in ln for ln in rows) == 6
    assert lines[-1] == ("all geometries exact on device, with and without "
                         "TF32")
    # every precision setting is back as it was
    assert torch.get_float32_matmul_precision() == "highest"


def test_index_check_exits_nonzero_on_a_mismatch(monkeypatch, capsys):
    mod = _load("torch_check_indices.py")
    real = mod.ntuple.feature_indices

    def off_by_one_at_n6(ts, boards):
        idx = real(ts, boards)
        return idx + 1 if ts.n == 6 else idx

    monkeypatch.setattr(mod.ntuple, "feature_indices", off_by_one_at_n6)
    assert mod.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "n=6: num_feat=33 table=95662848 mismatches=" in out
    assert "MISMATCH" in out and torch.get_float32_matmul_precision() == \
        "highest"


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_no_card_and_no_device_raises(monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _load(script).main([])


def test_scaling_nccl_needs_a_card_per_rank(monkeypatch):
    mod = _load("torch_bench_scaling.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(mod.torch_bench, "start",
                        lambda device, who: torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="one card per rank"):
        mod.main(["--backend", "nccl", "--worlds", "1", "2"])
