"""Native host engine: C++ row-LUT engine + n-tuple eval + expectimax
(``tpu2048/native``: the same code; ``tests/test_torch_shared.py``
holds the two equal).

The device path (the port's CUDA kernels) owns bulk compute; this
module owns the latency-sensitive host loops: interactive play, live
watch frames, replay verification, and deep single-board expectimax —
where abachurin/2048 spent ~1 s/move in recursive Python
(``game2048/game_logic.py:214-243``, ``README.md:145`` there).

The shared library is compiled from ``engine2048.cpp`` with g++ on
first use and cached next to the source (or in $TPU2048_NATIVE_DIR).
Everything degrades gracefully: ``available()`` is False when no
compiler/toolchain exists and callers fall back to the numpy paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = Path(__file__).with_name("engine2048.cpp")


def _build_dir() -> Path:
    d = os.environ.get("TPU2048_NATIVE_DIR")
    return Path(d) if d else _SRC.parent


def _compile() -> Optional[Path]:
    out = _build_dir() / "libengine2048.so"
    if out.exists() and out.stat().st_mtime >= _SRC.stat().st_mtime:
        return out
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        str(_SRC), "-o", str(out),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _compile()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        c = ctypes
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.build_luts.restype = None
        lib.apply_move.argtypes = [i8p, c.c_int32, c.POINTER(c.c_uint8)]
        lib.apply_move.restype = c.c_int32
        lib.count_empty.argtypes = [i8p]
        lib.count_empty.restype = c.c_int32
        lib.game_over.argtypes = [i8p]
        lib.game_over.restype = c.c_uint8
        lib.spawn.argtypes = [i8p, c.POINTER(c.c_uint32),
                              c.POINTER(c.c_int32)]
        lib.spawn.restype = c.c_int32
        spec = [i8p, f32p, c.c_int32, i32p, i32p, i32p, i64p]
        lib.eval_board.argtypes = spec
        lib.eval_board.restype = c.c_float
        lib.expectimax.argtypes = spec + [
            c.c_int32, c.c_int32, c.c_int32, c.POINTER(c.c_uint32)
        ]
        lib.expectimax.restype = c.c_float
        lib.best_move.argtypes = spec + [
            c.c_int32, c.c_int32, c.c_int32, c.POINTER(c.c_uint32),
            c.POINTER(c.c_int32),
        ]
        lib.best_move.restype = c.c_int32
        lib.play_game.argtypes = spec + [
            c.c_int32, c.c_int32, c.c_int32, c.POINTER(c.c_uint32),
            c.POINTER(c.c_int32),
        ]
        lib.play_game.restype = c.c_int64
        lib.build_luts()
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


class TupleSpecC:
    """Flattened n-tuple geometry for the C ABI."""

    def __init__(self, ts):
        from ..features.ntuple import _cell_tuples

        tuples = _cell_tuples(ts.n)
        nf = len(tuples)
        cells = np.full((nf, 6), -1, np.int32)
        lens = np.zeros(nf, np.int32)
        bases = np.zeros(nf, np.int32)
        for f, (cs, base) in enumerate(tuples):
            lens[f] = len(cs)
            bases[f] = base
            for j, (i, jj) in enumerate(cs):
                cells[f, j] = i * 4 + jj
        self.num_feat = nf
        self.cells = np.ascontiguousarray(cells.reshape(-1))
        self.lens = np.ascontiguousarray(lens)
        self.bases = np.ascontiguousarray(bases)
        self.offsets = np.ascontiguousarray(ts.offsets.astype(np.int64))


class NativeEngine:
    """Thin OO wrapper over the C ABI, one instance per session."""

    def __init__(self, ts=None, weights: Optional[np.ndarray] = None,
                 seed: int = 0):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native engine unavailable (no g++?)")
        self._rng = ctypes.c_uint32(seed or 0x9E3779B9)
        self._spec = TupleSpecC(ts) if ts is not None else None
        self._w = (
            np.ascontiguousarray(weights, np.float32)
            if weights is not None else None
        )

    # -- engine ----------------------------------------------------------
    def apply_move(self, board: np.ndarray, direction: int
                   ) -> Tuple[np.ndarray, int, bool]:
        b = np.ascontiguousarray(board.reshape(16), np.int8).copy()
        ch = ctypes.c_uint8(0)
        delta = self._lib.apply_move(b, direction, ctypes.byref(ch))
        changed = bool(ch.value)
        return b.reshape(4, 4), (delta if changed else 0), changed

    def spawn(self, board: np.ndarray) -> Tuple[np.ndarray, int, int]:
        b = np.ascontiguousarray(board.reshape(16), np.int8).copy()
        val = ctypes.c_int32(0)
        pos = self._lib.spawn(b, ctypes.byref(self._rng),
                              ctypes.byref(val))
        return b.reshape(4, 4), int(pos), int(val.value)

    def game_over(self, board: np.ndarray) -> bool:
        b = np.ascontiguousarray(board.reshape(16), np.int8)
        return bool(self._lib.game_over(b))

    # -- model -----------------------------------------------------------
    def _args(self, board: np.ndarray):
        assert self._spec is not None and self._w is not None
        b = np.ascontiguousarray(board.reshape(16), np.int8)
        s = self._spec
        return (b, self._w, s.num_feat, s.cells, s.lens, s.bases,
                s.offsets)

    def evaluate(self, board: np.ndarray) -> float:
        return float(self._lib.eval_board(*self._args(board)))

    def expectimax(self, board: np.ndarray, depth: int, width: int,
                   since_empty: int) -> float:
        return float(self._lib.expectimax(
            *self._args(board), depth, width, since_empty,
            ctypes.byref(self._rng)))

    def best_move(self, board: np.ndarray, depth: int = 0, width: int = 1,
                  since_empty: int = 6
                  ) -> Tuple[int, np.ndarray, int]:
        """Returns (direction or -1, afterstate board, score delta)."""
        b = np.ascontiguousarray(board.reshape(16), np.int8).copy()
        s = self._spec
        delta = ctypes.c_int32(0)
        d = self._lib.best_move(
            b, self._w, s.num_feat, s.cells, s.lens, s.bases, s.offsets,
            depth, width, since_empty, ctypes.byref(self._rng),
            ctypes.byref(delta))
        return int(d), b.reshape(4, 4), int(delta.value)

    def play_game(self, board: Optional[np.ndarray] = None,
                  depth: int = 0, width: int = 1, since_empty: int = 6
                  ) -> Tuple[int, int, np.ndarray]:
        """Play one full game natively; returns (score, moves, final)."""
        if board is None:
            b = np.zeros(16, np.int8)
            self._lib.spawn(b, ctypes.byref(self._rng), None)
            self._lib.spawn(b, ctypes.byref(self._rng), None)
        else:
            b = np.ascontiguousarray(board.reshape(16), np.int8).copy()
        s = self._spec
        moves = ctypes.c_int32(0)
        score = self._lib.play_game(
            b, self._w, s.num_feat, s.cells, s.lens, s.bases, s.offsets,
            depth, width, since_empty, ctypes.byref(self._rng),
            ctypes.byref(moves))
        return int(score), int(moves.value), b.reshape(4, 4)
