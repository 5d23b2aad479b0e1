"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``csrc/`` is compiled by its own ``nvcc``
process for ``sm_90a``, all started together, and the objects are
linked into one shared library with a plain C interface, loaded
through ``ctypes``.  The build runs at first use, from the sources in
the checkout only, into ``_build/`` beside this file (git-ignored).
The library's name carries a hash of the sources and the flags, so an
edit rebuilds it.  A missing ``nvcc`` or a failed build raises: there
is no fallback.  Threads of one process (the app's jobs) build and
bind the library once: the first build holds a module lock, and the
others wait for it and take its result.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> argtypes of each C entry point; all return an int (a
# cudaError_t; cuda_error_string a char*, grad_class_scratch_words a
# long long)
_ENTRY_POINTS = {
    # tables, round_bf16, hi, lo, out, B, G, H, L, stream
    "eval_class_launch": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    # hi, lo, dw, valid, pair, scratch, scratch words, B, G, H, L, stream
    "grad_class_launch": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # x, out, orbits, reps, n_orbits, R, G, k, stream
    "fold_class_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # key, per, valid, scratch, w, e, a, alpha, M, mean, tc, stream
    "cross_apply_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # codes, rows, per_slot, tmask, plan (host), idx, cidx, mult, stream
    "feature_index_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
}
# held by a build and by the first load: one nvcc run and one bound
# library per process, whichever threads ask at once
_LOCK = threading.RLock()
_LIBRARY: Optional[ctypes.CDLL] = None


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        p = Path(root, "bin", "nvcc")
        if root and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpu2048_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands concurrently; raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def build_library() -> Path:
    """Compile the kernels unless a library for these sources exists.
    ``nvcc``'s report (``-Xptxas=-v``: registers, spills) is kept
    beside the library as ``<name>.log``."""
    with _LOCK:
        out = _library_path()
        if out.exists():
            return out
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build in a temporary directory and rename the library, so a
        # concurrent or cut build never leaves a half-written one under
        # the final name
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp, src.stem + ".o") for src in _sources()]
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                            for s, o in zip(_sources(), objs)])
            lib = Path(tmp, out.name)
            log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(lib),
                              *map(str, objs)]])
            out.with_suffix(".log").write_text(log)
            os.replace(lib, out)
        return out


def load_library() -> ctypes.CDLL:
    """The kernels' library, built at the first call and bound once."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            lib.grad_class_scratch_words.argtypes = [_I, _I, _I]
            lib.grad_class_scratch_words.restype = _L
            lib.feature_index_plan_words.argtypes = []
            lib.feature_index_plan_words.restype = _I
            _LIBRARY = lib
        return _LIBRARY
