"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded
through ``ctypes``.  The build runs at first use, from the sources in
the checkout only, into ``_build/`` beside this file (git-ignored).
The library's name carries a hash of the sources and the flags, so an
edit rebuilds it.  A missing ``nvcc`` or a failed build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import List

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]


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


def build_library() -> Path:
    """Compile the kernels unless a library for these sources exists.
    ``nvcc``'s report (``-Xptxas=-v``: registers, spills) is kept
    beside the library as ``<name>.log``."""
    out = _library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename, so a concurrent or cut
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.eval_class_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.eval_class_launch.restype = ctypes.c_int
    lib.eval_class_error_string.argtypes = [ctypes.c_int]
    lib.eval_class_error_string.restype = ctypes.c_char_p
    return lib
