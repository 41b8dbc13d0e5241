"""Build and load the ``tree_predict`` CUDA kernel.

``nvcc`` compiles ``csrc/tree_predict.cu`` for ``sm_90a`` into a shared
library with a plain C interface, loaded through ``ctypes``. The build runs
at first use, from the source in this package, into ``_build/`` beside it
(listed in ``.gitignore``); the library's name carries a hash of the source,
so an edited kernel is rebuilt and concurrent builds never see a partial
file. Nothing here runs at import: a host without ``nvcc`` imports the
package and uses the plain PyTorch path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "tree_predict.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install location."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to "
                       "build the tree_predict CUDA kernel")


def build() -> Tuple[str, str]:
    """Compile the kernel if this source has not been built yet.

    Returns ``(library path, compiler log)``; the log holds ``ptxas -v``'s
    registers and shared memory per kernel, and is empty when the library
    was already built.
    """
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"libtree_predict_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, lib)
    return lib, r.stdout + r.stderr


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every function's ``argtypes`` declared."""
    lib = ctypes.CDLL(build()[0])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tree_predict_launch.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.tree_predict_launch.restype = i32
    lib.tree_predict_rows_per_block.argtypes = []
    lib.tree_predict_rows_per_block.restype = i32
    lib.tree_predict_error_string.argtypes = [i32]
    lib.tree_predict_error_string.restype = ctypes.c_char_p
    return lib
