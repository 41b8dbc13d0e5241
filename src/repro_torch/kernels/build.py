"""Build and load the port's CUDA kernels.

Each kernel ``<name>`` has one source, ``<name>/csrc/<name>.cu``, with a
plain C interface. ``nvcc`` compiles it for ``sm_90a`` into a shared library
that ``ctypes`` loads. The build runs at first use, from the sources in this
package, into ``<name>/_build/`` (listed in ``.gitignore``); the library's
name carries a hash of the source and the flags, so an edited kernel is
rebuilt and concurrent builds never see a partial file. Nothing here runs
at import: a host without ``nvcc`` imports the package and uses the plain
PyTorch path.

:func:`build` starts one ``nvcc`` per source, all at once, and waits for
all of them, so building every kernel takes as long as the slowest one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def source(name: str) -> str:
    return os.path.join(_HERE, name, "csrc", f"{name}.cu")


def build_dir(name: str) -> str:
    return os.path.join(_HERE, name, "_build")


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
                       "build the port's CUDA kernels")


def library_path(name: str) -> str:
    with open(source(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(name),
                        f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> Dict[str, Tuple[str, str]]:
    """Compile every kernel in ``names`` whose source has not been built yet,
    one ``nvcc`` each, all started together.

    Returns ``{name: (library path, compiler log)}``; a log holds ``ptxas
    -v``'s registers and shared memory per kernel, and is empty when the
    library was already built.
    """
    done, running = {}, {}
    for name in names:
        lib = library_path(name)
        if os.path.exists(lib):
            done[name] = (lib, "")
            continue
        os.makedirs(build_dir(name), exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (lib, tmp, cmd, proc)
    failed = []
    for name, (lib, tmp, cmd, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{log}")
            continue
        os.replace(tmp, lib)
        done[name] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (built first if needed), with
    ``<name>_error_string`` declared. Each wrapper declares its own launch
    functions' ``argtypes``."""
    lib = ctypes.CDLL(build([name])[name][0])
    fn = getattr(lib, f"{name}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = getattr(load(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")
