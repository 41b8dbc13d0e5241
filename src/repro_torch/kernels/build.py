"""Build and load the port's CUDA kernels.

Each kernel ``<name>`` has one translation unit, ``<name>/csrc/<name>.cu``,
with a plain C interface; it may include headers beside it in ``csrc/``.
``nvcc`` compiles it for ``sm_90a`` into a shared library that ``ctypes``
loads. The build runs at first use, from the sources in this package, into
``<name>/_build/`` (listed in ``.gitignore``); the library's name carries a
hash of every file under ``csrc/`` and the flags, so an edited kernel or
header is rebuilt and concurrent builds never see a partial file. Nothing here runs
at import: a host without ``nvcc`` imports the package and uses the plain
PyTorch path.

:func:`build` starts one ``nvcc`` per source, all at once, and waits for
all of them, so building every kernel takes as long as the slowest one.

Threads share one lock over building and loading: two threads that reach a
kernel first at the same moment (an HTTP thread imputing while the serving
scheduler dispatches) build it once, and the second loads what the first
built. Temp files carry the process and thread id besides. The wrappers
count their launches through :func:`count_launch`, under a lock of its own
(a CUDA graph's capture records them, and each replay adds them);
:func:`tallied_launches` also tallies those of one thread's block, such as
one generate call's solve.
:func:`events` counts the ``nvcc`` runs and the libraries loaded, per
kernel (:mod:`repro_torch.analysis.runtime` budgets them over a region).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
# one lock over build() and load(): a kernel builds once per process
_BUILD_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()
# ("build" | "load", kernel name) -> count in this process, under _BUILD_LOCK
_EVENTS: collections.Counter = collections.Counter()
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


def sources(name: str) -> List[str]:
    """Every file under the kernel's ``csrc/``, sorted: what a build reads."""
    root = os.path.dirname(source(name))
    return sorted(os.path.join(d, f) for d, _, files in os.walk(root)
                  for f in files)


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    root = os.path.dirname(source(name))
    for path in sources(name):
        digest.update(os.path.relpath(path, root).encode() + b"\0")
        with open(path, "rb") as f:
            digest.update(f.read() + b"\0")
    return os.path.join(build_dir(name),
                        f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> Dict[str, Tuple[str, str]]:
    """Compile every kernel in ``names`` whose source has not been built yet,
    one ``nvcc`` each, all started together.

    Returns ``{name: (library path, compiler log)}``; a log holds ``ptxas
    -v``'s registers and shared memory per kernel, and is empty when the
    library was already built.
    """
    with _BUILD_LOCK:
        return _build(names)


def _build(names: Sequence[str]) -> Dict[str, Tuple[str, str]]:
    done, running = {}, {}
    for name in names:
        lib = library_path(name)
        if os.path.exists(lib):
            done[name] = (lib, "")
            continue
        os.makedirs(build_dir(name), exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        _EVENTS["build", name] += 1
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


def open_library(path: str, name: str) -> ctypes.CDLL:
    """Load a built library of kernel ``name`` and declare its
    ``<name>_error_string``."""
    lib = ctypes.CDLL(path)
    fn = getattr(lib, f"{name}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    lib = open_library(build([name])[name][0], name)
    _EVENTS["load", name] += 1
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (built first if needed), with
    ``<name>_error_string`` declared. Each wrapper declares its own launch
    functions' ``argtypes``. ``load.cache_info()`` counts the libraries
    loaded (misses) and the calls that found one (hits)."""
    with _BUILD_LOCK:
        return _load(name)


load.cache_info = _load.cache_info


def events() -> collections.Counter:
    """A copy of the counts of ``("build", name)`` (an ``nvcc`` started)
    and ``("load", name)`` (a library opened) so far in this process."""
    with _BUILD_LOCK:
        return collections.Counter(_EVENTS)


def count_launch(wrapper, *also: str) -> None:
    """Add one to ``wrapper.launches``, the launch count of a kernel's
    wrapper, and one to each counter named in ``also`` (a kind of launch)
    each time it is named, under a lock: the wrappers are called from many
    threads. Inside :func:`recorded_launches` this thread's launches are
    recorded there instead; inside :func:`tallied_launches` they are
    tallied there too."""
    rec = getattr(_RECORDING, "counts", None)
    if rec is not None:
        for name in ("launches",) + also:
            rec[wrapper, name] += 1
        return
    with _COUNT_LOCK:
        wrapper.launches += 1
        for name in also:
            setattr(wrapper, name, getattr(wrapper, name) + 1)
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        for name in ("launches",) + also:
            tally[wrapper, name] += 1


_RECORDING = threading.local()
_TALLY = threading.local()


@contextlib.contextmanager
def recorded_launches():
    """Within the block, :func:`count_launch` on this thread adds to the
    yielded ``Counter`` of ``(wrapper, counter name)`` and not to the
    counters. A CUDA graph's capture runs no kernel, so it records its
    launches; each replay runs them and adds them (:func:`add_launches`)."""
    counts = _RECORDING.counts = collections.Counter()
    try:
        yield counts
    finally:
        _RECORDING.counts = None


@contextlib.contextmanager
def tallied_launches():
    """Within the block, the launches this thread adds to the counters
    (:func:`count_launch`, and a replay's :func:`add_launches`) are also
    added to the yielded ``Counter`` of ``(wrapper, counter name)``, so a
    caller can say what one piece of its work launched while other threads
    launch too. A capture's recorded launches, which run nothing, are not
    tallied."""
    outer = getattr(_TALLY, "counts", None)
    counts = _TALLY.counts = collections.Counter()
    try:
        yield counts
    finally:
        _TALLY.counts = outer


def add_launches(counts) -> None:
    """Add a :func:`recorded_launches` count to the counters, under the
    lock of :func:`count_launch`, and to this thread's
    :func:`tallied_launches`."""
    with _COUNT_LOCK:
        for (wrapper, name), k in counts.items():
            setattr(wrapper, name, getattr(wrapper, name) + k)
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        tally.update(counts)


def check_launch(name: str, rc: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = getattr(load(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")
