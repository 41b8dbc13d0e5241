"""Streaming checkpoints of the forest trainer: one ``batch_<b0>.npz`` per
trained batch of ensembles and a ``manifest.json`` of the committed batches.

A copy of the batch-grid part of ``repro.train.checkpoint`` (stdlib and
numpy only; the port may not import the JAX package). The files and the
manifest's fingerprint are the JAX package's, so either package can resume
the other's checkpoint of the same run. Every update is
write-temp-then-``os.replace`` with an fsync, so a crash between writes
always leaves a consistent (if slightly stale) manifest that a resume can
trust.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional, Tuple

import numpy as np


def describe_fingerprint_mismatch(stale, new, *, stale_name: str = "on-disk",
                                  new_name: str = "requested") -> str:
    """Human-readable diff of two fingerprint dicts: every differing key
    with both values, then both full fingerprints, so an operator never has
    to open the manifest to see *what* mismatched."""
    stale = stale or {}
    new = new or {}
    lines = [f"  {k}: {stale_name}={stale.get(k)!r} != "
             f"{new_name}={new.get(k)!r}"
             for k in sorted(set(stale) | set(new))
             if stale.get(k) != new.get(k)]
    return ("differing keys:\n" + "\n".join(lines)
            + f"\n{stale_name} fingerprint: {json.dumps(stale, sort_keys=True)}"
            + f"\n{new_name} fingerprint: {json.dumps(new, sort_keys=True)}")


# ---------------------------------------------------------------------------
# batch-grid manifest (the forest trainer's streaming checkpoints)
# ---------------------------------------------------------------------------

def _fsync_replace(tmp: str, final: str) -> None:
    """``os.replace`` with the data already on disk: fsync the temp file,
    rename, then fsync the directory entry. A crash at any point leaves
    either the old complete file or the new complete file — never a
    truncated one the manifest could be tricked into trusting."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, final)
    dfd = os.open(os.path.dirname(final) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def write_batch_npz(directory: str, b0: int, arrays: dict) -> str:
    """Atomically write one trained ensemble batch (``batch_<b0>.npz``)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"batch_{b0}.npz")
    tmp = os.path.join(directory, f".tmp_batch_{b0}.npz")
    np.savez(tmp, **arrays)
    _fsync_replace(tmp, final)
    return final


def read_batch_npz(directory: str, b0: int) -> dict:
    """Load one committed ensemble batch back as ``{field: np.ndarray}``."""
    with np.load(os.path.join(directory, f"batch_{b0}.npz")) as data:
        return {k: data[k] for k in data.files}


class GridManifest:
    """Which ensemble batches of a (timestep, class) grid are complete.

    The manifest pins the full run fingerprint (config, grid layout, batch
    size, data shape — see ``_manifest_fingerprint`` in
    :mod:`repro_torch.tabgen.fitting`) and the set of committed ``(b0, len)``
    batch keys. :meth:`load_done` refuses to resume under a mismatched
    fingerprint, so stale ``batch_*.npz`` files never mix silently with
    fresh ones.

    Warm-start mode: ``warm_base`` describes the *base* run of a
    warm-start extension (``{"config": <base ForestConfig asdict>, "grid":
    [n_t, n_y]}``). A checkpoint dir whose manifest matches ``warm_base``
    on those keys is accepted with an empty done-set instead of refused:
    the extension retrains every batch (its round buffers are wider than
    the base's, so the base ``batch_*.npz`` files aren't reusable) and
    overwrites them in place, rewriting the manifest under the new
    fingerprint on the first :meth:`mark_done`. Batch size / data shape
    are deliberately not matched — an extension may run with a different
    batching and typically fits *more* rows than the base did.

    Thread-safe: :meth:`mark_done` may be called from a writer thread
    while another thread trains later batches. A lock serialises updates, each update rewrites the whole
    manifest to a temp file and ``os.replace``s it with fsyncs, and a batch
    is only ever marked done *after* its ``batch_*.npz`` is durably
    committed — so every state a crash can expose resumes correctly.
    """

    def __init__(self, directory: str, fingerprint: dict,
                 warm_base: Optional[dict] = None):
        self.directory = directory
        self.path = os.path.join(directory, "manifest.json")
        self.fingerprint = fingerprint
        self.warm_base = warm_base
        self._lock = threading.Lock()
        self._done: set = set()

    def _is_warm_base(self, stale: Optional[dict]) -> bool:
        """Does the on-disk manifest belong to this extension's base run?"""
        if self.warm_base is None or not stale:
            return False
        # config (incl. the base's n_trees) + grid is the whole match: an
        # extension may batch differently and usually fits more rows, and a
        # base that was itself warm-started is still a valid base
        return (stale.get("config") == self.warm_base.get("config")
                and stale.get("grid") == self.warm_base.get("grid"))

    def load_done(self, resume: bool) -> set:
        """The committed batch keys; refuses mismatched-fingerprint resume."""
        if resume and os.path.exists(self.path):
            with open(self.path) as f:
                manifest = json.load(f)
            stale = manifest.get("fingerprint")
            if stale == self.fingerprint:
                done = set(tuple(e) for e in manifest["batches"])
                with self._lock:
                    self._done = done
            elif self._is_warm_base(stale):
                # fingerprint-compatible base checkpoint: accept, but no
                # batch is reusable (base files hold fewer-round buffers) —
                # the extension overwrites them all
                with self._lock:
                    self._done = set()
            else:
                raise ValueError(
                    f"checkpoint at {self.directory} was written under a "
                    "mismatched run configuration; resuming would mix stale "
                    "batch_*.npz files with new ones. Pass resume=False "
                    "(or a fresh checkpoint_dir) to retrain.\n"
                    + describe_fingerprint_mismatch(
                        stale, self.fingerprint, stale_name="checkpoint",
                        new_name="requested"))
        with self._lock:
            return set(self._done)

    def mark_done(self, key: Tuple[int, int]) -> None:
        """Durably record ``key = (b0, n_ensembles)`` as committed."""
        with self._lock:
            self._done.add(key)
            os.makedirs(self.directory, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"fingerprint": self.fingerprint,
                           "batches": sorted(self._done)}, f)
            _fsync_replace(tmp, self.path)
