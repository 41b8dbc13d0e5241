"""Checkpoints: atomic, step-numbered, resumable.

A copy of ``repro.train.checkpoint`` (stdlib and numpy only; the port may
not import the JAX package), in two parts.

The LM trainer's step-numbered trees, in the JAX package's layout:

  <dir>/step_<N>/arrays.npz      the tree's leaves, ``leaf_<i>``
  <dir>/step_<N>/treedef.json    structure + shapes + dtypes (integrity check)
  <dir>/step_<N>/COMMITTED       written last: the commit marker

A tree is nested dicts, lists and tuples whose leaves are arrays (numpy or
torch); it flattens in ``jax.tree_util``'s order (a dict's keys sorted,
``None`` an empty subtree), so either package restores the other's
checkpoint of the same tree.

The forest trainer's streaming checkpoints: one ``batch_<b0>.npz`` per
trained batch of ensembles and a ``manifest.json`` of the committed
batches. The files and the manifest's fingerprint are the JAX package's,
so either package can resume the other's checkpoint of the same run. Every
update is write-temp-then-``os.replace`` with an fsync, so a crash between
writes always leaves a consistent (if slightly stale) manifest that a
resume can trust.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# step-numbered trees (the LM trainer's checkpoints)
# ---------------------------------------------------------------------------

def flatten(tree: Any) -> Tuple[List[Any], str]:
    """``(leaves, structure)`` in ``jax.tree_util.tree_flatten``'s order;
    ``structure`` is written as ``str`` of the JAX package's treedef."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def unflatten(tree_like: Any, leaves: List[Any]) -> Any:
    """``tree_like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree_like)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` as ``<directory>/step_<step>``: into a temporary
    directory first, the commit marker last, then one rename."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"step_{step}"
    tmp = Path(tempfile.mkdtemp(dir=d, prefix=f".tmp_step_{step}_"))
    leaves, structure = flatten(tree)
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)}
    np.savez(tmp / "arrays.npz", **arrays)
    meta = {"step": step, "treedef": structure,
            "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                       for a in arrays.values()]}
    (tmp / "treedef.json").write_text(json.dumps(meta))
    (tmp / "COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)       # atomic on the same filesystem
    return str(final)


def latest_step(directory: str) -> Optional[int]:
    """The largest committed step under ``directory`` (``None``: none)."""
    d = Path(directory)
    if not d.exists():
        return None
    steps = []
    for sub in d.iterdir():
        if sub.name.startswith("step_") and (sub / "COMMITTED").exists():
            try:
                steps.append(int(sub.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore(directory: str, tree_like: Any, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """``(tree, step)``: the checkpoint (the latest committed one by
    default) in ``tree_like``'s structure, numpy leaves, each checked
    against the shape of ``tree_like``'s leaf."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = Path(directory) / f"step_{step}"
    meta = json.loads((d / "treedef.json").read_text())
    protos, _ = flatten(tree_like)
    if len(protos) != len(meta["leaves"]):
        raise ValueError(f"checkpoint structure mismatch: {len(protos)} "
                         f"leaves expected, {d} has {len(meta['leaves'])}")
    out = []
    with np.load(d / "arrays.npz") as data:
        for i, proto in enumerate(protos):
            arr = data[f"leaf_{i}"]
            want = tuple(proto.shape) if hasattr(proto, "shape") else ()
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                                 f"expected {want}")
            out.append(arr)
    return unflatten(tree_like, out), step


def reshard(tree: Any, mesh, specs: Any) -> Any:
    """Elastic restore: place a tree of host arrays (numpy or torch, the
    same values on every rank: each restored the same checkpoint) onto a
    (possibly different) ``mesh`` as DTensors laid out by ``specs`` (the
    tree's structure, a spec of :mod:`repro_torch.sharding.rules` at each
    leaf). Each rank keeps its own shard: no scatter from rank 0."""
    from repro_torch.sharding.dtensor import distribute
    from repro_torch.sharding.rules import placements

    def put(x, spec):
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return distribute(t.to(mesh.device_type), mesh,
                          placements(spec, mesh))

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, s) for v, s in zip(node, spec))
        return put(node, spec)

    return walk(tree, specs)


# ---------------------------------------------------------------------------
# batch-grid manifest (the forest trainer's streaming checkpoints)
# ---------------------------------------------------------------------------

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
