"""ForestArtifacts: the trained model as a dataclass of tensors on one device.

Everything a sampler needs, resident on the device once:

* the stacked packed forests ``[n_t, n_y, n_sub, T, ...]`` (all timesteps,
  all classes),
* per-class min/max scalers ``[n_y, p]``,
* the class table and empirical counts for label sampling (host arrays),
* early-stopping diagnostics (``best_round`` / ``val_curve``),
* the :class:`ForestConfig` and the data lineage.

:meth:`ForestArtifacts.shard` gives one rank's slice for sampling on a
``(data, model)`` mesh of ranks: the classes :func:`solve_axes` puts on
that rank, on its device, with the class range recorded.

``save``/``load`` use the JAX package's format unchanged — one ``.npz`` of
the ``_ARRAY_FIELDS`` plus a JSON sidecar with the config, lineage and any
extra metadata such as a schema — so a model trained by the JAX trainer
loads here and a model saved here loads there.
:func:`artifacts_from_numpy` carries an in-memory JAX model across.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ForestConfig
from repro_torch.forest.packed import PackedForest
from repro_torch.kernels.dispatch import Device, resolve_device

FORMAT_VERSION = 1

RESULT_FIELDS = ("feat", "thr_val", "leaf", "best_round", "rounds_run",
                 "val_curve")
_TENSOR_FIELDS = RESULT_FIELDS + ("mins", "maxs")
_ARRAY_FIELDS = _TENSOR_FIELDS + ("classes", "counts")
_DTYPES = {"feat": np.int32, "best_round": np.int32, "rounds_run": np.int32}


def solve_axes(mesh, n_y: int, model_axis: str = "model"):
    """(class dimension | None, row dimensions | None) of a sharded solve:
    the placement policy shared by :meth:`ForestArtifacts.shard` and the
    sharded solve of :mod:`repro_torch.tabgen.sampling` (the JAX package's
    ``solve_axes``). Classes go over ``model_axis`` only when they divide
    it evenly (a 3-class model on two model ranks is replicated over
    them); rows go over the other dimensions (``data``)."""
    names = tuple(mesh.mesh_dim_names or ())
    sizes = dict(zip(names, mesh.shape))
    model = (model_axis if model_axis in sizes
             and n_y % sizes[model_axis] == 0 else None)
    rows = tuple(a for a in names if a != model_axis) or None
    return model, rows


def class_span(mesh, n_y: int) -> Tuple[int, int]:
    """``[c0, c1)``: the classes this rank of ``mesh`` solves, by
    :func:`solve_axes` (all of them where classes are replicated)."""
    model, _ = solve_axes(mesh, n_y)
    if model is None:
        return 0, n_y
    k = n_y // mesh.size(mesh.mesh_dim_names.index(model))
    r = mesh.get_local_rank(model)
    return r * k, (r + 1) * k


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current GPU, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def scaler_span(mins, maxs):
    """``max - min`` with degenerate columns (max <= min) pinned to 1 — the
    per-class scaler convention shared by fit, sample and impute."""
    return torch.where(maxs > mins, maxs - mins, torch.ones_like(mins))


def rescale(x, mins, maxs):
    """Data space -> model space [-1, 1]."""
    return (x - mins) / scaler_span(mins, maxs) * 2.0 - 1.0


def unscale(x, mins, maxs):
    """Model space [-1, 1] -> data space."""
    return (x + 1.0) / 2.0 * scaler_span(mins, maxs) + mins


def scaler_span_host(mins, maxs):
    """:func:`scaler_span` on numpy arrays, in the JAX package's bool
    arithmetic: ``1 - gt`` is int64 there, so the span (and what it scales)
    is float64."""
    gt = maxs > mins
    return (maxs - mins) * gt + (1 - gt)


def unscale_host(x, mins, maxs):
    """:func:`unscale` on numpy arrays (float64 out, as the JAX package's)."""
    return (x + 1.0) / 2.0 * scaler_span_host(mins, maxs) + mins


def _validate(arrays: dict, config: ForestConfig) -> None:
    """Host-side checks of arrays that arrive from outside the program. The
    tree kernel reads ``x[row, feat[h]]`` unchecked, so every feature index
    must lie in ``[0, p)``."""
    feat, leaf, mins = arrays["feat"], arrays["leaf"], arrays["mins"]
    if feat.ndim != 5 or leaf.ndim != 6 or mins.ndim != 2:
        raise ValueError(
            f"expected feat [n_t,n_y,n_sub,T,H], leaf [...,L,out], mins "
            f"[n_y,p]; got {feat.shape}, {leaf.shape}, {mins.shape}")
    depth = config.max_depth
    if (feat.shape[-1] != 2 ** depth - 1 or leaf.shape[-2] != 2 ** depth
            or arrays["thr_val"].shape != feat.shape
            or leaf.shape[:4] != feat.shape[:4]):
        raise ValueError(f"forest arrays do not match max_depth={depth}: "
                         f"feat {feat.shape}, leaf {leaf.shape}")
    p = mins.shape[1]
    if feat.size and (feat.min() < 0 or feat.max() >= p):
        raise ValueError(f"feature indices outside [0, {p})")


@dataclasses.dataclass
class ForestArtifacts:
    feat: torch.Tensor        # [n_t, n_y, n_sub, T, H] int32
    thr_val: torch.Tensor     # [n_t, n_y, n_sub, T, H] fp32
    leaf: torch.Tensor        # [n_t, n_y, n_sub, T, L, out] fp32
    best_round: torch.Tensor  # [n_t, n_y, n_sub] int32
    rounds_run: torch.Tensor  # [n_t, n_y, n_sub] int32
    val_curve: torch.Tensor   # [n_t, n_y, n_sub, T] fp32
    mins: torch.Tensor        # [n_y, p] fp32 per-class scaler lows
    maxs: torch.Tensor        # [n_y, p] fp32 per-class scaler highs
    classes: np.ndarray       # [n_y] original label values (host)
    counts: np.ndarray        # [n_y] class counts (host)
    config: ForestConfig
    # data lineage ({"rows", "store", "base"}), carried through the sidecar
    lineage: Optional[dict] = None
    # a slice from shard(): the classes [c0, c1) its tensors hold of the
    # model's len(classes); None for the whole model
    class_range: Optional[Tuple[int, int]] = None

    # -- shape helpers ------------------------------------------------------

    @property
    def n_t(self) -> int:
        return self.feat.shape[0]

    @property
    def n_y(self) -> int:
        """Classes of the model (of the whole model, for a slice)."""
        if self.class_range is None:
            return self.feat.shape[1]
        return len(self.counts)

    @property
    def local_classes(self) -> Tuple[int, int]:
        """``[c0, c1)``: the classes whose tensors this object holds."""
        return self.class_range or (0, self.feat.shape[1])

    @property
    def is_slice(self) -> bool:
        """Whether this object lacks some of the model's classes."""
        return self.local_classes != (0, self.n_y)

    def _require_whole(self, what: str) -> None:
        if self.is_slice:
            c0, c1 = self.local_classes
            raise ValueError(
                f"{what} needs the whole model; these artifacts are a slice "
                f"holding classes [{c0}, {c1}) of {self.n_y} (from shard())")

    def class_tensors(self, c0: int, c1: int):
        """``(feat, thr_val, leaf, mins, maxs)`` of classes ``[c0, c1)``:
        views of the resident tensors, no copy."""
        a, b = self.local_classes
        if not a <= c0 <= c1 <= b:
            raise ValueError(
                f"classes [{c0}, {c1}) are not all in these artifacts, which "
                f"hold [{a}, {b}) of {self.n_y}")
        i, j = c0 - a, c1 - a
        return (self.feat[:, i:j], self.thr_val[:, i:j], self.leaf[:, i:j],
                self.mins[i:j], self.maxs[i:j])

    @property
    def p(self) -> int:
        return self.mins.shape[1]

    @property
    def device(self) -> torch.device:
        return self.feat.device

    def class_forest(self, yi: int) -> PackedForest:
        """Forest stack ``[n_t, 1, n_sub, ...]`` of class ``yi``: a batch of
        one class, a view of the resident arrays."""
        feat, thr_val, leaf, _, _ = self.class_tensors(yi, yi + 1)
        return PackedForest(feat, thr_val, leaf, self.config.multi_output)

    def trees_at_best_iteration(self) -> np.ndarray:
        """Paper Fig. 3: trees kept per timestep (mean over y, sub)."""
        self._require_whole("trees_at_best_iteration")
        return np.mean(self.best_round.cpu().numpy() + 1, axis=(1, 2))

    def shard(self, mesh) -> "ForestArtifacts":
        """This rank's slice for sampling on ``mesh``: the classes
        :func:`class_span` gives it (all of them where classes are
        replicated), on the rank's device on the mesh, with the class range
        recorded. Rows are split inside the solve. A serving host places
        this once at promotion, so repeated
        :func:`~repro_torch.tabgen.sample` calls on the mesh move no
        weights. From pinned memory the copies of a whole-class slice are
        asynchronous."""
        device = mesh_device(mesh)
        c0, c1 = class_span(mesh, self.n_y)
        tensors = dict(zip(("feat", "thr_val", "leaf", "mins", "maxs"),
                           self.class_tensors(c0, c1)))
        i = c0 - self.local_classes[0]
        for f in ("best_round", "rounds_run", "val_curve"):
            tensors[f] = getattr(self, f)[:, i:i + c1 - c0]
        whole = (c0, c1) == self.local_classes

        def place(t):
            # a narrowed host tensor is strided: make it contiguous on the
            # host first, then copy it
            return (t if whole else t.contiguous()).to(device,
                                                      non_blocking=whole)
        return dataclasses.replace(
            self, class_range=(c0, c1),
            **{f: place(t) for f, t in tensors.items()})

    def extend(self, X, y=None, *, extra_trees: int, **kwargs):
        """Warm-start continuation: grow every ensemble by ``extra_trees``
        boosting rounds, reusing this model's scalers and seeded from its
        trees. Bit-identical to a cold fit run straight to ``n_trees +
        extra_trees`` on the same data. A delegate to
        :func:`repro_torch.tabgen.fitting.extend_artifacts` (imported here:
        fitting imports this module)."""
        from repro_torch.tabgen.fitting import extend_artifacts
        return extend_artifacts(self, X, y, extra_trees=extra_trees,
                                **kwargs)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_grid_results(cls, results: dict, n_t: int, n_y: int, mins, maxs,
                          classes, counts, config: ForestConfig,
                          device: Optional[Device] = None
                          ) -> "ForestArtifacts":
        """Stack per-ensemble fit outputs into artifacts.

        ``results`` maps ``(ti, yi)`` to ``{field: np.ndarray}``, one
        ensemble's :data:`RESULT_FIELDS`; they are stacked to ``[n_t, n_y,
        ...]`` on the host and moved to ``device`` once.
        """
        def stack(field):
            return np.stack([
                np.stack([results[(ti, yi)][field] for yi in range(n_y)])
                for ti in range(n_t)])

        forests = {k: stack(k) for k in RESULT_FIELDS}
        return cls.from_fit(forests, mins, maxs, classes, counts, config,
                            device)

    @classmethod
    def from_fit(cls, forests: dict, mins, maxs, classes, counts,
                 config: ForestConfig, device: Optional[Device] = None
                 ) -> "ForestArtifacts":
        """Bundle host fit outputs; the tensors go to ``device`` (``None``:
        the GPU, or raise) once, here."""
        arrays = dict(forests, mins=mins, maxs=maxs, classes=classes,
                      counts=counts)
        return artifacts_from_numpy(arrays, dataclasses.asdict(config),
                                    device)

    def to(self, device: Device, *, non_blocking: bool = False
           ) -> "ForestArtifacts":
        """The same model with every tensor on ``device``. From pinned host
        memory, ``non_blocking=True`` enqueues the copies and returns."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device, non_blocking=non_blocking)
            for f in _TENSOR_FIELDS})

    def pin_memory(self) -> "ForestArtifacts":
        """The same model with every tensor in pinned host memory (one
        copy, from the host or a device), so that a later ``to("cuda",
        non_blocking=True)`` is one asynchronous copy at the link's rate."""
        def pinned(t):
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t)
        return dataclasses.replace(self, **{
            f: pinned(getattr(self, f)) for f in _TENSOR_FIELDS})

    # -- persistence --------------------------------------------------------

    def save(self, path: str, extra_meta: Optional[dict] = None) -> str:
        """Write ``<path>.npz`` (arrays) + ``<path>.json`` (config + meta).
        Returns the base path."""
        self._require_whole("save")
        base = path[:-4] if path.endswith(".npz") else path
        d = os.path.dirname(base)
        if d:
            os.makedirs(d, exist_ok=True)
        arrays = {f: getattr(self, f).cpu().numpy() for f in _TENSOR_FIELDS}
        arrays["classes"] = np.asarray(self.classes)
        arrays["counts"] = np.asarray(self.counts)
        if arrays["classes"].dtype == object:
            # np.load(allow_pickle=False) rejects pickled object arrays.
            # Re-inferring from the list recovers a concrete dtype (e.g.
            # object-of-int labels round-trip as int64); genuinely mixed
            # labels fall back to fixed-width unicode.
            coerced = np.asarray(arrays["classes"].tolist())
            arrays["classes"] = (coerced if coerced.dtype != object
                                 else arrays["classes"].astype(str))
        np.savez(base + ".npz", **arrays)
        meta = {
            "format_version": FORMAT_VERSION,
            "config": dataclasses.asdict(self.config),
        }
        if self.lineage is not None:
            meta["lineage"] = self.lineage
        if extra_meta:
            meta.update(extra_meta)
        with open(base + ".json", "w") as f:
            json.dump(meta, f, indent=1)
        return base

    @classmethod
    def load(cls, path: str, meta: Optional[dict] = None, *,
             device: Optional[Device] = None) -> "ForestArtifacts":
        """Load a saved model onto ``device`` (``None``: the GPU, or raise).
        ``meta`` lets a caller that already read the sidecar skip a second
        JSON parse."""
        base = path[:-4] if path.endswith(".npz") else path
        if meta is None:
            meta = cls.load_meta(base)
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"artifacts at {base} were written by a newer format "
                f"({meta['format_version']} > {FORMAT_VERSION})")
        with np.load(base + ".npz", allow_pickle=False) as data:
            arrays = {f: data[f] for f in _ARRAY_FIELDS}
        art = artifacts_from_numpy(arrays, meta["config"], device)
        return dataclasses.replace(art, lineage=meta.get("lineage"))

    @staticmethod
    def load_meta(path: str) -> dict:
        """Read just the JSON sidecar (schema, config) without the arrays."""
        base = path[:-4] if path.endswith(".npz") else path
        with open(base + ".json") as f:
            return json.load(f)


def artifacts_from_numpy(arrays: dict, config: dict,
                         device: Optional[Device] = None) -> ForestArtifacts:
    """Build artifacts from host arrays, e.g. a JAX model's
    ``{f: np.asarray(getattr(art, f))}`` and ``dataclasses.asdict(art.config)``.

    Checks the arrays on the host, then moves each tensor to ``device``
    (``None``: the GPU, or raise) once.
    """
    device = resolve_device(device)
    fcfg = ForestConfig(**config)
    host = {f: np.ascontiguousarray(arrays[f], _DTYPES.get(f, np.float32))
            for f in _TENSOR_FIELDS}
    _validate(host, fcfg)
    tensors = {f: torch.tensor(a, device=device) for f, a in host.items()}
    return ForestArtifacts(**tensors, classes=np.asarray(arrays["classes"]),
                           counts=np.asarray(arrays["counts"]), config=fcfg)
