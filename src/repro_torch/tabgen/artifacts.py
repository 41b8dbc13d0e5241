"""ForestArtifacts: the trained model as a dataclass of tensors on one device.

Everything a sampler needs, resident on the device once:

* the stacked packed forests ``[n_t, n_y, n_sub, T, ...]`` (all timesteps,
  all classes),
* per-class min/max scalers ``[n_y, p]``,
* the class table and empirical counts for label sampling (host arrays),
* early-stopping diagnostics (``best_round`` / ``val_curve``),
* the :class:`ForestConfig` and the data lineage.

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
from typing import Optional

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

    # -- shape helpers ------------------------------------------------------

    @property
    def n_t(self) -> int:
        return self.feat.shape[0]

    @property
    def n_y(self) -> int:
        return self.feat.shape[1]

    @property
    def p(self) -> int:
        return self.mins.shape[1]

    @property
    def device(self) -> torch.device:
        return self.feat.device

    def class_forest(self, yi: int) -> PackedForest:
        """Forest stack ``[n_t, 1, n_sub, ...]`` of class ``yi``: a batch of
        one class, a view of the resident arrays."""
        return PackedForest(self.feat[:, yi:yi + 1], self.thr_val[:, yi:yi + 1],
                            self.leaf[:, yi:yi + 1], self.config.multi_output)

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

    def to(self, device: Device) -> "ForestArtifacts":
        """The same model with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _TENSOR_FIELDS})

    # -- persistence --------------------------------------------------------

    def save(self, path: str, extra_meta: Optional[dict] = None) -> str:
        """Write ``<path>.npz`` (arrays) + ``<path>.json`` (config + meta).
        Returns the base path."""
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
