"""Training on one device: data prep and the ensemble fit, producing
ForestArtifacts.

The single-device route of the JAX package's trainer, ported:

* ``prepare_classes`` gathers the rows of each class into dense padded
  ``[n_y, n_max, p]`` blocks with per-class min-max scalers (padded rows
  have weight 0 and repeat the class's first row).
* Each (timestep, class) ensemble repeats its class block K times, draws
  the bridge (train and validation noise), computes weighted quantile
  edges and the bin codes, and fits its boosted trees
  (:func:`repro_torch.forest.boosting.fit_ensemble`). The noised inputs of
  one ensemble exist only while it trains.
* Ensembles are grouped into batches of ``ensembles_per_batch``; each
  batch is written to ``checkpoint_dir`` as it finishes, and
  ``resume=True`` restarts from the manifest. The batch files and the
  manifest's fingerprint are the JAX package's, so either package resumes
  the other's checkpoint of the same run. The ensembles of a batch train
  one after the other.
* ``extend_artifacts`` continues a model by K boosting rounds (warm
  start), bit-identical to a cold fit of R + K rounds on the same data.

Noise: ensemble ``eid = ti·n_y + yi`` draws its training bridge from a
``torch.Generator`` seeded by ``(seed, eid, 0)`` and its validation bridge
from ``(seed, eid, 1)``, on the fit device. ``noise=`` replaces those draws
with given tensors, e.g. to reproduce another generator's draws or to fit
the same noise on two devices.

The sharded trainer (``mesh=``) and out-of-core stores are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ForestConfig
from repro_torch.core import interpolants as itp
from repro_torch.forest.binning import edges_with_sentinel, pack_codes, transform
from repro_torch.forest.boosting import fit_ensemble
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.tabgen.artifacts import RESULT_FIELDS, ForestArtifacts
from repro_torch.tabgen.sampling import stream_seed
from repro_torch.train import checkpoint as _ckpt

# (eid, split, shape) -> (x1, jitter or None); split 0 = train, 1 = validation
NoiseFn = Callable[[int, int, Tuple[int, ...]],
                   Tuple[torch.Tensor, Optional[torch.Tensor]]]

_FIT_STREAM = 3   # after sampling's x1 / solve / impute streams


def weighted_edges(x, w, n_bins: int):
    """Quantile edges over the rows with positive weight (padded rows
    excluded). x ``[n, p]``; w ``[n]``. Returns ``[p, n_bins - 1]`` f32.

    Equal to ``repro.tabgen.fitting.weighted_edges`` to the bit: the
    quantile positions are ``arange(1, n_bins) · (1 / n_bins)``, as XLA
    turns the division by a constant into a multiply by its reciprocal.
    """
    big = torch.where(w[:, None] > 0, x, torch.inf)
    s = torch.sort(big, dim=0).values
    n_real = (w > 0).sum().to(torch.float32)
    inv = torch.tensor(1.0, dtype=torch.float32) / n_bins
    qs = torch.arange(1, n_bins, dtype=torch.float32) * inv
    idx = torch.clamp((qs.to(x.device) * (n_real - 1.0)).to(torch.int32), 0,
                      x.shape[0] - 1)
    return s[idx.long()].T.contiguous()


def _scaler_span_host(mins, maxs):
    # the JAX package's bool arithmetic: on numpy, 1 - gt is int64, so the
    # span and the rescaled rows are float64 until they are stored as f32
    gt = maxs > mins
    return (maxs - mins) * gt + (1 - gt)


def _rescale_host(x, mins, maxs):
    return (x - mins) / _scaler_span_host(mins, maxs) * 2.0 - 1.0


def prepare_classes(X, y, row_chunk: int = 65536, stats=None):
    """Gather rows by class into dense padded ``[n_y, n_max, p]`` blocks with
    per-class min-max scalers, on the host, in row chunks.

    ``stats`` (classes, counts, mins, maxs) skips the stats pass and pins
    the scalers: the warm-start path passes the base model's mins/maxs so
    extension rows land in the model space the base trees route in.

    Returns (Xc, Wc, classes, counts, mins, maxs) as numpy arrays, equal to
    the JAX package's ``prepare_classes``.
    """
    if not hasattr(X, "shape"):
        X = np.asarray(X, np.float32)
    n, p = X.shape
    if y is None:
        y = np.zeros((n,), np.int64)
    y = np.asarray(y)
    if stats is None:
        classes, counts, mins, maxs = class_stats_streaming(X, y, row_chunk)
    else:
        classes, counts, mins, maxs = stats
    n_y = len(classes)
    n_max = int(counts.max())
    Xc = np.zeros((n_y, n_max, p), np.float32)
    Wc = np.zeros((n_y, n_max), np.float32)
    pos = np.zeros((n_y,), np.int64)
    for s in range(0, n, row_chunk):
        xb = np.asarray(X[s:s + row_chunk], np.float32)
        cid = np.searchsorted(classes, y[s:s + row_chunk])
        for i in np.unique(cid):
            rows = _rescale_host(xb[cid == i], mins[i], maxs[i])
            Xc[i, pos[i]:pos[i] + len(rows)] = rows
            pos[i] += len(rows)
    for i, c in enumerate(counts):
        Xc[i, c:] = Xc[i, 0] if c else 0.0   # repeat-first-row padding
        Wc[i, :c] = 1.0
    return Xc, Wc, classes, counts, mins, maxs


def class_stats_streaming(X, y, row_chunk: int = 65536):
    """Classes, counts and per-class min-max scalers in one pass over row
    chunks, without a class-sorted or padded copy of X."""
    n, p = X.shape
    if y is None:
        y = np.zeros((n,), np.int64)
    classes = np.unique(np.asarray(y))
    n_y = len(classes)
    counts = np.zeros((n_y,), np.int64)
    mins = np.full((n_y, p), np.inf, np.float32)
    maxs = np.full((n_y, p), -np.inf, np.float32)
    for s in range(0, n, row_chunk):
        xb = np.asarray(X[s:s + row_chunk], np.float32)
        cid = np.searchsorted(classes, np.asarray(y[s:s + row_chunk]))
        for i in np.unique(cid):
            sel = xb[cid == i]
            counts[i] += len(sel)
            mins[i] = np.minimum(mins[i], sel.min(axis=0))
            maxs[i] = np.maximum(maxs[i], sel.max(axis=0))
    return classes, counts, mins, maxs


# ---------------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------------

def _check_warm_start(base: ForestArtifacts, fcfg: ForestConfig,
                      p: int) -> None:
    """Refuse an extension whose config or data cannot continue ``base``:
    every field but ``n_trees`` must match, ``n_trees`` must grow, and the
    feature count must agree."""
    bc = dataclasses.asdict(base.config)
    nc = dataclasses.asdict(fcfg)
    diffs = [k for k in nc if k != "n_trees" and bc.get(k) != nc[k]]
    if diffs:
        raise ValueError(
            "warm_start config mismatch — an extension may only change "
            "n_trees; differing fields: " + "; ".join(
                f"{k}: base={bc.get(k)!r} != new={nc[k]!r}" for k in diffs))
    if fcfg.n_trees <= base.config.n_trees:
        raise ValueError(
            f"warm_start needs n_trees > the base model's "
            f"{base.config.n_trees} (got {fcfg.n_trees}); use "
            "extend_artifacts(..., extra_trees=K) to grow by K rounds")
    if base.p != p:
        raise ValueError(f"warm_start base was fit on p={base.p} features "
                         f"but this data has p={p}")


def _check_warm_classes(base: ForestArtifacts, classes) -> None:
    """The extension data's label set must be exactly the base model's."""
    if not np.array_equal(np.asarray(classes), np.asarray(base.classes)):
        raise ValueError(
            f"warm_start class mismatch: base model has classes "
            f"{np.asarray(base.classes).tolist()} but this data has "
            f"{np.asarray(classes).tolist()}; extension data must cover "
            "exactly the base label set (retrain from scratch otherwise)")


def _warm_host_arrays(base: ForestArtifacts):
    """The base model's buffers on the host, in ``fit_boosted``'s warm
    order: (feat, thr_val, leaf, val_curve, best_round), each ``[n_t, n_y,
    n_sub, ...]``."""
    return tuple(getattr(base, f).cpu().numpy() for f in
                 ("feat", "thr_val", "leaf", "val_curve", "best_round"))


def _build_lineage(n_rows: int, p: int, fcfg: ForestConfig,
                   base: Optional[ForestArtifacts]) -> dict:
    """Data provenance recorded on the trained artifacts (and in the save
    sidecar). The port trains from in-memory rows only, so ``store`` is
    always None."""
    lin = {"rows": int(n_rows), "p": int(p), "store": None, "base": None}
    if base is not None:
        # one level of history: the base's own lineage minus its base
        prev = {k: v for k, v in (base.lineage or {}).items() if k != "base"}
        lin["base"] = {
            "round_range": [int(base.config.n_trees), int(fcfg.n_trees)],
            "lineage": prev or None,
        }
    return lin


def extend_artifacts(base: ForestArtifacts, X, y=None, *, extra_trees: int,
                     **kwargs) -> ForestArtifacts:
    """Grow ``base`` by ``extra_trees`` boosting rounds per ensemble.

    The base trees seed every ensemble and their running predictions are
    replayed; the base's per-class scalers are reused. On the same data
    and seed the result is bit-identical to :func:`fit_artifacts` run
    straight to R + K rounds. ``kwargs`` go to :func:`fit_artifacts`
    (checkpoint_dir, seed, device, ...).
    """
    if extra_trees <= 0:
        raise ValueError(f"extra_trees must be positive, got {extra_trees}")
    fcfg = dataclasses.replace(
        base.config, n_trees=base.config.n_trees + int(extra_trees))
    return fit_artifacts(X, y, fcfg, warm_start=base, **kwargs)


# ---------------------------------------------------------------------------
# checkpoint manifest
# ---------------------------------------------------------------------------

def _manifest_fingerprint(fcfg: ForestConfig, *, n_t: int, n_y: int,
                          batch_size: int, n_rows: int, p: int,
                          trainer: str, warm_rounds: int = 0) -> dict:
    """Everything that decides which ensemble lands in which batch file;
    the JAX package's dict, key for key. Not the seed: a resume may finish
    another run's grid, and completed batches never retrain. A warm-start
    fit adds ``warm_start: <base round count>``."""
    fp = {
        "config": dataclasses.asdict(fcfg),
        "grid": [n_t, n_y],
        "ensembles_per_batch": batch_size,
        "data_shape": [int(n_rows), int(p)],
        "trainer": trainer,
    }
    if warm_rounds:
        fp["warm_start"] = int(warm_rounds)
    return fp


def _run_grid_batches(run_batch, grid, bs: int, *,
                      checkpoint_dir: Optional[str], resume: bool,
                      fingerprint: dict, warm_base: Optional[dict] = None):
    """Drive the (timestep, class) grid in batches with checkpoint/resume.

    ``run_batch(chunk)`` trains ``chunk`` (a list of (ti, yi)) and returns
    ``{field: np.ndarray}`` with leading dim ``len(chunk)``. ``warm_base``
    (a warm-start fit's base-run descriptor) lets the manifest accept a
    checkpoint dir that holds the base model's batches: the extension
    retrains every batch and overwrites them.
    """
    manifest = (_ckpt.GridManifest(checkpoint_dir, fingerprint,
                                   warm_base=warm_base)
                if checkpoint_dir else None)
    done = manifest.load_done(resume) if manifest else set()

    results = {}
    for b0 in range(0, len(grid), bs):
        chunk = grid[b0:b0 + bs]
        key_id = (b0, len(chunk))
        if key_id in done:
            res_np = _ckpt.read_batch_npz(checkpoint_dir, b0)
        else:
            res_np = run_batch(chunk)
            if manifest:
                _ckpt.write_batch_npz(checkpoint_dir, b0, res_np)
                manifest.mark_done(key_id)
        for j, (ti, yi) in enumerate(chunk):
            results[(ti, yi)] = {k: v[j] for k, v in res_np.items()}
    return results


# ---------------------------------------------------------------------------
# the single-device trainer
# ---------------------------------------------------------------------------

def _is_store(X) -> bool:
    """An out-of-core dataset store (it has a fingerprint and a version)."""
    return hasattr(X, "fingerprint") and hasattr(X, "version")


def fit_artifacts(X, y=None, fcfg: ForestConfig = ForestConfig(), *,
                  seed: int = 0, checkpoint_dir: Optional[str] = None,
                  resume: bool = False, ensembles_per_batch: int = 0,
                  mesh=None, row_chunk: int = 65536,
                  warm_start: Optional[ForestArtifacts] = None,
                  device: Optional[Device] = None,
                  noise: Optional[NoiseFn] = None) -> ForestArtifacts:
    """Train all (timestep, class) ensembles on ``device`` (``None``: the
    GPU, or raise; ``"cpu"`` runs the plain PyTorch path) and return the
    artifacts there.

    ``checkpoint_dir`` streams each batch of ``ensembles_per_batch``
    ensembles to disk (default: 8, or the whole grid if smaller) and
    ``resume=True`` restarts from its manifest, retraining nothing that is
    committed. ``warm_start`` continues an existing model; see
    :func:`extend_artifacts`. ``noise(eid, split, shape)`` returns the
    ``(x1, jitter)`` tensors of an ensemble's training (split 0) or
    validation (split 1) bridge in place of the seeded draws; ``jitter``
    may be None when ``fcfg.sigma == 0``.

    ``mesh`` (the sharded trainer) and store-backed ``X`` are not ported
    yet and raise ``NotImplementedError``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded trainer (mesh=...) is not ported yet; the port "
            "trains on one device (mesh=None)")
    if _is_store(X):
        raise NotImplementedError(
            "out-of-core dataset stores are not ported yet; pass the rows "
            "as an array")
    device = resolve_device(device)
    stats = None
    if warm_start is not None:
        Xs = X if hasattr(X, "shape") else np.asarray(X, np.float32)
        _check_warm_start(warm_start, fcfg, int(np.shape(Xs)[1]))
        classes, counts, _, _ = class_stats_streaming(Xs, y, row_chunk)
        _check_warm_classes(warm_start, classes)
        # pin the base scalers: extension rows must land in the model space
        # the base trees were grown in
        stats = (classes, counts, warm_start.mins.cpu().numpy(),
                 warm_start.maxs.cpu().numpy())
    Xc, Wc, classes, counts, mins, maxs = prepare_classes(X, y, row_chunk,
                                                          stats=stats)
    n_y, _, p = Xc.shape
    Xc_d = torch.from_numpy(Xc).to(device)
    Wc_d = torch.from_numpy(Wc).to(device)
    ts = itp.timesteps(fcfg.method, fcfg.n_t, fcfg.eps_diff, fcfg.t_schedule)
    K = fcfg.duplicate_k
    warm_arrays = (None if warm_start is None
                   else _warm_host_arrays(warm_start))

    def bridge(eid, split, x0, t):
        if noise is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(stream_seed(seed, _FIT_STREAM, eid, split))
            return itp.sample_bridge(x0, fcfg.method, t, fcfg.sigma,
                                     generator=gen)[1:]
        x1, jitter = noise(eid, split, tuple(x0.shape))
        if jitter is not None:
            jitter = jitter.to(device)
        return itp.sample_bridge(x0, fcfg.method, t, fcfg.sigma,
                                 x1=x1.to(device), jitter=jitter)[1:]

    def fit_one(ti, yi):
        """Train the (t, y) ensemble; everything transient lives here."""
        eid = ti * n_y + yi
        t = ts[ti].to(device)
        x0 = Xc_d[yi].repeat_interleave(K, dim=0)          # [mK, p]
        w = Wc_d[yi].repeat_interleave(K)
        xt, tgt = bridge(eid, 0, x0, t)
        edges = weighted_edges(xt, w, fcfg.n_bins)
        codes = transform(xt, edges)
        xtv, tgtv = bridge(eid, 1, x0, t)
        codes_v = transform(xtv, edges)
        if fcfg.int8_codes:
            codes = pack_codes(codes, fcfg.n_bins)
            codes_v = pack_codes(codes_v, fcfg.n_bins)
        warm = None
        if warm_arrays is not None:
            warm = tuple(torch.from_numpy(a[ti, yi]).to(device)
                         for a in warm_arrays)
        res = fit_ensemble(codes, tgt, w, edges_with_sentinel(edges),
                           codes_v, tgtv, w, fcfg, warm=warm, x_raw=xt,
                           val_raw=xtv)
        return {k: getattr(res, k).cpu().numpy() for k in RESULT_FIELDS}

    def run_batch(chunk):
        outs = [fit_one(ti, yi) for ti, yi in chunk]
        return {k: np.stack([o[k] for o in outs]) for k in RESULT_FIELDS}

    grid = [(ti, yi) for ti in range(fcfg.n_t) for yi in range(n_y)]
    bs = ensembles_per_batch or max(1, min(len(grid), 8))
    warm_rounds = warm_start.config.n_trees if warm_start else 0
    fingerprint = _manifest_fingerprint(
        fcfg, n_t=fcfg.n_t, n_y=n_y, batch_size=bs, n_rows=np.shape(X)[0],
        p=p, trainer="single", warm_rounds=warm_rounds)
    warm_base = (None if warm_start is None else
                 {"config": dataclasses.asdict(warm_start.config),
                  "grid": [fcfg.n_t, n_y]})
    results = _run_grid_batches(run_batch, grid, bs,
                                checkpoint_dir=checkpoint_dir, resume=resume,
                                fingerprint=fingerprint, warm_base=warm_base)
    arts = ForestArtifacts.from_grid_results(results, fcfg.n_t, n_y, mins,
                                             maxs, classes, counts, fcfg,
                                             device)
    arts.lineage = _build_lineage(np.shape(X)[0], p, fcfg, warm_start)
    return arts
