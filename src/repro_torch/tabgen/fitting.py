"""Training on one device: data prep and the ensemble fit, producing
ForestArtifacts.

The single-device route of the JAX package's trainer, ported:

* ``prepare_classes`` gathers the rows of each class into dense padded
  ``[n_y, n_max, p]`` blocks with per-class min-max scalers (padded rows
  have weight 0 and repeat the class's first row).
* Each (timestep, class) ensemble repeats its class block K times, draws
  the bridge (train and validation noise), computes weighted quantile
  edges and the bin codes. The noised inputs of a batch exist only while
  it trains.
* Ensembles are grouped into batches of ``ensembles_per_batch``; each
  batch is written to ``checkpoint_dir`` as it finishes, and
  ``resume=True`` restarts from the manifest. The batch files and the
  manifest's fingerprint are the JAX package's, so either package resumes
  the other's checkpoint of the same run. The ensembles of a batch train
  together, as the lanes of one boosting loop
  (:func:`repro_torch.forest.boosting.fit_ensembles`, the JAX package's
  ``jax.vmap(fit_one)``): one ``hist`` launch a tree level, one split
  search, one routing pass and one validation loss for all of them. A
  batch is cut into consecutive groups of whole ensembles whose deepest
  level's histograms fit :data:`HIST_GROUP_BYTES`
  (:func:`ensemble_groups`, a pure function of the shapes), one loop a
  group. Each ensemble's trees are the same bits whatever its batch or
  group.
* ``extend_artifacts`` continues a model by K boosting rounds (warm
  start), bit-identical to a cold fit of R + K rounds on the same data.

Noise: ensemble ``eid = ti·n_y + yi`` draws its training bridge from a
``torch.Generator`` seeded by ``(seed, eid, 0)`` and its validation bridge
from ``(seed, eid, 1)``, on the fit device. ``noise=`` replaces those draws
with given tensors, e.g. to reproduce another generator's draws or to fit
the same noise on two devices.

The sharded trainer (``mesh=``, and every fit from a
:class:`repro_torch.data.store.DatasetStore`): one process per rank of a
``(data, model)`` mesh; rows shuffled by ``perm =
default_rng(seed).permutation(n)`` and sharded over the data ranks with
weight-masked class conditioning (no padded class blocks), the ensembles
of a batch over the model ranks (:mod:`repro_torch.forest.distributed`).
Its noise adds the data rank: ``(seed, eid, split, shard)``, and
``noise(eid, split, shape, shard)`` replaces it. A store fit without a
mesh takes this route on one rank, with no process group. It uploads
its rows once and trains its batches in the single-device route's loop,
one after another. Its checkpoints are the JAX package's
(``trainer="sharded"``): either package resumes the other's.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ForestConfig
from repro_torch.core import interpolants as itp
from repro_torch.forest.binning import edges_with_sentinel, pack_codes, transform
from repro_torch.forest.boosting import fit_ensembles, lanes_per_ensemble
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.obs import default_tracer
from repro_torch.tabgen.artifacts import (RESULT_FIELDS, ForestArtifacts,
                                         scaler_span_host)
from repro_torch.tabgen.sampling import stream_seed
from repro_torch.train import checkpoint as _ckpt

# (eid, split, shape) -> (x1, jitter or None); split 0 = train, 1 = validation
# (the sharded route adds the data rank: (eid, split, shape, shard))
NoiseFn = Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor]]]

_FIT_STREAM = 3   # after sampling's x1 / solve / impute streams

# The bytes a group's deepest-level histograms (sum_g and count, f32) may
# take: the split search holds a few arrays of that size at once, so one
# group stays well inside an 80 GB card. Fixed, so that a fit makes the
# same launches in every run and on every card.
HIST_GROUP_BYTES = 8 * 10 ** 9


def ensemble_groups(n_ens: int, lanes: int, p: int, n_bins: int, out: int,
                    depth: int, cap: Optional[int] = None):
    """Cut a batch of ``n_ens`` ensembles into consecutive groups
    ``[(start, stop), ...]`` that train as one loop each: as many whole
    ensembles a group as keep the deepest level's histograms (``lanes``
    lanes, ``2^(depth-1)`` nodes, p features, n_bins bins, out + 1 f32
    columns each) within ``cap`` bytes (:data:`HIST_GROUP_BYTES`), and at
    least one. A pure function of the shapes: it never reads free
    memory."""
    cap = HIST_GROUP_BYTES if cap is None else cap
    nodes = 2 ** max(depth - 1, 0)
    per = lanes * nodes * p * n_bins * (out + 1) * 4
    size = max(1, cap // max(per, 1))
    return [(a, min(a + size, n_ens)) for a in range(0, n_ens, size)]


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


def _rescale_host(x, mins, maxs):
    # float64 until the rows are stored as f32, as in the JAX package
    return (x - mins) / scaler_span_host(mins, maxs) * 2.0 - 1.0


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


def _build_lineage(X, n_rows: int, p: int, fcfg: ForestConfig,
                   base: Optional[ForestArtifacts]) -> dict:
    """Data provenance recorded on the trained artifacts (and in the save
    sidecar): the store a model was fit from, if any, and its base."""
    lin = {"rows": int(n_rows), "p": int(p), "store": None, "base": None}
    if _is_store(X):
        lin["store"] = {"fingerprint": X.fingerprint,
                        "version": int(X.version), "n_rows": int(X.n_rows)}
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
    base._require_whole("extend")
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


def _manifest_batch_size(checkpoint_dir: str) -> Optional[int]:
    """The batch size an existing checkpoint was written with, if any."""
    path = os.path.join(checkpoint_dir, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("fingerprint", {}).get("ensembles_per_batch")


def _run_grid_batches(run_batch, grid, bs: int, *,
                      checkpoint_dir: Optional[str], resume: bool,
                      fingerprint: dict, warm_base: Optional[dict] = None,
                      commit: bool = True):
    """Drive the (timestep, class) grid in batches with checkpoint/resume.

    ``run_batch(chunk)`` trains ``chunk`` (a list of (ti, yi)) and returns
    ``{field: np.ndarray}`` with leading dim ``len(chunk)``. ``warm_base``
    (a warm-start fit's base-run descriptor) lets the manifest accept a
    checkpoint dir that holds the base model's batches: the extension
    retrains every batch and overwrites them. ``commit=False`` (every rank
    of a sharded fit but the first) reads the checkpoint and writes
    nothing.
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
            with default_tracer().span("fit.batch", batch=b0,
                                       ensembles=len(chunk)):
                res_np = run_batch(chunk)
            if manifest and commit:
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

    ``mesh`` selects the trainer: ``None`` is the single-device one; a
    ``DeviceMesh`` with dimensions ``("data", "model")``
    (:func:`repro_torch.launch.mesh.forest_mesh`) the sharded one, on this
    process's rank; ``"auto"`` builds a mesh over every visible GPU
    (:func:`repro_torch.launch.mesh.auto_forest_mesh`), ``None`` on one.
    ``X`` may be a :class:`repro_torch.data.store.DatasetStore`: such a fit
    always takes the sharded trainer, on one rank with no process group
    when there is no mesh; class stats come from the store (unless ``y``
    is given) and the rows are read from its shards. On the sharded route
    ``noise`` is called as ``noise(eid, split, shape, shard)``.
    """
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh={mesh!r}: expected a DeviceMesh, None, "
                             "or 'auto'")
        from repro_torch.launch.mesh import auto_forest_mesh
        mesh = auto_forest_mesh()
    device = resolve_device(device)
    if mesh is not None or _is_store(X):
        from repro_torch.forest.distributed import Shards
        shards = Shards.one() if mesh is None else Shards.from_mesh(mesh)
        if mesh is not None and mesh.device_type != device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the fit on "
                             f"{device}")
        return _fit_artifacts_sharded(
            X, y, fcfg, shards, device=device, seed=seed,
            checkpoint_dir=checkpoint_dir, resume=resume,
            ensembles_per_batch=ensembles_per_batch, row_chunk=row_chunk,
            warm_start=warm_start, noise=noise)
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

    def inputs(ti, yi):
        """The (t, y) ensemble's noised rows, edges and codes."""
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
        raw = (xt, xtv) if warm_arrays is not None else (None, None)
        return (codes, tgt, w, edges_with_sentinel(edges), codes_v, tgtv,
                *raw)

    lanes = lanes_per_ensemble(fcfg, p)

    def fit_group(chunk):
        """Train the ensembles of ``chunk`` as one loop; everything
        transient lives here."""
        codes, tgt, w, es, codes_v, tgtv, xt, xtv = (
            None if parts[0] is None else torch.stack(parts)
            for parts in zip(*(inputs(ti, yi) for ti, yi in chunk)))
        warm = None
        if warm_arrays is not None:
            warm = tuple(torch.from_numpy(np.concatenate(
                [a[ti, yi] for ti, yi in chunk])).to(device)
                for a in warm_arrays)
        res = fit_ensembles(codes, tgt, w, es, codes_v, tgtv, w, fcfg,
                            warm=warm, x_raw=xt, val_raw=xtv)
        return {k: getattr(res, k).cpu().numpy().reshape(
            (len(chunk), lanes) + tuple(getattr(res, k).shape[1:]))
            for k in RESULT_FIELDS}

    def run_batch(chunk):
        groups = ensemble_groups(
            len(chunk), lanes, p, fcfg.n_bins,
            p if fcfg.multi_output else 1, fcfg.max_depth)
        outs = [fit_group(chunk[a:b]) for a, b in groups]
        return {k: np.concatenate([o[k] for o in outs])
                for k in RESULT_FIELDS}

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
    arts.lineage = _build_lineage(X, np.shape(X)[0], p, fcfg, warm_start)
    return arts


# ---------------------------------------------------------------------------
# the sharded trainer
# ---------------------------------------------------------------------------

def _upload(host, device):
    """Host tensors to ``device``: on a CUDA device, pinned and copied
    without blocking on the current stream; else as they are (the CPU)."""
    if device.type != "cuda":
        return tuple(t.to(device) for t in host)
    return tuple(t.pin_memory().to(device, non_blocking=True) for t in host)


def _fit_artifacts_sharded(X, y, fcfg: ForestConfig, shards, *,
                           device: torch.device, seed: int,
                           checkpoint_dir: Optional[str], resume: bool,
                           ensembles_per_batch: int, row_chunk: int,
                           warm_start: Optional[ForestArtifacts] = None,
                           noise: Optional[NoiseFn] = None
                           ) -> ForestArtifacts:
    """The sharded trainer on this rank (``shards``): the JAX package's
    ``_fit_artifacts_sharded``, rule for rule.

    Rows (rescaled per class, weight-masked class conditioning) are
    shuffled by ``perm`` and sharded over the data ranks; each rank builds
    and uploads its own slice once. The grid is trained in batches of
    ``ensembles_per_batch`` (rounded up to the model ranks) split over the
    model ranks, with the single-device route's checkpoints (fingerprint
    ``trainer="sharded"``), which only the first rank writes. A resume
    that does not pin the batch size takes the checkpoint's, and refuses
    one the model ranks cannot split. The tail batch is padded by
    repeating its last ensemble, and the copies are dropped.
    """
    from repro_torch.forest.distributed import (build_batch_inputs,
                                                build_row_shards,
                                                make_distributed_fit)

    if _is_store(X):
        X_np = X                       # rows are read from the shards
        n, p = X.shape
        if y is None:
            y = X.labels()
            classes, counts, mins, maxs = X.class_stats()
        else:
            # explicit labels override the store's own: stream the
            # per-class scalers over the shards again
            y = np.asarray(y)
            classes, counts, mins, maxs = class_stats_streaming(X, y,
                                                                row_chunk)
    else:
        X_np = X if isinstance(X, np.ndarray) else np.asarray(X, np.float32)
        n, p = X_np.shape
        if y is None:
            y = np.zeros((n,), np.int64)
        classes, counts, mins, maxs = class_stats_streaming(X_np, y,
                                                            row_chunk)
    if warm_start is not None:
        _check_warm_start(warm_start, fcfg, p)
        _check_warm_classes(warm_start, classes)
        # the base scalers: the replayed trees route in the base model's
        # [-1, 1] space (this data's counts stay, for label sampling)
        mins = warm_start.mins.cpu().numpy()
        maxs = warm_start.maxs.cpu().numpy()
    n_y = len(classes)
    cid_full = np.searchsorted(classes, np.asarray(y)).astype(np.int32)
    m_size = shards.model_size
    commit = shards.data_rank == 0 and shards.model_rank == 0

    # a deterministic shuffle, so every row shard sees every class: the
    # sketch takes the head of each shard
    perm = np.random.default_rng(seed).permutation(n)

    ts = itp.timesteps(fcfg.method, fcfg.n_t, fcfg.eps_diff,
                       fcfg.t_schedule).numpy()
    grid = [(ti, yi) for ti in range(fcfg.n_t) for yi in range(n_y)]
    bs = ensembles_per_batch or max(m_size, min(len(grid), 8))
    if not ensembles_per_batch and resume and checkpoint_dir:
        # elastic resume: the batch size is part of the checkpoint layout
        bs = _manifest_batch_size(checkpoint_dir) or bs
    bs = -(-bs // m_size) * m_size          # whole blocks per model rank
    if resume and checkpoint_dir:
        stale = _manifest_batch_size(checkpoint_dir)
        if stale and stale != bs:
            raise ValueError(
                f"checkpoint at {checkpoint_dir} was written with "
                f"ensembles_per_batch={stale} but this run resolves to "
                f"{bs} (the {m_size} model ranks need a multiple of "
                f"{m_size}); resume with ensembles_per_batch={stale} on a "
                "compatible mesh, or retrain with resume=False.")

    warm_rounds = warm_start.config.n_trees if warm_start else 0
    fit = make_distributed_fit(shards, fcfg, seed=seed, stream=_FIT_STREAM,
                               device=device, noise=noise)
    warm_arrays = (None if warm_start is None
                   else _warm_host_arrays(warm_start))

    def warm_slices(chunk):
        if warm_arrays is None:
            return None
        tis = [ti for ti, _ in chunk]
        yis = [yi for _, yi in chunk]
        return tuple(a[tis, yis] for a in warm_arrays)

    def pad(chunk):
        return chunk + [chunk[-1]] * (bs - len(chunk))

    fingerprint = _manifest_fingerprint(
        fcfg, n_t=fcfg.n_t, n_y=n_y, batch_size=bs, n_rows=n, p=p,
        trainer="sharded", warm_rounds=warm_rounds)
    warm_base = (None if warm_start is None else
                 {"config": dataclasses.asdict(warm_start.config),
                  "grid": [fcfg.n_t, n_y]})
    row_cache: dict = {}

    def rows():
        """This rank's rows on the device, built and uploaded on first use,
        so a resume with every batch committed reads no row."""
        if "rows" not in row_cache:
            host = build_row_shards(X_np, cid_full, mins, maxs, perm, shards)
            row_cache["rows"] = _upload(host, device)
        return row_cache["rows"]

    def run_batch(chunk):
        padded = pad(chunk)
        res = fit(*rows(), *build_batch_inputs(padded, ts, n_y),
                  warm=warm_slices(padded))
        return {k: getattr(res, k)[:len(chunk)].cpu().numpy()
                for k in RESULT_FIELDS}

    results = _run_grid_batches(run_batch, grid, bs,
                                checkpoint_dir=checkpoint_dir, resume=resume,
                                fingerprint=fingerprint, warm_base=warm_base,
                                commit=commit)
    arts = ForestArtifacts.from_grid_results(results, fcfg.n_t, n_y, mins,
                                             maxs, classes, counts, fcfg,
                                             device)
    arts.lineage = _build_lineage(X, n, p, fcfg, warm_start)
    return arts
