"""Sharded ForestFlow training over ``torch.distributed``.

The JAX package's ``shard_map`` trainer (``repro.forest.distributed``), as
one process per rank of a ``(data, model)`` layout:

* rows of (X0, w, class id) are sharded over the ``data`` ranks: each rank
  holds one slice (:func:`build_row_shards`);
* the (timestep, class) ensembles of a batch are sharded over the
  ``model`` ranks: each trains its own ensembles on the rows of its data
  slice, one after the other (:func:`make_distributed_fit`; the JAX
  package ``lax.map``s them), and the batch's results are all-gathered
  over the model ranks;
* every tree level's histograms are reduced over the data ranks
  (:func:`repro_torch.forest.tree.grow_tree`): distributed XGBoost's
  all-reduce, as a collective of the data group;
* bin edges come from a gathered per-rank subsample (:func:`_sketch_edges`,
  the distributed quantile-sketch approximation).

Class conditioning is weight masking: ensemble e has per-row weight ``w ·
(class_id == y_e)``, so row shards never need class-sorted layouts, and
every ensemble trains on the rows of all classes.

Noise: the port has no threefry, so its draws differ from the JAX
package's. Ensemble ``eid`` on data rank ``shard`` draws its training
bridge from a ``torch.Generator`` of the fit device seeded by
``stream_seed(seed, stream, eid, 0, shard)`` and its validation bridge by
``(…, 1, shard)``. ``noise(eid, split, shape, shard)`` replaces the draws
(the tests hand over the JAX package's per-shard draws through it).

Summation order: with two data ranks a sum of two partial histograms is
the same in either order, so two ranks reduce exactly as the JAX
package's two devices do; with three or more, NCCL's or gloo's order may
differ from XLA's in the last place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import ForestConfig
from repro_torch.core import interpolants as itp
from repro_torch.forest.binning import (edges_with_sentinel, pack_codes,
                                        transform)
from repro_torch.forest.boosting import BoostResult, fit_ensemble

# (eid, split, shape, shard) -> (x1, jitter or None)
ShardNoiseFn = Callable[[int, int, Tuple[int, ...], int],
                        Tuple[torch.Tensor, Optional[torch.Tensor]]]

SKETCH_ROWS = 2048       # rows of each data rank the bin edges are taken from


@dataclasses.dataclass(frozen=True)
class Shards:
    """This rank's place in a ``(data, model)`` layout: the groups of the
    data and model ranks (``None`` for a dimension of one rank) and its
    index and size along each."""
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    data_rank: int
    data_size: int
    model_rank: int
    model_size: int

    @classmethod
    def one(cls) -> "Shards":
        """One rank, no process group: the route a store fit takes without
        a mesh."""
        return cls(None, None, 0, 1, 0, 1)

    @classmethod
    def from_mesh(cls, mesh) -> "Shards":
        """From a 2-D ``DeviceMesh`` with the dimensions ``"data"`` and
        ``"model"``."""
        names = tuple(mesh.mesh_dim_names or ())
        if sorted(names) != ["data", "model"]:
            raise ValueError(f"the mesh's dimensions are {names}; the sharded "
                             "trainer takes exactly ('data', 'model')")
        d, m = names.index("data"), names.index("model")
        return cls(mesh.get_group("data"), mesh.get_group("model"),
                   mesh.get_local_rank("data"), mesh.size(d),
                   mesh.get_local_rank("model"), mesh.size(m))


def _all_gather_rows(t, group, size: int):
    """``t`` of every rank of ``group`` concatenated along dim 0, in rank
    order."""
    if size == 1:
        return t
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
    gather(out, t.contiguous(), group=group)
    return out


def _sketch_edges(xt, w, n_bins: int, shards: Shards,
                  sketch_rows: int = SKETCH_ROWS):
    """Approximate global quantile edges ``[p, n_bins - 1]`` from the first
    ``min(sketch_rows, n_local)`` rows of every data rank, gathered in
    data-rank order. Rows of weight 0 sort last as +inf and are not
    counted; equal to the JAX package's ``_sketch_edges`` to the bit."""
    take = min(sketch_rows, xt.shape[0])
    sample = _all_gather_rows(xt[:take], shards.data_group, shards.data_size)
    sw = _all_gather_rows(w[:take], shards.data_group, shards.data_size)
    big = torch.where(sw[:, None] > 0, sample, torch.inf)
    s = torch.sort(big, dim=0).values
    n_real = (sw > 0).sum().to(torch.float32)
    # XLA turns the division by the constant n_bins into a multiply by its
    # reciprocal: so does this
    inv = torch.tensor(1.0, dtype=torch.float32) / n_bins
    qs = (torch.arange(1, n_bins, dtype=torch.float32) * inv).to(xt.device)
    idx = torch.clamp((qs * (n_real - 1.0)).to(torch.int32), 0,
                      s.shape[0] - 1)
    return s[idx.long()].T.contiguous()


def _fit_one_sharded(x0, w, class_id, t, y_e: int, eid: int,
                     fcfg: ForestConfig, shards: Shards, bridge, warm=None):
    """Train the ``(t, y_e)`` ensemble on this rank's rows, with the data
    ranks' collectives. ``bridge(eid, split, x0d, t)`` returns ``(x_t,
    target)``; ``warm`` is the ensemble's base-model slice for a warm
    start."""
    K = fcfg.duplicate_k
    x0d = x0.repeat_interleave(K, dim=0)
    wd = (w * (class_id == y_e).to(torch.float32)).repeat_interleave(K)
    xt, tgt = bridge(eid, 0, x0d, t)
    edges = _sketch_edges(xt, wd, fcfg.n_bins, shards)
    codes = transform(xt, edges)
    xtv, tgtv = bridge(eid, 1, x0d, t)
    codes_v = transform(xtv, edges)
    if fcfg.int8_codes:
        codes = pack_codes(codes, fcfg.n_bins)
        codes_v = pack_codes(codes_v, fcfg.n_bins)
    return fit_ensemble(codes, tgt, wd, edges_with_sentinel(edges), codes_v,
                        tgtv, wd, fcfg, warm=warm, x_raw=xt, val_raw=xtv,
                        group=shards.data_group)


def make_distributed_fit(shards: Shards, fcfg: ForestConfig, *, seed: int,
                         stream: int, device: torch.device,
                         noise: Optional[ShardNoiseFn] = None):
    """The per-rank trainer of one batch.

    Returns ``fn(x0, w, class_id, ts, ys, eids, warm=None) ->
    BoostResult`` stacked over the batch (``feat [bs, n_sub, T, H]``,
    ...): the batch's ``bs`` ensembles (``bs`` divisible by the model
    ranks) split into contiguous blocks over the model ranks; this rank
    trains its block on its rows (``x0 [n_local, p]``, ``w``,
    ``class_id``), then the block results of every model rank are
    all-gathered, so every rank returns the whole batch. ``warm``: the
    batch's base-model slices ``(feat, thr_val, leaf, val_curve,
    best_round)``, each ``[bs, n_sub, ...]``.
    """
    from repro_torch.tabgen.sampling import stream_seed

    def bridge(eid, split, x0d, t):
        if noise is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(stream_seed(seed, stream, eid, split,
                                        shards.data_rank))
            return itp.sample_bridge(x0d, fcfg.method, t, fcfg.sigma,
                                     generator=gen)[1:]
        x1, jitter = noise(eid, split, tuple(x0d.shape), shards.data_rank)
        if jitter is not None:
            jitter = jitter.to(device)
        return itp.sample_bridge(x0d, fcfg.method, t, fcfg.sigma,
                                 x1=x1.to(device), jitter=jitter)[1:]

    def fn(x0, w, class_id, ts, ys, eids, warm=None):
        bs = len(ts)
        if bs % shards.model_size:
            raise ValueError(f"a batch of {bs} ensembles does not split over "
                             f"{shards.model_size} model ranks")
        per = bs // shards.model_size
        lo = shards.model_rank * per
        outs = []
        for j in range(lo, lo + per):
            wj = None if warm is None else tuple(
                torch.as_tensor(a[j]).to(device) for a in warm)
            res = _fit_one_sharded(
                x0, w, class_id, torch.as_tensor(ts[j]).to(device),
                int(ys[j]), int(eids[j]), fcfg, shards, bridge, warm=wj)
            outs.append(res)
        return BoostResult(*(
            _all_gather_rows(torch.stack(field), shards.model_group,
                             shards.model_size) for field in zip(*outs)))

    return fn


# ---------------------------------------------------------------------------
# input build (host side)
# ---------------------------------------------------------------------------

def build_row_shards(X_np, cid_full, mins, maxs, perm, shards: Shards):
    """This data rank's rows ``(x0 [n_pad / d, p] f32, w [n_pad / d] f32,
    class_id [n_pad / d] i32)`` as host tensors.

    ``n`` rows are padded to ``n_pad``, a multiple of the d data ranks;
    rank r owns positions ``[r · n_pad / d, (r + 1) · n_pad / d)`` of the
    shuffle ``perm``: those rows of ``X_np``, rescaled with their class's
    scaler, weight 1 and their class id, and past ``n`` padding rows of
    weight 0, x 0 and class 0. ``X_np`` may be anything with ``.shape``
    and fancy row indexing, a :class:`repro_torch.data.store.DatasetStore`
    in particular, whose rows are then read from the shards they live in:
    the dataset is never on the host as a whole.
    """
    from repro_torch.tabgen.fitting import _rescale_host

    n, p = X_np.shape
    n_pad = -(-n // shards.data_size) * shards.data_size
    per = n_pad // shards.data_size
    lo = shards.data_rank * per
    hi = lo + per
    take = perm[lo:min(hi, n)]
    cid = np.asarray(cid_full)[take]
    x = _rescale_host(np.asarray(X_np[take], np.float32), mins[cid],
                      maxs[cid]).astype(np.float32)
    pad = per - len(take)
    x0 = np.concatenate([x, np.zeros((pad, p), np.float32)])
    w = np.concatenate([np.ones(len(take), np.float32),
                        np.zeros(pad, np.float32)])
    c = np.concatenate([cid.astype(np.int32), np.zeros(pad, np.int32)])
    return torch.from_numpy(x0), torch.from_numpy(w), torch.from_numpy(c)


def build_batch_inputs(chunk, ts, n_y: int):
    """Host-side inputs of one (padded) ensemble batch: timesteps ``[bs]``
    f32, class indices ``[bs]`` and grid-linearised ensemble ids ``eid =
    ti · n_y + yi`` ``[bs]``, from which the noise seeds follow."""
    t_arr = np.asarray([float(ts[ti]) for ti, _ in chunk], np.float32)
    y_arr = np.asarray([yi for _, yi in chunk], np.int32)
    e_arr = np.asarray([ti * n_y + yi for ti, yi in chunk], np.int64)
    return t_arr, y_arr, e_arr
