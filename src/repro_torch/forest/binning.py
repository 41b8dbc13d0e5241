"""Quantile binning: raw features -> small integer bin codes.

``fit_bins`` computes per-feature quantile edges; ``transform`` turns raw
features into codes with ``code > b  <=>  x > edges[:, b]`` exactly, the
contract that lets a tree grown on codes route raw values (its thresholds
are edge values) and lets a warm start replay saved trees on raw inputs.
"""
from __future__ import annotations

import torch

from repro_torch.core.interpolants import _linspace

# torch.quantile refuses inputs of more than 2**24 elements
_QUANTILE_MAX = 2 ** 24


def fit_bins(x, n_bins: int):
    """Per-feature quantile edges (linear interpolation, as ``jnp.quantile``).

    x: ``[n, p]``. Returns edges ``[p, n_bins - 1]`` f32, ascending. Agrees
    with ``repro.forest.binning.fit_bins`` to the last place or so: the two
    libraries interpolate between order statistics with other roundings.
    """
    n, p = x.shape
    qs = _linspace(0.0, 1.0, n_bins + 1)[1:-1].to(x.device)
    step = max(1, _QUANTILE_MAX // max(n, 1))
    cols = [torch.quantile(x[:, j:j + step], qs, dim=0)
            for j in range(0, p, step)]
    return torch.cat(cols, dim=1).T.contiguous().to(torch.float32)


def transform(x, edges):
    """Bin codes ``[n, p]`` int32: ``code[i, j]`` = the number of edges of
    feature j strictly below ``x[i, j]``, in ``[0, n_bins - 1]``."""
    codes = torch.searchsorted(edges.contiguous(), x.T.contiguous(),
                               right=False, out_int32=True)
    return codes.T.contiguous()


def pack_codes(codes, n_bins: int):
    """Store codes at the narrowest type (int8 when it fits)."""
    if n_bins <= 127:
        return codes.to(torch.int8)
    if n_bins <= 32767:
        return codes.to(torch.int16)
    return codes


def edges_with_sentinel(edges):
    """Append +inf so ``thr_bin == n_bins - 1`` means 'never go right'."""
    inf = torch.full((edges.shape[0], 1), torch.inf, dtype=edges.dtype,
                     device=edges.device)
    return torch.cat([edges, inf], dim=1)        # [p, n_bins]
