"""Synthetic calorimeter showers with the CaloChallenge schema (paper §2.4).

The real Photons/Pions files are not redistributable here, so this generator
produces voxelised showers with the same structure: cylindrical voxel grid
(layers x radial x angular), 15 log-spaced incident-energy classes, radial
exponential decay, layer-wise longitudinal profile, multiplicative noise, and
heavy sparsity — enough for every pipeline and metric to run at the paper's
scale (n ~ 121k, p = 368 / 533).

A numpy-only copy of ``repro.data.calorimeter``: the generator, row for row
the same, and the Challenge metrics (App. A.1: the expert features and the
chi^2 separation power), the same numbers for the same showers.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# (layers, radial, angular) grids chosen so p matches the Challenge datasets
GEOMETRY = {
    "photons": (5, 8, 9),   # 360 voxels + 8 pad features -> p = 368
    "pions": (7, 8, 9),     # 504 voxels + 29 extra cells  -> p = 533
    # reduced grids with the same structure for the CPU-quick benchmark path
    "photons_mini": (3, 4, 5),   # 60 voxels -> p = 64
    "pions_mini": (4, 4, 5),     # 80 voxels -> p = 96
}
P_TARGET = {"photons": 368, "pions": 533, "photons_mini": 64,
            "pions_mini": 96}
N_CLASSES = 15


def generate(dataset: str, n: int, seed: int = 0
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X [n, p] fp32 energies, y [n] int64 energy-class labels)."""
    layers, nr, na = GEOMETRY[dataset]
    p = P_TARGET[dataset]
    rng = np.random.default_rng(seed)
    y = rng.integers(0, N_CLASSES, size=n)
    e_inc = 2.0 ** (y + 8)                     # log-spaced incident energies
    # longitudinal profile: gamma-like over layers, class-dependent peak
    depth = np.arange(layers)[None, :]
    peak = 1.0 + 0.15 * y[:, None] + 0.3 * rng.normal(size=(n, 1))
    long_prof = np.exp(-0.5 * ((depth - peak) / 1.2) ** 2)
    long_prof /= long_prof.sum(1, keepdims=True)
    # radial profile: exponential decay, slight class dependence
    r = np.arange(nr)[None, :]
    rad_scale = 1.0 + 0.05 * y[:, None]
    rad_prof = np.exp(-r / rad_scale)
    rad_prof /= rad_prof.sum(1, keepdims=True)
    # angular: nearly uniform with a random phase modulation per shower
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1))
    ang = (1.0 + 0.3 * np.cos(np.linspace(0, 2 * np.pi, na)[None, :] + phase))
    ang /= ang.sum(1, keepdims=True)

    vox = (e_inc[:, None, None, None]
           * long_prof[:, :, None, None]
           * rad_prof[:, None, :, None]
           * ang[:, None, None, :])
    noise = rng.lognormal(0.0, 0.35, size=vox.shape)
    vox = vox * noise
    # sparsity: read-out threshold kills small deposits
    vox[vox < 0.01 * e_inc[:, None, None, None] / vox.shape[1]] = 0.0
    X = vox.reshape(n, -1).astype(np.float32)
    if X.shape[1] < p:
        pad = np.zeros((n, p - X.shape[1]), np.float32)
        # pad features carry summary stats so they are informative, not dead
        pad[:, 0] = X.sum(1)
        if pad.shape[1] > 1:
            pad[:, 1] = (X > 0).sum(1)
        X = np.concatenate([X, pad], axis=1)
    return X[:, :p], y.astype(np.int64)


def generate_batches(dataset: str, n: int, *, batch_rows: int = 8192,
                     seed: int = 0):
    """Chunked twin of :func:`generate` for :func:`repro_torch.data.store.ingest`:
    yields ``(X, y)`` shower batches totalling ``n`` rows, batch ``b`` from
    its own stream ``[seed, b]`` (deterministic, replayable, never holds
    more than ``batch_rows`` showers in memory)."""
    for b, s in enumerate(range(0, n, batch_rows)):
        rows = min(batch_rows, n - s)
        batch_seed = np.random.SeedSequence([seed, b]).generate_state(1)[0]
        yield generate(dataset, rows, seed=int(batch_seed))


# ---------------------------------------------------------------------------
# Challenge metrics (App. A.1)
# ---------------------------------------------------------------------------

def high_level_features(X: np.ndarray, dataset: str) -> dict:
    """Expert features: E_dep/E_layer, center of energy + width per layer."""
    layers, nr, na = GEOMETRY[dataset]
    vox = X[:, :layers * nr * na].reshape(-1, layers, nr, na)
    e_layer = vox.sum((2, 3))                          # [n, layers]
    e_tot = e_layer.sum(1) + 1e-12
    feats = {"e_dep": e_tot}
    eta = np.arange(nr)[None, None, :, None]
    phi = np.arange(na)[None, None, None, :]
    w = vox / (vox.sum((2, 3), keepdims=True) + 1e-12)
    ce_eta = (w * eta).sum((2, 3))                     # [n, layers]
    ce_phi = (w * phi).sum((2, 3))
    wd_eta = np.sqrt(np.clip((w * eta ** 2).sum((2, 3)) - ce_eta ** 2, 0, None))
    wd_phi = np.sqrt(np.clip((w * phi ** 2).sum((2, 3)) - ce_phi ** 2, 0, None))
    for l in range(layers):
        feats[f"e_dep_l{l}"] = e_layer[:, l]
        feats[f"ce_eta_l{l}"] = ce_eta[:, l]
        feats[f"ce_phi_l{l}"] = ce_phi[:, l]
        feats[f"width_eta_l{l}"] = wd_eta[:, l]
        feats[f"width_phi_l{l}"] = wd_phi[:, l]
    return feats


def chi2_separation(a: np.ndarray, b: np.ndarray, bins: int = 30) -> float:
    """Paper Eq. 7: chi^2 separation power between two histograms."""
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    if hi <= lo:
        return 0.0
    ha, _ = np.histogram(a, bins=bins, range=(lo, hi))
    hb, _ = np.histogram(b, bins=bins, range=(lo, hi))
    fa = ha / max(ha.sum(), 1)
    fb = hb / max(hb.sum(), 1)
    denom = fa + fb
    mask = denom > 0
    return float(0.5 * np.sum((fa[mask] - fb[mask]) ** 2 / denom[mask]))
