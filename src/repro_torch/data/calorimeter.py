"""Synthetic calorimeter showers with the CaloChallenge schema (paper §2.4).

The real Photons/Pions files are not redistributable here, so this generator
produces voxelised showers with the same structure: cylindrical voxel grid
(layers x radial x angular), 15 log-spaced incident-energy classes, radial
exponential decay, layer-wise longitudinal profile, multiplicative noise, and
heavy sparsity — enough for every pipeline and metric to run at the paper's
scale (n ~ 121k, p = 368 / 533).

A numpy-only copy of the generator half of ``repro.data.calorimeter``, row
for row the same; the Challenge metrics stay in the JAX package.
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
