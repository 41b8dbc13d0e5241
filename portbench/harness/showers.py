"""Synthetic calorimeter showers at the CaloChallenge 2022 widths: the fit
cells' traffic generator.

The real dataset-1 files are not in the repository, so the fit cells train
on voxelised showers of the same structure: a cylindrical grid (layers x
radial x angular voxels), log-spaced incident energies by class, a
class-dependent longitudinal peak, radial exponential decay, a random
angular phase, log-normal fluctuation and a read-out threshold that zeroes
small deposits; pad features carry the total energy and the hit count. This
is a copy of the port's numpy generator (``data/calorimeter.py``, itself a
copy of the JAX package's), with one change: the caller names each row's
class, so every seed gives the same number of rows a class.
"""
from __future__ import annotations

import numpy as np

# (layers, radial, angular) voxel grids; p pads the voxels with summaries
GEOMETRY = {
    "photons": (5, 8, 9),        # 360 voxels + 8 pad features -> p = 368
    "pions": (7, 8, 9),          # 504 voxels + 29 pad features -> p = 533
    "photons_mini": (3, 4, 5),   # 60 voxels + 4 -> p = 64 (CPU tests)
}
P_TARGET = {"photons": 368, "pions": 533, "photons_mini": 64}


def showers(dataset: str, y: np.ndarray, seed) -> np.ndarray:
    """``[len(y), p]`` float32 energies of showers of energy classes ``y``
    (0 ... 14), drawn from ``numpy.random.default_rng(seed)``."""
    layers, nr, na = GEOMETRY[dataset]
    p = P_TARGET[dataset]
    y = np.asarray(y, dtype=np.int64)
    n = len(y)
    rng = np.random.default_rng(seed)
    e_inc = 2.0 ** (y + 8)
    depth = np.arange(layers)[None, :]
    peak = 1.0 + 0.15 * y[:, None] + 0.3 * rng.normal(size=(n, 1))
    long_prof = np.exp(-0.5 * ((depth - peak) / 1.2) ** 2)
    long_prof /= long_prof.sum(1, keepdims=True)
    r = np.arange(nr)[None, :]
    rad_prof = np.exp(-r / (1.0 + 0.05 * y[:, None]))
    rad_prof /= rad_prof.sum(1, keepdims=True)
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1))
    ang = 1.0 + 0.3 * np.cos(np.linspace(0, 2 * np.pi, na)[None, :] + phase)
    ang /= ang.sum(1, keepdims=True)
    vox = (e_inc[:, None, None, None] * long_prof[:, :, None, None]
           * rad_prof[:, None, :, None] * ang[:, None, None, :])
    vox = vox * rng.lognormal(0.0, 0.35, size=vox.shape)
    vox[vox < 0.01 * e_inc[:, None, None, None] / vox.shape[1]] = 0.0
    X = vox.reshape(n, -1).astype(np.float32)
    pad = np.zeros((n, p - X.shape[1]), np.float32)
    pad[:, 0] = X.sum(1)
    if pad.shape[1] > 1:
        pad[:, 1] = (X > 0).sum(1)
    return np.concatenate([X, pad], axis=1)
