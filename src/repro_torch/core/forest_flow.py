"""Deprecation shim: ``ForestGenerativeModel`` over :mod:`repro_torch.tabgen`.

The twin of ``repro.core.forest_flow``, the JAX package's monolithic
trainer/sampler that was carved into the composable ``tabgen`` subsystem:

* training            -> :func:`repro_torch.tabgen.fit_artifacts`
* trained state       -> :class:`repro_torch.tabgen.ForestArtifacts`
* sampling            -> :func:`repro_torch.tabgen.sampling.sample`
* imputation          -> :func:`repro_torch.tabgen.impute`
* mixed-type frontend -> :class:`repro_torch.tabgen.TabularGenerator`

This class remains so existing code keeps working; new code should use the
``tabgen`` API directly. ``fit(device=)`` places the model (``None``: the
GPU, or raise); the legacy attributes are read back to the host once.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from repro_torch.config import ForestConfig
from repro_torch.kernels.dispatch import Device
from repro_torch.tabgen.artifacts import ForestArtifacts
from repro_torch.tabgen.fitting import fit_artifacts, weighted_edges  # noqa: F401
from repro_torch.tabgen.imputation import impute as _impute
from repro_torch.tabgen.sampling import sample as _sample

_HOST_FIELDS = ("feat", "thr_val", "leaf", "best_round", "rounds_run",
                "val_curve", "mins", "maxs")


class ForestGenerativeModel:
    """Deprecated facade kept for backward compatibility.

    >>> model = ForestGenerativeModel(ForestConfig(n_t=8, duplicate_k=10))
    >>> model.fit(X, y, seed=0)
    >>> Xgen, ygen = model.generate(512, seed=1)
    """

    def __init__(self, fcfg: ForestConfig):
        warnings.warn(
            "ForestGenerativeModel is deprecated; use repro_torch.tabgen "
            "(TabularGenerator / fit_artifacts + sample)",
            DeprecationWarning, stacklevel=2)
        self.fcfg = fcfg
        self.artifacts: Optional[ForestArtifacts] = None
        self._host_arrays = None

    def fit(self, X, y=None, *, seed: int = 0,
            checkpoint_dir: Optional[str] = None, resume: bool = False,
            ensembles_per_batch: int = 0, device: Optional[Device] = None):
        self.artifacts = fit_artifacts(
            X, y, self.fcfg, seed=seed, checkpoint_dir=checkpoint_dir,
            resume=resume, ensembles_per_batch=ensembles_per_batch,
            device=device)
        self._host_arrays = None
        return self

    def generate(self, n: int, *, seed: int = 0):
        assert self.artifacts is not None, "fit() first"
        return _sample(self.artifacts, n, seed=seed)

    def impute(self, X_missing, y=None, *, seed: int = 0,
               refine_rounds: int = 3):
        assert self.artifacts is not None, "fit() first"
        return _impute(self.artifacts, X_missing, y, seed=seed,
                       refine_rounds=refine_rounds)

    def trees_at_best_iteration(self):
        """Paper Fig. 3: trees kept per timestep (mean over y, sub)."""
        assert self.artifacts is not None, "fit() first"
        return self.artifacts.trees_at_best_iteration()

    # -- legacy attribute surface ------------------------------------------

    def _host(self) -> dict:
        if self._host_arrays is None:   # device->host copy once, not per access
            self._host_arrays = {k: getattr(self.artifacts, k).cpu().numpy()
                                 for k in _HOST_FIELDS}
        return self._host_arrays

    @property
    def forests(self):
        if self.artifacts is None:
            return None
        return {k: v for k, v in self._host().items()
                if k not in ("mins", "maxs")}

    @property
    def n_y(self):
        return self.artifacts.n_y

    @property
    def p(self):
        return self.artifacts.p

    @property
    def _classes(self):
        return np.asarray(self.artifacts.classes)

    @property
    def _counts(self):
        return np.asarray(self.artifacts.counts)

    @property
    def _mins(self):
        return self._host()["mins"]

    @property
    def _maxs(self):
        return self._host()["maxs"]
