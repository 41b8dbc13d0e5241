"""TabularGenerator: schema-aware fit / generate / impute / save / load.

The front door for tabular data in the port. Composes:

* :class:`TabularSchema` — categorical columns are one-hot encoded before
  fitting and re-argmaxed after generation, integer columns rounded and
  clipped;
* :func:`fit_artifacts` — the single-device ensemble trainer;
* :func:`sample` — the class-batched sampler (registry-selected);
* :func:`impute` — the bridge-clamped conditional solve;
* :class:`ForestArtifacts` ``save``/``load`` — the schema rides along in the
  JSON sidecar, in the JAX package's format, so a model trained by either
  package loads in the other.

    gen = TabularGenerator(ForestConfig(n_t=8), cat_cols=[2], int_cols=[1])
    gen.fit(X, y).save("model")                    # trains on the GPU
    Xg, yg = TabularGenerator.load("model").generate(1000, seed=1)
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.config import ForestConfig
from repro_torch.core.mixed_types import TabularSchema, _isnan
from repro_torch.kernels.dispatch import Device
from repro_torch.tabgen.artifacts import ForestArtifacts
from repro_torch.tabgen.fitting import fit_artifacts
from repro_torch.tabgen.imputation import impute as _impute
from repro_torch.tabgen.sampling import sample_async as _sample_async


class _DecodingHandle:
    """Schema-aware wrapper over an in-flight sample: decode on resolve."""

    def __init__(self, handle, schema: TabularSchema):
        self._handle = handle
        self._schema = schema

    def result(self):
        X, y = self._handle.result()
        return self._schema.decode(X), y


class TabularGenerator:
    def __init__(self, fcfg: ForestConfig = ForestConfig(), *,
                 cat_cols: Sequence[int] = (), int_cols: Sequence[int] = (),
                 schema: Optional[TabularSchema] = None):
        self.fcfg = fcfg
        self.schema = schema or (TabularSchema(cat_cols, int_cols)
                                 if (cat_cols or int_cols) else None)
        self.artifacts: Optional[ForestArtifacts] = None

    def _require_artifacts(self) -> ForestArtifacts:
        if self.artifacts is None:
            raise RuntimeError("fit() or load() a model first")
        return self.artifacts

    def fit(self, X, y=None, *, seed: int = 0,
            checkpoint_dir: Optional[str] = None, resume: bool = False,
            ensembles_per_batch: int = 0,
            device: Optional[Device] = None) -> "TabularGenerator":
        """Train on ``device`` (``None``: the GPU, or raise; ``"cpu"`` runs
        the plain PyTorch path). A schema one-hot/integer-encodes the raw
        rows first. The other arguments go to :func:`fit_artifacts`."""
        if self.schema is not None:
            self.schema.fit(X)
            X = self.schema.encode(X)
        self.artifacts = fit_artifacts(
            X, y, self.fcfg, seed=seed, checkpoint_dir=checkpoint_dir,
            resume=resume, ensembles_per_batch=ensembles_per_batch,
            device=device)
        return self

    def generate(self, n: int, *, sampler: Optional[str] = None,
                 seed: int = 0, pad_to: Optional[int] = None):
        """``generate_async(...).result()``: the synchronous path and the
        in-flight path share one decode path by construction."""
        return self.generate_async(n, sampler=sampler, seed=seed,
                                   pad_to=pad_to).result()

    def generate_async(self, n: int, *, sampler: Optional[str] = None,
                       seed: int = 0, pad_to: Optional[int] = None):
        """Non-blocking generate: enqueues the device work and returns a
        handle whose ``result()`` finishes the call (wait for the device,
        unpad/shuffle, schema decode)."""
        handle = _sample_async(self._require_artifacts(), n, sampler=sampler,
                               seed=seed, pad_to=pad_to)
        if self.schema is None:
            return handle
        return _DecodingHandle(handle, self.schema)

    def impute(self, X_missing, y=None, *, seed: int = 0,
               refine_rounds: int = 3):
        art = self._require_artifacts()
        if self.schema is None:
            return _impute(art, X_missing, y, seed=seed,
                           refine_rounds=refine_rounds)
        Z = self.schema.encode_with_missing(X_missing)
        filled = _impute(art, Z, y, seed=seed, refine_rounds=refine_rounds)
        out = self.schema.decode(filled)
        # observed raw cells are authoritative — only NaN cells get imputed
        X_missing = np.asarray(X_missing)
        return np.where(_isnan(X_missing), out, X_missing)

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> str:
        extra = {"schema": self.schema.to_dict()} if self.schema else {}
        return self._require_artifacts().save(path, extra_meta=extra)

    @classmethod
    def load(cls, path: str, *, device: Optional[Device] = None
             ) -> "TabularGenerator":
        """Load a saved generator onto ``device`` (``None``: the GPU, or
        raise; ``"cpu"`` runs the plain PyTorch path)."""
        meta = ForestArtifacts.load_meta(path)
        artifacts = ForestArtifacts.load(path, meta=meta, device=device)
        schema = (TabularSchema.from_dict(meta["schema"])
                  if meta.get("schema") else None)
        gen = cls(artifacts.config, schema=schema)
        gen.artifacts = artifacts
        return gen
