"""TabularGenerator: schema-aware fit / generate / impute / save / load.

The front door for tabular data in the port. Composes:

* :class:`TabularSchema` — categorical columns are one-hot encoded before
  fitting and re-argmaxed after generation, integer columns rounded and
  clipped;
* :func:`fit_artifacts` — the ensemble trainer: single-device, or sharded
  over a mesh of ranks and from an out-of-core dataset store;
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
from repro_torch.tabgen.fitting import _is_store, fit_artifacts
from repro_torch.tabgen.imputation import check_impute_inputs
from repro_torch.tabgen.imputation import impute as _impute
from repro_torch.tabgen.sampling import sample_async as _sample_async


class _DecodingHandle:
    """Schema-aware wrapper over an in-flight sample: decode on resolve.
    Trace context (``tag`` / ``batch_id`` / ``trace_ids``) and the copy's
    ``ready`` event pass through to the wrapped
    :class:`~repro_torch.tabgen.sampling.SampleHandle`."""

    def __init__(self, handle, schema: TabularSchema):
        self._handle = handle
        self._schema = schema

    def result(self):
        X, y = self._handle.result()
        return self._schema.decode(X), y

    def tag(self, **kwargs):
        self._handle.tag(**kwargs)
        return self

    @property
    def batch_id(self):
        return self._handle.batch_id

    @property
    def trace_ids(self):
        return self._handle.trace_ids

    @property
    def ready(self):
        return self._handle.ready


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
            ensembles_per_batch: int = 0, mesh=None,
            device: Optional[Device] = None) -> "TabularGenerator":
        """Train on ``device`` (``None``: the GPU, or raise; ``"cpu"`` runs
        the plain PyTorch path). A schema one-hot/integer-encodes the raw
        rows first, so a schema-aware fit takes rows in memory, not a
        dataset store. The other arguments go to :func:`fit_artifacts`
        (``mesh`` to its sharded trainer)."""
        if self.schema is not None:
            if _is_store(X):
                raise ValueError(
                    "schema-aware fit needs in-memory rows to encode; fit a "
                    "store of already-encoded rows without a schema")
            self.schema.fit(X)
            X = self.schema.encode(X)
        self.artifacts = fit_artifacts(
            X, y, self.fcfg, seed=seed, checkpoint_dir=checkpoint_dir,
            resume=resume, ensembles_per_batch=ensembles_per_batch,
            mesh=mesh, device=device)
        return self

    def generate(self, n: int, *, sampler: Optional[str] = None,
                 seed: int = 0, pad_to: Optional[int] = None, mesh=None):
        """``generate_async(...).result()``: the synchronous path and the
        in-flight path share one decode path by construction."""
        return self.generate_async(n, sampler=sampler, seed=seed,
                                   pad_to=pad_to, mesh=mesh).result()

    def generate_async(self, n: int, *, sampler: Optional[str] = None,
                       seed: int = 0, pad_to: Optional[int] = None,
                       mesh=None):
        """Non-blocking generate: enqueues the device work and returns a
        handle whose ``result()`` finishes the call (wait for the rows,
        schema decode). ``mesh`` (``"auto"`` | DeviceMesh | None) shards
        the solve over a mesh of ranks, every rank making the same call;
        the rows equal the unsharded call's on the same device type."""
        handle = _sample_async(self._require_artifacts(), n, sampler=sampler,
                               seed=seed, pad_to=pad_to, mesh=mesh)
        if self.schema is None:
            return handle
        return _DecodingHandle(handle, self.schema)

    def impute(self, X_missing, y=None, *, seed: int = 0,
               refine_rounds: int = 3, mesh=None):
        """Fill the NaN cells of ``X_missing``. ``mesh`` imputes on a mesh
        of ranks, every rank making the same call (see
        :func:`~repro_torch.tabgen.impute`); the rows equal the unsharded
        call's on the same device type."""
        Z = self.encode_missing(X_missing, y)
        filled = _impute(self._require_artifacts(), Z, y, seed=seed,
                         refine_rounds=refine_rounds, mesh=mesh)
        return self.decode_imputed(X_missing, filled)

    def encode_missing(self, X_missing, y=None) -> np.ndarray:
        """``X_missing`` as the model's rows (schema-encoded, NaN cells
        kept), checked with ``y`` against the model
        (:func:`~repro_torch.tabgen.imputation.check_impute_inputs`)."""
        Z = (X_missing if self.schema is None
             else self.schema.encode_with_missing(X_missing))
        return check_impute_inputs(self._require_artifacts(), Z, y)[0]

    def decode_imputed(self, X_missing, filled: np.ndarray):
        """The imputed model rows ``filled`` as ``X_missing``'s rows."""
        if self.schema is None:
            return filled
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
