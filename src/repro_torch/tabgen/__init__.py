"""Tabular generation in PyTorch (ForestFlow / ForestDiffusion).

Layers, bottom-up:

* :mod:`repro_torch.tabgen.artifacts`  — :class:`ForestArtifacts`, the
  trained model as tensors on one device, with ``save``/``load`` in the JAX
  package's format and :func:`artifacts_from_numpy`.
* :mod:`repro_torch.tabgen.fitting`    — :func:`fit_artifacts` and
  :func:`extend_artifacts`: the single-device and the sharded trainer
  (out-of-core stores), with streaming checkpoints, resume and warm start.
* :mod:`repro_torch.tabgen.samplers`   — the named solver registry
  (``euler``/``heun`` for flow, ``ddim``/``em`` for diffusion).
* :mod:`repro_torch.tabgen.sampling`   — :func:`sample` and
  :func:`sample_async`: one class-batched solve per call.
* :mod:`repro_torch.tabgen.imputation` — :func:`impute`.
* :mod:`repro_torch.tabgen.facade`     — :class:`TabularGenerator`.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
from repro_torch.tabgen.artifacts import (  # noqa: F401
    ForestArtifacts, artifacts_from_numpy)
from repro_torch.tabgen.facade import TabularGenerator  # noqa: F401
from repro_torch.tabgen.fitting import (  # noqa: F401
    extend_artifacts, fit_artifacts)
from repro_torch.tabgen.imputation import impute  # noqa: F401
from repro_torch.tabgen.samplers import (  # noqa: F401
    default_sampler, get_sampler, list_samplers, register_sampler)
from repro_torch.tabgen.sampling import (  # noqa: F401
    SampleHandle, sample, sample_async, sample_labels, sample_loop_reference)
