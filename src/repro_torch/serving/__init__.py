"""Multi-tenant serving control plane over the port's tabgen data plane.

The port's twin of the JAX package's ``repro.serving``; each layer is its
own module:

* :mod:`repro_torch.serving.registry`  — :class:`ModelRegistry`: many named
  :class:`~repro_torch.tabgen.ForestArtifacts` hot per process, LRU device
  placement under a byte budget (host copies in pinned memory),
  zero-downtime ``swap``.
* :mod:`repro_torch.serving.admission` — :class:`AdmissionController`:
  interactive/bulk priority queues, per-tenant row-rate token buckets,
  bounded queues with reject-and-retry-after, request deadlines.
* :mod:`repro_torch.serving.scheduler` — :class:`InflightScheduler`:
  in-flight micro-batching (dispatch batch ``k+1`` while a waiter thread
  resolves batch ``k``), priority-ordered coalescing, per-sampler /
  per-tenant stats with queue-wait vs device-time breakdown.

Every layer keeps its counters on a :class:`repro_torch.obs.MetricsRegistry`
and the scheduler times the request path with :class:`repro_torch.obs.Tracer`
spans (``serve.queue`` / ``serve.device`` / ``serve.sync``).

Front ends: :class:`repro_torch.launch.serve_forest.ForestServer`
(single-model, in-process) and :mod:`repro_torch.launch.serve_http`
(multi-model HTTP API).
"""
from repro_torch.serving.admission import (  # noqa: F401
    PRIORITIES, AdmissionController, AdmissionError, DeadlineExceeded,
    QueueFull, RateLimited, TokenBucket)
from repro_torch.serving.registry import (  # noqa: F401
    DEFAULT_BUCKETS, ModelHandle, ModelRegistry, UnknownModel)
from repro_torch.serving.scheduler import (  # noqa: F401
    InflightScheduler, Request)
