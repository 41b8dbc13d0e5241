"""Forest serving front end: warm tabular generation + imputation.

The port's twin of the JAX package's ``repro.launch.serve_forest``: a thin
single-model front end over the :mod:`repro_torch.serving` control plane —
a one-entry :class:`~repro_torch.serving.ModelRegistry`, an
:class:`~repro_torch.serving.AdmissionController` (permissive by default:
no rate limits, generous queue bounds) and the
:class:`~repro_torch.serving.InflightScheduler`. The multi-model,
multi-tenant HTTP tier lives in :mod:`repro_torch.launch.serve_http`; both
share every control-plane behaviour by construction.

* ``warmup()`` runs one call per (sampler, bucket) through the same
  :class:`TabularGenerator` facade that serves requests (it loads the
  kernel libraries and primes the caching allocators);
* ``submit()`` queues a request and returns a future; the scheduler
  coalesces concurrent same-sampler requests into one bucketed device
  dispatch and keeps admitting the next batch while the current one is in
  flight (a waiter thread resolves futures);
* ``generate()`` stays synchronous and exactly per-(n, seed) deterministic;
* unknown sampler names raise ``ValueError`` at ``submit()``/``generate()``
  time, to the caller;
* ``stats`` is a view over one shared :class:`~repro_torch.obs.MetricsRegistry`
  (``server.metrics``) fed by ``serve.queue``/``serve.device``/``serve.sync``
  spans on ``server.tracer``; ``--metrics-dump`` writes the same numbers as
  Prometheus text and ``--trace-jsonl`` dumps the span ring.

The server runs on ``device`` (``None``: the GPU, or raise; ``"cpu"``: the
plain PyTorch path). CPU demo (fits a small model, saves, loads, serves):

  PYTHONPATH=src python -m repro_torch.launch.serve_forest --demo \
      --requests 16 --device cpu

``--mesh DxM`` serves sharded over a ``(data, model)`` mesh of ranks, one
process each (``torchrun``): rank 0 serves, the other ranks replay its
steps (:mod:`repro_torch.serving.spmd`) until it stops. ``1x1`` without
``torchrun`` makes a one-rank group itself (NCCL on the GPU):

  PYTHONPATH=src torchrun --nproc-per-node 2 -m \
      repro_torch.launch.serve_forest --mesh 2x1 --device cpu --demo
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.dispatch import Device
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving import (AdmissionController, InflightScheduler,
                                 ModelRegistry)
from repro_torch.serving.registry import DEFAULT_BUCKETS
from repro_torch.tabgen import ForestArtifacts, TabularGenerator


class ForestServer:
    """Single-host, single-model tabular-generation server.

    A convenience wrapper: one registered model named ``"default"``, the
    in-flight scheduler underneath. Reach into ``server.registry`` /
    ``server.scheduler`` for the multi-model and admission knobs (e.g.
    ``server.registry.swap("default", new_artifacts)`` for a zero-downtime
    artifact hot-swap, from any thread, on a mesh too).

    ``mesh`` (``None`` | ``DeviceMesh`` | ``"auto"``) serves sharded: build
    the server on rank 0 while every other rank builds a
    ``ModelRegistry(mesh=...)`` and runs
    :func:`~repro_torch.serving.spmd.follow`; :meth:`close` releases them.
    """

    MODEL = "default"

    def __init__(self, artifacts: ForestArtifacts, *,
                 device: Optional[Device] = None,
                 samplers: Sequence[str] = (),
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 schema=None, mesh=None,
                 max_coalesce_rows: Optional[int] = None,
                 coalesce_window_s: float = 0.002,
                 inflight_depth: int = 2,
                 sync_resolve: bool = False,
                 admission: Optional[AdmissionController] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 slo=None, slo_error_budget: float = 0.01, slow_log=None):
        # one registry + tracer shared by every component of this server:
        # scheduler, admission, and model registry export one family set
        self.metrics = metrics or MetricsRegistry()
        self.tracer = tracer or Tracer()
        self.registry = ModelRegistry(device=device, mesh=mesh,
                                      buckets=buckets, metrics=self.metrics)
        self.registry.register(self.MODEL, artifacts, schema=schema,
                               samplers=samplers)
        self.scheduler = InflightScheduler(
            self.registry,
            admission or AdmissionController(metrics=self.metrics),
            max_coalesce_rows=max_coalesce_rows,
            coalesce_window_s=coalesce_window_s,
            inflight_depth=inflight_depth, sync_resolve=sync_resolve,
            metrics=self.metrics, tracer=self.tracer,
            slo=slo, slo_error_budget=slo_error_budget, slow_log=slow_log)
        self.device = self.registry.device
        self.mesh = self.registry.mesh
        self.schema = schema

    @classmethod
    def from_path(cls, path: str, **kw) -> "ForestServer":
        gen = TabularGenerator.load(path, device="cpu")
        return cls(gen.artifacts, schema=gen.schema, **kw)

    # -- model-facing views --------------------------------------------------

    @property
    def _handle(self):
        return self.registry.peek(self.MODEL)

    @property
    def artifacts(self) -> ForestArtifacts:
        return self._handle.artifacts

    @property
    def samplers(self) -> Tuple[str, ...]:
        return self._handle.samplers

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._handle.buckets

    @property
    def max_coalesce_rows(self) -> int:
        return self.scheduler.max_coalesce_rows

    @property
    def stats(self) -> Dict[str, float]:
        return self.scheduler.stats

    # -- request path -------------------------------------------------------

    def _validate_sampler(self, sampler: Optional[str]) -> str:
        name = sampler or self.samplers[0]
        if name not in self.samplers:
            raise ValueError(
                f"server does not serve sampler {name!r}; "
                f"served: {list(self.samplers)}")
        return name

    def warmup(self) -> float:
        """Run every (sampler, bucket) once; returns wall seconds."""
        dt = self.registry.warmup(self.MODEL)
        self.scheduler.record_warm(dt)
        return dt

    def generate(self, n: int, *, sampler: Optional[str] = None,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous path: exact per-(n, seed) deterministic output."""
        name = self._validate_sampler(sampler)
        handle = self.registry.handle(self.MODEL)
        with self.tracer.span("serve.sync", model=self.MODEL, sampler=name,
                              rows=int(n)) as sp:
            X, y = handle.generate(n, name, seed=seed)
        self.scheduler.record_sync(n=n, sampler=name, tenant="default",
                                   wall_s=sp.duration_s)
        return X, y

    def submit(self, n: int, *, sampler: Optional[str] = None,
               tenant: str = "default", priority: str = "interactive",
               deadline_s: Optional[float] = None) -> Future:
        """Queue a generation request; resolves to ``(X, y)``.

        Concurrent submissions coalesce into shared device dispatches, and
        the next batch is admitted while the current one is in flight.
        Unknown samplers raise ``ValueError`` here; admission rejections
        raise ``RateLimited`` / ``QueueFull`` here too.
        """
        return self.scheduler.submit(
            int(n), model=self.MODEL,
            sampler=self._validate_sampler(sampler),
            tenant=tenant, priority=priority, deadline_s=deadline_s)

    def start(self) -> None:
        """Start the scheduler threads (idempotent; ``submit`` auto-starts)."""
        self.scheduler.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Drain the queue and stop the scheduler threads."""
        self.scheduler.stop(timeout)

    def close(self, timeout: float = 10.0) -> None:
        """Stop serving; on a mesh, release the other ranks too."""
        self.stop(timeout)
        self.registry.close()

    def _serve_batch(self, batch) -> None:
        """Dispatch + resolve one pre-formed batch synchronously (a test
        seam; production traffic goes through ``submit``)."""
        self.scheduler.serve_batch_sync(batch)

    # -- misc ---------------------------------------------------------------

    def impute(self, X_missing, y=None, *, seed: int = 0,
               refine_rounds: int = 3) -> np.ndarray:
        return self.registry.handle(self.MODEL).impute(
            X_missing, y, seed=seed, refine_rounds=refine_rounds)

    def rows_per_sec(self) -> float:
        return self.scheduler.rows_per_sec()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _demo_artifacts(path: str, device: Optional[Device] = None) -> str:
    """Fit a small two-moons model on ``device`` and save it — the
    zero-setup demo (the JAX package's demo configuration)."""
    from repro_torch.config import ForestConfig
    from repro_torch.data.tabular import two_moons
    X, y = two_moons(600, seed=0)
    fcfg = ForestConfig(method="flow", n_t=8, duplicate_k=10, n_trees=20,
                        max_depth=4, n_bins=32, reg_lambda=1.0)
    gen = TabularGenerator(fcfg).fit(X, y, seed=0, device=device)
    return gen.save(path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default=None,
                    help="base path of a saved model (.npz/.json pair)")
    ap.add_argument("--demo", action="store_true",
                    help="fit+save a small two-moons model first")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the GPU")
    ap.add_argument("--sampler", default=None)
    ap.add_argument("--buckets", default="64,256,1024")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync", action="store_true",
                    help="serve via the synchronous generate() path instead "
                         "of the micro-batching queue")
    ap.add_argument("--drain", action="store_true",
                    help="disable in-flight batching (drain-then-serve "
                         "reference behaviour)")
    ap.add_argument("--coalesce-window-ms", type=float, default=2.0)
    ap.add_argument("--mesh", default="none",
                    help="'auto' | 'none' | DxM: shard the solve over D x M "
                         "ranks (classes on model, rows on data); more than "
                         "one rank needs torchrun")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="after serving, write the metrics registry as "
                         "Prometheus text ('-' for stdout)")
    ap.add_argument("--trace-jsonl", default=None, metavar="PATH",
                    help="after serving, dump the span ring as JSON lines")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.launch.train_forest import _init_from_env, parse_mesh
    device = resolve_device(args.device)
    owned = _init_from_env(device)
    try:
        mesh, made = parse_mesh(args.mesh, device)
        owned = owned or made
        if mesh is not None and dist.get_rank() > 0:
            return _follow(mesh, device, args)
        return _serve(args, device, mesh)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _follow(mesh, device, args):
    """Rank > 0 of a mesh: replay rank 0's steps until it stops."""
    from repro_torch.serving.spmd import follow
    registry = ModelRegistry(device=device, mesh=mesh, buckets=tuple(
        int(b) for b in args.buckets.split(",")))
    t0 = time.time()
    n = follow(registry)
    print(f"rank {registry.stream.rank}: replayed {n} batch(es) in "
          f"{time.time() - t0:.2f}s", flush=True)


def _serve(args, device, mesh):
    path = args.artifacts
    if args.demo or path is None:
        path = _demo_artifacts(os.path.join(tempfile.mkdtemp(), "demo"),
                               device)
        print(f"demo artifacts saved to {path}")

    samplers = (args.sampler,) if args.sampler else ()
    buckets = tuple(int(b) for b in args.buckets.split(","))
    server = ForestServer.from_path(
        path, device=device, mesh=mesh, samplers=samplers, buckets=buckets,
        coalesce_window_s=args.coalesce_window_ms / 1e3,
        sync_resolve=args.drain)
    try:
        _demo_traffic(server, args, device, buckets)
    finally:
        server.close()
    return server


def _demo_traffic(server, args, device, buckets):
    warm = server.warmup()
    where = str(device)
    if server.mesh is not None:
        shape = dict(zip(server.mesh.mesh_dim_names, server.mesh.shape))
        d = server.registry.describe()[server.MODEL]
        where += (f" on mesh {shape} ({d['nbytes']} model bytes, "
                  f"{d['rank_nbytes']} on this rank)")
    print(f"warmed {len(server.samplers)} sampler(s) x {len(buckets)} "
          f"bucket(s) in {warm:.2f}s on {where}")

    rng = np.random.default_rng(args.seed)
    sizes = rng.integers(1, max(buckets) + 1, size=args.requests)
    if args.sync:
        for i, n in enumerate(sizes):
            server.generate(int(n), seed=args.seed + i)
    else:
        futs = [server.submit(int(n)) for n in sizes]
        for f, n in zip(futs, sizes):
            X, y = f.result(timeout=300)
            if len(X) != n:
                raise RuntimeError(f"request of {n} rows got {len(X)}")
        server.stop()
    s = server.stats
    print(f"served {int(s['requests'])} requests / {int(s['rows'])} rows "
          f"in {int(s['batches'])} dispatch(es) "
          f"({int(s['coalesced_requests'])} coalesced) "
          f"in {s['gen_s']:.3f}s -> {server.rows_per_sec():.0f} rows/sec; "
          f"queue-wait {s['queue_wait_s']:.3f}s vs device {s['device_s']:.3f}s")
    if args.metrics_dump:
        from repro_torch.launch.metrics import dump
        dump(args.metrics_dump, registries=[server.metrics])
    if args.trace_jsonl:
        n_spans = server.tracer.export_jsonl(args.trace_jsonl)
        print(f"wrote {n_spans} spans to {args.trace_jsonl}")


if __name__ == "__main__":
    main()
