"""Stdlib-only HTTP front end over the :mod:`repro_torch.serving` control
plane: the port's twin of the JAX package's ``repro.launch.serve_http``,
with the same routes, status codes and JSON keys.

Drives the heavy-traffic story end to end: many named models hot in one
process (LRU device placement), interactive/bulk priority classes,
per-tenant rate limits with explicit backpressure, in-flight micro-batched
dispatch, request-scoped tracing — all behind these endpoints:

  POST /v1/generate   {"model": "demo", "n": 128, "sampler": "euler",
                       "tenant": "t0", "priority": "interactive",
                       "deadline_ms": 500, "timeout_s": 60}
      -> 200 {"model", "version", "n", "rows", "labels", "request_id"}
      -> 400 bad arguments / unknown sampler     (ValueError, eager)
      -> 404 unknown model
      -> 429 + Retry-After header                (RateLimited / QueueFull)
      -> 504 deadline exceeded before dispatch
      Every response (success or error) carries the request's trace id in
      the body (``request_id``) and the ``X-Repro-Request-Id`` header.
  GET  /v1/trace/<id> the per-request timeline from the span ring: the
                      ``serve.queue`` span (admission, queue depth, wait,
                      batch id) plus the linked ``serve.device`` batch
                      span (device time, sync, co-batched request count).
                      404 when the id is unknown *or evicted* — the ring
                      is bounded; scrape traces promptly.
  POST /debug/profile {"duration_ms": 500} — bounded torch.profiler capture
                      (a Chrome trace, ``trace.json``) into the server's
                      --profile-dir (403 when disabled,
                      409 while another capture runs, admin-token guarded
                      via the X-Repro-Admin-Token header when configured)
  POST /v1/impute     {"model": "demo", "rows": [[1.0, null, ...]],
                       "labels": [...]}   — null marks a missing cell;
      served synchronously (bridge-clamped solve is per-row conditional,
      not micro-batched) but still metered against the tenant's row bucket
  GET  /v1/models     registry contents: hot/cold, bytes, versions, data
                      lineage (source-store fingerprint/version), stats
  POST /v1/models/<name>/reload   {"path": "..."} (path optional when the
                      model was registered from one) — zero-downtime
                      hot-swap of freshly saved artifacts into the running
                      registry; the receiving end of
                      ``repro_torch.launch.refresh``
  GET  /healthz       {"ok": true} once the plane is serving
  GET  /statz         scheduler + admission + registry stats (per-sampler,
                      per-tenant, queue-wait vs device-time breakdown)
  GET  /metrics       the same numbers in Prometheus text format — /statz
                      is a view over the one :mod:`repro_torch.obs`
                      registry behind this endpoint, so the two cannot
                      disagree. The ``resource_*`` gauges are the port's
                      own (CUDA allocator bytes, kernel libraries loaded;
                      see ``repro_torch.obs.resources``)

Every model serves on ``--device`` (default: the GPU, or exit with an
error; ``cpu`` runs the plain PyTorch path). Run a demo instance on the
CPU (fits a tiny model, registers it as "demo"):

  PYTHONPATH=src python -m repro_torch.launch.serve_http --demo --port 8099 \
      --device cpu

Multiple models on the GPU, with per-tenant limits:

  PYTHONPATH=src python -m repro_torch.launch.serve_http \
      --model calo=calo_model --model fraud=fraud_model \
      --rate 500000 --burst 2000000

Sharded over a ``(data, model)`` mesh of ranks (``--mesh DxM`` under
``torchrun``; ``1x1`` makes a one-rank group itself): rank 0 serves HTTP,
the other ranks replay its steps until it shuts down
(:mod:`repro_torch.serving.spmd`); an admin reload reaches every rank. If
the ranks fall out of step (a failure after a command was published), rank
0 stops serving and exits non-zero:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m \
      repro_torch.launch.serve_http --demo --device cpu --mesh 2x1 --port 0

The server prints ``serving on http://HOST:PORT`` once ready (``--port 0``
binds an ephemeral port — the line is the machine-readable contract the CI
smoke and the tests parse).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.obs import CONTENT_TYPE as _METRICS_CONTENT_TYPE
from repro_torch.obs import (MetricsRegistry, ProfileInProgress, Profiler,
                             ResourceMonitor, SlowLog, Tracer,
                             render_prometheus)
from repro_torch.serving import (AdmissionController, DeadlineExceeded,
                                 InflightScheduler, ModelRegistry, QueueFull,
                                 RateLimited, UnknownModel)


class ServingApp:
    """The control plane bundle the HTTP handler dispatches into.

    Framework-free by design: tests drive it in-process, the CLI wraps it
    in a :class:`ThreadingHTTPServer`.
    """

    def __init__(self, registry: ModelRegistry,
                 admission: Optional[AdmissionController] = None, *,
                 coalesce_window_s: float = 0.002,
                 max_coalesce_rows: Optional[int] = None,
                 default_timeout_s: float = 300.0,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 model_paths: Optional[dict] = None,
                 slo: Optional[Dict[str, float]] = None,
                 slo_error_budget: float = 0.01,
                 slow_log: Optional[SlowLog] = None,
                 profiler: Optional[Profiler] = None,
                 monitor: Optional[ResourceMonitor] = None,
                 admin_token: Optional[str] = None):
        self.registry = registry
        self.admission = admission or AdmissionController(metrics=metrics)
        self.scheduler = InflightScheduler(
            registry, self.admission,
            coalesce_window_s=coalesce_window_s,
            max_coalesce_rows=max_coalesce_rows,
            metrics=metrics, tracer=tracer,
            slo=slo, slo_error_budget=slo_error_budget, slow_log=slow_log)
        self.default_timeout_s = float(default_timeout_s)
        # name -> artifact path of disk-registered models: the default a
        # bodyless POST /v1/models/<name>/reload re-reads from
        self.model_paths = dict(model_paths or {})
        # GET /v1/trace reads the scheduler's tracer even when the caller
        # left this app on the private default pair
        self.tracer = tracer or self.scheduler.tracer
        self.profiler = profiler
        self.monitor = monitor
        self.admin_token = admin_token
        self._m_reloads = (metrics or registry.metrics).counter(
            "serve_reloads", "Admin model hot-swaps via "
            "POST /v1/models/<name>/reload", ("model", "status"))

    # -- endpoint bodies (status_code, payload) ------------------------------

    def generate(self, body: dict) -> Tuple[int, dict]:
        # the trace id is minted at ingress — before validation — so even
        # a rejected request is addressable in logs and error responses
        rid = uuid.uuid4().hex[:16]
        try:
            n = int(body.get("n", 0))
            if n <= 0:
                raise ValueError(f"n={body.get('n')!r}: need a positive row count")
            model = str(body.get("model", "default"))
            deadline_ms = body.get("deadline_ms")
            fut = self.scheduler.submit(
                n, model=model, sampler=body.get("sampler"),
                tenant=str(body.get("tenant", "default")),
                priority=str(body.get("priority", "interactive")),
                deadline_s=None if deadline_ms is None
                else float(deadline_ms) / 1e3,
                request_id=rid)
        except UnknownModel:
            return 404, {"error": f"unknown model {body.get('model')!r}",
                         "models": self.registry.names(),
                         "request_id": rid}
        except (RateLimited, QueueFull) as exc:
            return 429, {"error": str(exc),
                         "retry_after_s": exc.retry_after_s,
                         "request_id": rid}
        except (ValueError, TypeError) as exc:
            return 400, {"error": str(exc), "request_id": rid}
        try:
            X, y = fut.result(timeout=float(
                body.get("timeout_s", self.default_timeout_s)))
        except DeadlineExceeded as exc:
            return 504, {"error": str(exc), "request_id": rid}
        handle = self.registry.peek(model)
        return 200, {"model": model, "version": handle.version, "n": n,
                     "rows": np.asarray(X).tolist(),
                     "labels": np.asarray(y).tolist(),
                     "request_id": rid}

    def impute(self, body: dict) -> Tuple[int, dict]:
        try:
            rows = body.get("rows")
            if not rows:
                raise ValueError("rows: need a non-empty list of rows "
                                 "(null marks a missing cell)")
            X = np.array([[np.nan if v is None else float(v) for v in row]
                          for row in rows])
            y = body.get("labels")
            model = str(body.get("model", "default"))
            tenant = str(body.get("tenant", "default"))
            handle = self.registry.peek(model)  # 404 before metering
            if y is None and handle.artifacts.n_y > 1:
                raise ValueError(
                    f"model {model!r} is class-conditional "
                    f"({handle.artifacts.n_y} classes): imputation needs "
                    "\"labels\"")
            self.admission.charge(tenant, len(X))
            handle = self.registry.handle(model)
            filled = handle.impute(
                X, None if y is None else np.asarray(y),
                seed=int(body.get("seed", 0)),
                refine_rounds=int(body.get("refine_rounds", 3)))
        except UnknownModel:
            return 404, {"error": f"unknown model {body.get('model')!r}",
                         "models": self.registry.names()}
        except RateLimited as exc:
            return 429, {"error": str(exc),
                         "retry_after_s": exc.retry_after_s}
        except (ValueError, TypeError) as exc:
            return 400, {"error": str(exc)}
        return 200, {"model": model, "version": handle.version,
                     "rows": np.asarray(filled).tolist()}

    def models(self) -> Tuple[int, dict]:
        return 200, {"models": self.registry.describe(),
                     "hot": self.registry.hot_names()}

    def reload_model(self, name: str, body: dict) -> Tuple[int, dict]:
        """Zero-downtime hot-swap: load freshly saved artifacts from disk
        and :meth:`ModelRegistry.swap` them under ``name``. In-flight
        requests finish on the old version; no request is dropped, and no
        kernel is built or loaded. The live end of the
        ``repro_torch.launch.refresh`` freshness loop. On a mesh the swap
        reaches every rank."""
        from repro_torch.tabgen import TabularGenerator
        try:
            path = body.get("path") or self.model_paths.get(name)
            if not path:
                raise ValueError(
                    f"model {name!r} was not registered from a path; the "
                    "reload body must carry {\"path\": ...}")
            self.registry.peek(name)            # 404 before touching disk
            gen = TabularGenerator.load(path, device="cpu")
            handle = self.registry.swap(name, gen.artifacts,
                                        schema=gen.schema,
                                        keep_schema=gen.schema is None,
                                        path=path)
        except UnknownModel:
            self._m_reloads.inc(1, model=name, status="unknown_model")
            return 404, {"error": f"unknown model {name!r}",
                         "models": self.registry.names()}
        except (OSError, ValueError, TypeError, KeyError) as exc:
            self._m_reloads.inc(1, model=name, status="error")
            return 400, {"error": f"reload of {name!r} from "
                                  f"{body.get('path') or path!r} failed: "
                                  f"{exc}"}
        self.model_paths[name] = path
        self._m_reloads.inc(1, model=name, status="ok")
        lineage = self.registry.describe()[name]["lineage"]
        return 200, {"model": name, "version": handle.version,
                     "path": path, "nbytes": handle.nbytes,
                     "lineage": lineage}

    def trace(self, request_id: str) -> Tuple[int, dict]:
        """Per-request timeline from the span ring: the request's own
        ``serve.queue`` span plus every ``serve.device`` batch span that
        *links* it.  The summary reconciles with ``/statz`` because both
        read the same spans/instruments."""
        spans = self.tracer.trace(request_id)
        if not spans:
            return 404, {"error": f"unknown (or evicted) request id "
                                  f"{request_id!r}; the span ring is "
                                  "bounded — scrape traces promptly",
                         "request_id": request_id}
        summary: dict = {}
        for s in spans:
            if s.name == "serve.queue" and s.trace_id == request_id:
                summary.update({k: s.attrs[k] for k in
                                ("model", "sampler", "tenant", "priority",
                                 "rows", "admission_s", "queue_depth",
                                 "batch_id", "outcome") if k in s.attrs})
                summary["queue_wait_s"] = s.duration_s
        for s in spans:
            if s.name == "serve.device" and request_id in s.links:
                summary["batch"] = {
                    "batch_id": s.attrs.get("batch_id"),
                    "rows": s.attrs.get("rows"),
                    "requests": s.attrs.get("requests"),
                    "device_s": s.duration_s,
                    "sync_s": s.attrs.get("sync_s"),
                    "outcome": s.attrs.get("outcome"),
                }
        return 200, {"request_id": request_id,
                     "spans": [s.to_dict() for s in spans],
                     "summary": summary}

    def profile(self, body: dict) -> Tuple[int, dict]:
        """Bounded on-demand ``torch.profiler`` capture (POST /debug/profile).
        One capture at a time; the duration is clamped server-side."""
        if self.profiler is None:
            return 403, {"error": "profiling disabled; start serve_http "
                                  "with --profile-dir"}
        try:
            duration_s = float(body.get("duration_ms", 200.0)) / 1e3
            result = self.profiler.capture(duration_s)
        except ProfileInProgress as exc:
            return 409, {"error": str(exc)}
        except (ValueError, TypeError) as exc:
            return 400, {"error": str(exc)}
        except Exception as exc:  # noqa: BLE001 — surfaced, not raised
            return 500, {"error": f"profiler capture failed: {exc}"}
        return 200, result

    def healthz(self) -> Tuple[int, dict]:
        return 200, {"ok": True, "models": self.registry.names()}

    def statz(self) -> Tuple[int, dict]:
        return 200, {"scheduler": self.scheduler.stats_snapshot(),
                     "admission": self.admission.stats_snapshot(),
                     "registry": self.registry.stats_snapshot()}

    def metrics_text(self) -> Tuple[int, str]:
        """Prometheus text over every component registry.  When the caller
        wired one shared :class:`~repro_torch.obs.MetricsRegistry` through (as
        ``main()`` does) this is a single registry; components left on
        private registries are unioned — instrument names are namespaced
        per subsystem, so families never collide."""
        regs = [self.scheduler.metrics, self.admission.metrics,
                self.registry.metrics]
        if self.monitor is not None:
            regs.append(self.monitor.metrics)  # dedup by id in the renderer
        return 200, render_prometheus(*regs)

    def stop(self) -> None:
        """Stop the scheduler; on a mesh, release the other ranks."""
        self.scheduler.stop()
        self.registry.close()


def make_handler(app: ServingApp, *, quiet: bool = True):
    class Handler(BaseHTTPRequestHandler):
        server_version = "repro-serving/1.0"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: A003
            if not quiet:
                BaseHTTPRequestHandler.log_message(self, fmt, *args)

        def _reply(self, status: int, payload: dict,
                   retry_after: Optional[float] = None) -> None:
            blob = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            if retry_after is not None:
                self.send_header("Retry-After", f"{retry_after:.3f}")
            rid = payload.get("request_id") if isinstance(payload, dict) else None
            if rid:
                self.send_header("X-Repro-Request-Id", str(rid))
            self.end_headers()
            self.wfile.write(blob)

        def _reply_text(self, status: int, text: str,
                        content_type: str) -> None:
            blob = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):  # noqa: N802
            if self.path == "/metrics":
                status, text = app.metrics_text()
                self._reply_text(status, text, _METRICS_CONTENT_TYPE)
                return
            if self.path.startswith("/v1/trace/"):
                rid = self.path[len("/v1/trace/"):]
                self._reply(*app.trace(rid))
                return
            routes = {"/healthz": app.healthz, "/statz": app.statz,
                      "/v1/models": app.models}
            fn = routes.get(self.path)
            if fn is None:
                self._reply(404, {"error": f"no route {self.path!r}",
                                  "routes": sorted(routes)
                                  + ["/metrics", "/v1/trace/<id>"]})
                return
            self._reply(*fn())

        def do_POST(self):  # noqa: N802
            routes = {"/v1/generate": app.generate, "/v1/impute": app.impute,
                      "/debug/profile": app.profile}
            admin = {"/debug/profile"}
            fn = routes.get(self.path)
            if fn is None:
                # path-parameter admin route: /v1/models/<name>/reload
                parts = self.path.strip("/").split("/")
                if (len(parts) == 4 and parts[:2] == ["v1", "models"]
                        and parts[3] == "reload"):
                    name = parts[2]
                    fn = lambda body: app.reload_model(name, body)  # noqa: E731
            if fn is None:
                self._reply(404, {"error": f"no route {self.path!r}",
                                  "routes": sorted(routes)
                                  + ["/v1/models/<name>/reload"]})
                return
            if (self.path in admin and app.admin_token is not None
                    and self.headers.get("X-Repro-Admin-Token")
                    != app.admin_token):
                self._reply(401, {"error": "missing or wrong "
                                           "X-Repro-Admin-Token header"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as exc:
                self._reply(400, {"error": f"bad JSON body: {exc}"})
                return
            status, payload = fn(body)
            self._reply(status, payload,
                        retry_after=payload.get("retry_after_s")
                        if status == 429 else None)

    return Handler


def make_server(app: ServingApp, host: str = "127.0.0.1",
                port: int = 0, *, quiet: bool = True) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral); caller runs ``serve_forever``."""
    return ThreadingHTTPServer((host, port), make_handler(app, quiet=quiet))


def serve_in_thread(app: ServingApp, host: str = "127.0.0.1",
                    port: int = 0) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """In-process server for tests: returns (httpd, daemon thread)."""
    httpd = make_server(app, host, port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="serve-http")
    t.start()
    return httpd, t


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", action="append", default=[],
                    metavar="NAME=PATH",
                    help="register a saved artifact pair under NAME "
                         "(repeatable)")
    ap.add_argument("--demo", action="store_true",
                    help="fit+register a small two-moons model as 'demo'")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8099,
                    help="0 binds an ephemeral port (printed when ready)")
    ap.add_argument("--buckets", default="64,256,1024")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the GPU")
    ap.add_argument("--mesh", default="none",
                    help="'auto' | 'none' | DxM: serve sharded over D x M "
                         "ranks (more than one needs torchrun)")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="LRU device-placement budget over all hot models "
                         "(whole models on a mesh, as the JAX package)")
    ap.add_argument("--max-hot", type=int, default=None,
                    help="cap the number of device-placed models")
    ap.add_argument("--rate", type=float, default=None,
                    help="default per-tenant rate limit (rows/sec)")
    ap.add_argument("--burst", type=float, default=None,
                    help="per-tenant burst size in rows (default 4x rate)")
    ap.add_argument("--queue-limit-interactive", type=int, default=256)
    ap.add_argument("--queue-limit-bulk", type=int, default=1024)
    ap.add_argument("--coalesce-window-ms", type=float, default=2.0)
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the (sampler, bucket) warmup pass")
    ap.add_argument("--trace-jsonl", default=None, metavar="PATH",
                    help="on shutdown, dump the span ring (serve.queue / "
                         "serve.device / serve.sync) as JSON lines")
    ap.add_argument("--slo-interactive-ms", type=float, default=None,
                    help="latency objective for the interactive class; "
                         "requests over it count as SLO violations")
    ap.add_argument("--slo-bulk-ms", type=float, default=None,
                    help="latency objective for the bulk class")
    ap.add_argument("--slo-budget", type=float, default=0.01,
                    help="allowed violation rate (error budget); "
                         "/statz reports burn = rate / budget")
    ap.add_argument("--slow-log", default=None, metavar="PATH",
                    help="append requests over --slow-threshold-ms (their "
                         "full span timeline) to this JSONL file")
    ap.add_argument("--slow-threshold-ms", type=float, default=None,
                    help="slow-request threshold (default: the interactive "
                         "SLO objective when set, else 1000ms)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="enable POST /debug/profile; captures land in "
                         "numbered subdirectories of DIR")
    ap.add_argument("--admin-token", default=None,
                    help="require X-Repro-Admin-Token on admin endpoints "
                         "(/debug/profile)")
    ap.add_argument("--resource-interval-s", type=float, default=5.0,
                    help="ResourceMonitor sampling period for the "
                         "resource_* gauges on /metrics; 0 disables")
    ap.add_argument("--verbose", action="store_true",
                    help="log one line per HTTP request")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.launch.train_forest import _init_from_env, parse_mesh
    device = resolve_device(args.device)
    owned = _init_from_env(device)
    try:
        mesh, made = parse_mesh(args.mesh, device)
        owned = owned or made
        _main(ap, args, device, mesh)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _registry(args, device, mesh, metrics=None) -> ModelRegistry:
    return ModelRegistry(
        device=device, mesh=mesh,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        device_budget_bytes=None if args.device_budget_mb is None
        else int(args.device_budget_mb * 2**20),
        max_hot=args.max_hot, metrics=metrics)


def _main(ap, args, device, mesh):
    if mesh is not None and mesh.get_rank() > 0:
        from repro_torch.serving.spmd import follow
        n = follow(_registry(args, device, mesh))
        print(f"rank {mesh.get_rank()}: replayed {n} batch(es)", flush=True)
        return
    specs = []
    for item in args.model:
        name, _, path = item.partition("=")
        if not path:
            ap.error(f"--model {item!r}: expected NAME=PATH")
        specs.append((name, path))
    if args.demo or not specs:
        from repro_torch.launch.serve_forest import _demo_artifacts
        path = _demo_artifacts(os.path.join(tempfile.mkdtemp(), "demo"),
                               device)
        print(f"demo artifacts saved to {path}", flush=True)
        specs.append(("demo", path))

    # one shared registry + tracer across every component: GET /metrics is
    # then a single family set and /statz a view over the same instruments
    metrics = MetricsRegistry()
    tracer = Tracer(capacity=4096)
    registry = _registry(args, device, mesh, metrics)
    for name, path in specs:
        registry.register(name, path=path)
        d = registry.describe()[name]
        print(f"registered model {name!r} from {path}"
              + ("" if mesh is None else
                 f": {d['nbytes']} bytes, {d['rank_nbytes']} on this rank"),
              flush=True)
    admission = AdmissionController(
        queue_limits={"interactive": args.queue_limit_interactive,
                      "bulk": args.queue_limit_bulk},
        default_rate=None if args.rate is None
        else (args.rate, args.burst or 4 * args.rate),
        metrics=metrics)
    slo = {}
    if args.slo_interactive_ms is not None:
        slo["interactive"] = args.slo_interactive_ms / 1e3
    if args.slo_bulk_ms is not None:
        slo["bulk"] = args.slo_bulk_ms / 1e3
    slow_log = None
    if args.slow_log:
        threshold_s = (args.slow_threshold_ms / 1e3
                       if args.slow_threshold_ms is not None
                       else slo.get("interactive", 1.0))
        slow_log = SlowLog(args.slow_log, threshold_s)
        print(f"slow-log (> {threshold_s * 1e3:.0f}ms) -> {args.slow_log}",
              flush=True)
    profiler = (Profiler(args.profile_dir) if args.profile_dir else None)
    monitor = None
    if args.resource_interval_s > 0:
        monitor = ResourceMonitor(metrics,
                                  interval_s=args.resource_interval_s,
                                  admission=admission, registry=registry)
    app = ServingApp(registry, admission,
                     coalesce_window_s=args.coalesce_window_ms / 1e3,
                     metrics=metrics, tracer=tracer,
                     model_paths=dict(specs),
                     slo=slo or None, slo_error_budget=args.slo_budget,
                     slow_log=slow_log, profiler=profiler, monitor=monitor,
                     admin_token=args.admin_token)
    if not args.no_warm:
        print(f"warming {len(specs)} model(s)...", flush=True)
        dt = registry.warmup()
        app.scheduler.record_warm(dt)
        print(f"warmed in {dt:.2f}s", flush=True)
    if monitor is not None:
        # one eager pass before "serving on": the first /metrics scrape
        # already carries the resource_* gauges
        monitor.sample()
        monitor.start()

    httpd = make_server(app, args.host, args.port, quiet=not args.verbose)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port}", flush=True)
    stream = registry.stream
    if stream is not None:
        # the ranks fell out of step: stop serving
        stream.on_break = lambda: threading.Thread(
            target=httpd.shutdown, daemon=True).start()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        print("shutting down...", flush=True)
        httpd.server_close()
        app.stop()
        if monitor is not None:
            monitor.stop()
        if args.trace_jsonl:
            n = tracer.export_jsonl(args.trace_jsonl)
            print(f"wrote {n} spans to {args.trace_jsonl}", flush=True)
        print("bye", flush=True)
    if stream is not None and stream.broken is not None:
        raise SystemExit(f"the mesh's ranks fell out of step: "
                         f"{stream.broken!r}")


if __name__ == "__main__":
    main()
