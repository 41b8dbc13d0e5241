"""ModelRegistry: many named :class:`ForestArtifacts` hot in one process.

The port's twin of the JAX package's ``repro.serving.registry``. The
registry keeps a name -> model table with:

* **LRU device placement under a byte budget** — "hot" models have their
  tensors on the registry's device; cold models keep only their canonical
  host copy and cost no device memory. The host copy is made once, at
  registration, in pinned memory (on a CUDA registry), so a promotion is
  one asynchronous host-to-device copy per tensor
  (``ForestArtifacts.to(device, non_blocking=True)``) and a demotion drops
  the device tensors (the host copy is already there). When the hot set
  would exceed ``device_budget_bytes`` (or ``max_hot``), the
  least-recently-used hot models are demoted.
* **Immutable dispatch snapshots** — ``acquire()`` returns a
  :class:`ModelHandle`, a frozen (artifacts, schema, samplers, version)
  view. A batch dispatched against a handle keeps those exact tensors
  alive until it resolves, whatever the registry does meanwhile: a
  demotion frees a model's device memory only once no handle of it is in
  flight.
* **Zero-downtime swap** — ``swap(name, artifacts)`` builds and places the
  new version first, then flips the table pointer under the lock. In-flight
  batches finish on the old tensors (their handle still references them);
  every later dispatch sees the new ones. No request is ever dropped.

The port compiles nothing at run time: the kernels are libraries built and
loaded once per process, and a swapped-in model of any shape launches the
same ones. A swap costs one device placement.

**Sharded serving** (``mesh=``, a ``(data, model)`` ``DeviceMesh`` of
ranks, one process per device): promotion places ``host.shard(mesh)``, the
rank's classes on its device, and every batch is a sharded
:func:`~repro_torch.tabgen.sample_async`. The host copy stays whole and a
demotion frees the slice. The byte budget counts whole models, as the JAX
registry does, so ``device_budget_bytes`` means the same in both packages;
``rank_nbytes`` is what this rank holds. Rank 0 runs the control plane and
publishes every step to the other ranks, which replay it
(:mod:`repro_torch.serving.spmd`): build the registry on every rank at the
same point, serve on rank 0, run :func:`~repro_torch.serving.spmd.follow`
on the others, and :meth:`ModelRegistry.close` on rank 0 at the end. A
batch is :meth:`ModelRegistry.dispatch`: its acquire, its publication and
its enqueue hold the stream's lock, as ``register`` and ``swap`` do, so
any thread of rank 0 may issue them. Only batches acquire on a mesh
(:meth:`ModelRegistry.handle` peeks), so every rank's promotions and
demotions follow the same sequence. An impute is a command too
(:meth:`ModelRegistry.impute`): every rank imputes the rows of its classes
from its slice and the rows are gathered, as ``sample`` gathers them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.obs import MetricsRegistry
from repro_torch.tabgen import TabularGenerator, default_sampler
from repro_torch.tabgen.artifacts import (_TENSOR_FIELDS, ForestArtifacts,
                                          mesh_device)
from repro_torch.tabgen.imputation import impute
from repro_torch.tabgen.sampling import (checked_gathers, resolve_mesh,
                                         sample_labels)

DEFAULT_BUCKETS = (64, 256, 1024)


class UnknownModel(KeyError):
    """Request named a model the registry doesn't hold (HTTP: 404)."""


def artifacts_nbytes(artifacts: ForestArtifacts) -> int:
    """Device footprint of one model = sum of its tensors' bytes."""
    return int(sum(getattr(artifacts, f).numel()
                   * getattr(artifacts, f).element_size()
                   for f in _TENSOR_FIELDS))


def _host_copy(artifacts: ForestArtifacts, device: torch.device
               ) -> ForestArtifacts:
    """The canonical host copy a registry keeps of a model: pinned when
    the registry serves from a CUDA device, plain CPU tensors otherwise."""
    if device.type == "cuda":
        return artifacts.pin_memory()
    return artifacts.to("cpu")


def _place(host: ForestArtifacts, device: torch.device,
           mesh=None) -> ForestArtifacts:
    """Promote: the one-time placement a cold model pays on first use. On a
    mesh, the rank's slice."""
    if mesh is not None:
        return host.shard(mesh)
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)


class ModelHandle:
    """Immutable dispatch snapshot of one registered model version.

    Everything the scheduler needs for a batch: the facade (schema decode),
    the served sampler set, and the bucket policy. Handles are never
    mutated — ``swap`` and promotion build new ones — so an in-flight
    batch's view of the model cannot change underneath it. A cold handle
    (host tensors on a CUDA registry) still serves: each call copies the
    model (on a mesh: the rank's slice) to ``device`` for that call only.

    On a mesh ``artifacts`` is the rank's slice when hot, the whole host
    copy ``host`` when cold; ``nbytes`` counts the whole model,
    ``rank_nbytes`` the slice. A batch or an impute there is one rank's
    part of a collective: :meth:`generate_async` and :meth:`impute` go
    through the registry's ``dispatch`` and ``impute`` (``registry=``),
    which tell the other ranks.
    """

    def __init__(self, name: str, artifacts: ForestArtifacts, *,
                 device: Device, schema=None, samplers: Sequence[str] = (),
                 buckets: Sequence[int] = DEFAULT_BUCKETS, version: int = 1,
                 mesh=None, registry: Optional["ModelRegistry"] = None,
                 host: Optional[ForestArtifacts] = None):
        cfg = artifacts.config
        self.name = name
        self.artifacts = artifacts
        self.device = torch.device(device)
        self.schema = schema
        self.version = version
        self.mesh = mesh
        self._registry = registry
        self.host = host if host is not None else artifacts
        self.samplers = tuple(samplers) or (
            default_sampler(cfg.method, cfg.diff_sampler),)
        self.buckets = tuple(sorted(buckets))
        self.nbytes = artifacts_nbytes(self.host)
        self.rank_nbytes = artifacts_nbytes(artifacts)
        # requests delegate to the facade so serving output can never
        # diverge from TabularGenerator's (schema decode, impute masking)
        self._gen = TabularGenerator(cfg, schema=schema)
        self._gen.artifacts = artifacts

    def _generator(self) -> TabularGenerator:
        if self.artifacts.device.type == self.device.type:
            return self._gen
        gen = TabularGenerator(self.artifacts.config, schema=self.schema)
        gen.artifacts = (self.artifacts.shard(self.mesh) if self.mesh
                         is not None else self.artifacts.to(self.device))
        return gen

    # -- dispatch ------------------------------------------------------------

    def bucket(self, n: int, seed: int) -> int:
        """Smallest bucket covering the largest per-class slice of an
        ``n``-row request. Exact: replays the (cheap, deterministic) label
        draw that ``sample`` will make for this (n, seed)."""
        rng = np.random.default_rng(seed)
        label_idx = sample_labels(np.asarray(self.artifacts.counts), n, rng,
                                  self.artifacts.config.label_sampler)
        worst = int(np.bincount(label_idx,
                                minlength=self.artifacts.n_y).max())
        for b in self.buckets:
            if b >= worst:
                return b
        return worst  # oversize request: exact size

    def padding(self, n: int, seed: int) -> Optional[int]:
        """The ``pad_to`` a request of ``n`` rows is served at: its
        :meth:`bucket`, or None for an oversize request. That one solves
        at its exact size all the same (``sample`` pads an unbucketed call
        to its largest class), but a size of its own need not come back,
        so it takes no CUDA graph (:mod:`repro_torch.tabgen.solve_graph`)
        and leaves the buckets' graphs in place."""
        b = self.bucket(n, seed)
        return b if b in self.buckets else None

    def generate_async(self, n: int, sampler: str, *, seed: int,
                       pad_to: Optional[int] = None):
        """Non-blocking dispatch; the scheduler's waiter resolves it. On a
        mesh, through the registry's ``dispatch`` (which refuses a handle
        that a swap has replaced)."""
        pad_to = self.padding(n, seed) if pad_to is None else pad_to
        if self._registry is not None:
            return self._registry.dispatch(self.name, n, sampler, seed=seed,
                                           pad_to=pad_to,
                                           version=self.version)[1]
        return self.enqueue(n, sampler, seed=seed, pad_to=pad_to)

    def enqueue(self, n: int, sampler: str, *, seed: int,
                pad_to: Optional[int]):
        """This rank's part of a batch: the solve (on a mesh, the sharded
        solve and the gathers) and the copy to the host, enqueued."""
        return self._generator().generate_async(
            n, sampler=sampler, seed=seed, pad_to=pad_to, mesh=self.mesh)

    def generate(self, n: int, sampler: Optional[str] = None, *,
                 seed: int = 0, pad_to: Optional[int] = None):
        return self.generate_async(n, sampler or self.samplers[0],
                                   seed=seed, pad_to=pad_to).result()

    def impute(self, X_missing, y=None, *, seed: int = 0,
               refine_rounds: int = 3) -> np.ndarray:
        """Impute on this process's device; on a mesh, through the
        registry's ``impute`` (a command: every rank imputes its classes'
        rows)."""
        if self._registry is not None:
            return self._registry.impute(self.name, X_missing, y, seed=seed,
                                         refine_rounds=refine_rounds,
                                         version=self.version)
        return self._generator().impute(X_missing, y, seed=seed,
                                        refine_rounds=refine_rounds)

    def impute_part(self, Z: np.ndarray, y, *, seed: int,
                    refine_rounds: int) -> np.ndarray:
        """This rank's part of an impute on a mesh, from the model rows
        ``Z`` that ``TabularGenerator.encode_missing`` made and checked on
        rank 0: its classes' rows, then the gathers. Returns the model rows
        filled."""
        return impute(self._generator().artifacts, Z, y, seed=seed,
                      refine_rounds=refine_rounds, mesh=self.mesh)

    def warmup(self) -> float:
        """Run every (sampler, bucket) once: loads the kernel libraries and
        primes the caching allocators. Returns wall seconds."""
        t0 = time.time()
        total = int(np.asarray(self.artifacts.counts).sum())
        for name in self.samplers:
            for b in self.buckets:
                self.generate(max(min(b, total), 1), name, seed=0, pad_to=b)
        return time.time() - t0


@dataclasses.dataclass
class _Entry:
    handle: ModelHandle
    host_artifacts: ForestArtifacts   # canonical host copy (survives demote)
    hot: bool
    last_used: int


#: lifecycle events tracked per model in ``registry_model_events_total``
_EVENTS = ("acquires", "promotions", "demotions", "swaps")


class ModelRegistry:
    """Thread-safe name -> model table with LRU device placement.

    ``device`` is where hot models live and every request runs (``None``:
    the GPU, or raise; ``"cpu"`` runs the plain PyTorch path). ``mesh``
    (``None`` | ``DeviceMesh`` | ``"auto"``) serves sharded: see the module
    docstring; ``device`` then defaults to the rank's device on the mesh.
    ``device_budget_bytes`` caps the summed tensor bytes of hot models
    (``None`` = unbounded); ``max_hot`` caps their count. ``buckets`` is
    the registry-wide default applied to every handle.

    Promotion happens inside ``acquire`` under the registry lock — a cold
    model's first request pays the placement (and any LRU demotions) before
    dispatch, which is the explicit cost model: hot models never pay it.
    """

    def __init__(self, *, device: Optional[Device] = None, mesh=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 device_budget_bytes: Optional[int] = None,
                 max_hot: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.mesh = resolve_mesh(mesh)
        self.stream = None
        if self.mesh is None:
            self.device = resolve_device(device)
        else:
            from repro_torch.serving.spmd import CommandStream
            self.device = (mesh_device(self.mesh) if device is None
                           else resolve_device(device))
            if self.device.type != self.mesh.device_type:
                raise ValueError(f"a {self.mesh.device_type} mesh cannot "
                                 f"serve on {self.device}")
            self.stream = CommandStream()
        self.buckets = tuple(sorted(buckets))
        self.device_budget_bytes = device_budget_bytes
        self.max_hot = max_hot
        self._lock = threading.RLock()
        self._entries: Dict[str, _Entry] = {}
        self._seq = 0
        self.metrics = metrics or MetricsRegistry()
        self._m_events = self.metrics.counter(
            "registry_model_events", "Model lifecycle events (acquires / "
            "promotions / demotions / swaps)", ("model", "event"))
        self._m_hot_bytes = self.metrics.gauge(
            "registry_hot_bytes", "Summed tensor bytes of device-placed "
            "(hot) models")
        self._m_hot_models = self.metrics.gauge(
            "registry_hot_models", "Models currently device-placed")
        self._m_models = self.metrics.gauge(
            "registry_models", "Models registered (hot or cold)")
        self._sync_gauges_locked()

    # -- internals (call with the lock held) ---------------------------------

    def _tick(self) -> int:
        self._seq += 1
        return self._seq

    def _hot_bytes(self) -> int:
        return sum(e.handle.nbytes for e in self._entries.values() if e.hot)

    def _hot_count(self) -> int:
        return sum(1 for e in self._entries.values() if e.hot)

    def _demote_lru(self, keep: str) -> None:
        """Demote least-recently-used hot entries until the budget holds.
        ``keep`` (the entry being promoted/registered) is never demoted —
        a model larger than the whole budget still gets to serve."""
        def over():
            if (self.device_budget_bytes is not None
                    and self._hot_bytes() > self.device_budget_bytes):
                return True
            return self.max_hot is not None and self._hot_count() > self.max_hot

        while over():
            victims = [(e.last_used, n) for n, e in self._entries.items()
                       if e.hot and n != keep]
            if not victims:
                break
            _, name = min(victims)
            entry = self._entries[name]
            entry.handle = self._build_handle(
                name, entry.host_artifacts, entry.handle, hot=False)
            entry.hot = False
            self._m_events.inc(1, model=name, event="demotions")

    def _sync_gauges_locked(self) -> None:
        """Mirror the hot set into gauges (caller holds the lock, so the
        gauges can never drift from the table they describe)."""
        self._m_hot_bytes.set(self._hot_bytes())
        self._m_hot_models.set(self._hot_count())
        self._m_models.set(len(self._entries))

    def _build_handle(self, name: str, host_artifacts: ForestArtifacts,
                      like: ModelHandle, *, hot: bool,
                      version: Optional[int] = None) -> ModelHandle:
        arts = (_place(host_artifacts, self.device, self.mesh) if hot
                else host_artifacts)
        return ModelHandle(
            name, arts, device=self.device, schema=like.schema,
            samplers=like.samplers, buckets=like.buckets,
            version=like.version if version is None else version,
            mesh=self.mesh, host=host_artifacts,
            registry=None if self.stream is None else self)

    def _command(self):
        """On a mesh, the stream's lock: a command is published and applied
        in one piece."""
        if self.stream is None:
            return contextlib.nullcontext()
        return self.stream.lock

    @contextlib.contextmanager
    def _applying(self):
        """The part of a command after its publication: on a mesh, its
        first gather runs the stream's failure check first, and a failure
        breaks the stream (the other ranks went on)."""
        try:
            if self.stream is None:
                yield
            else:
                with checked_gathers(self.stream.settle):
                    yield
        except BaseException as exc:
            if self.stream is not None:
                self.stream.settle(exc)   # before the others' gathers
                self.stream.abort(exc)
            raise

    # -- public API ----------------------------------------------------------

    def register(self, name: str, artifacts: Optional[ForestArtifacts] = None,
                 *, path: Optional[str] = None, schema=None,
                 samplers: Sequence[str] = (),
                 buckets: Optional[Sequence[int]] = None,
                 hot: bool = True) -> ModelHandle:
        """Add (or replace) a model. ``path`` loads a saved
        ``TabularGenerator`` artifact pair (schema rides along); ``hot``
        places it on the device immediately (evicting LRU models per
        budget), else it stays cold until first use."""
        from_path = path if artifacts is None else None
        if artifacts is None:
            if path is None:
                raise ValueError("register() needs artifacts or path=")
            gen = TabularGenerator.load(path, device="cpu")
            artifacts, schema = gen.artifacts, gen.schema
        artifacts._require_whole("register")
        host = _host_copy(artifacts, self.device)
        seed_handle = ModelHandle(
            name, host, device=self.device, schema=schema, samplers=samplers,
            buckets=buckets or self.buckets)
        with self._command(), self._lock:
            self._publish("register", name, host, from_path, schema,
                          samplers=list(seed_handle.samplers),
                          buckets=list(seed_handle.buckets), hot=hot)
            with self._applying():
                handle = self._build_handle(name, host, seed_handle,
                                            hot=hot)
                self._entries[name] = _Entry(
                    handle=handle, host_artifacts=host, hot=hot,
                    last_used=self._tick())
                # re-registering a name wipes its event counters; scrapers
                # see a normal counter reset
                self._m_events.reset(model=name)
                if hot:
                    self._demote_lru(keep=name)
                self._sync_gauges_locked()
                return handle

    def swap(self, name: str, artifacts: ForestArtifacts, *,
             schema=None, keep_schema: bool = True,
             path: Optional[str] = None) -> ModelHandle:
        """Zero-downtime replace: the new version is built (and device-
        placed, when the entry is hot) *before* the table pointer flips, so
        there is no window where the name is unservable. In-flight batches
        hold the old handle and finish on the old tensors. On a mesh,
        ``path`` (where ``artifacts`` were loaded from) lets the other ranks
        load the model themselves instead of receiving its arrays."""
        artifacts._require_whole("swap")
        host = _host_copy(artifacts, self.device)
        with self._command(), self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise UnknownModel(name)
            self._publish("swap", name, host, path,
                          schema if not keep_schema else None,
                          keep_schema=keep_schema)
            with self._applying():
                old = entry.handle
                seed_handle = ModelHandle(
                    name, host, device=self.device,
                    schema=old.schema if keep_schema else schema,
                    samplers=old.samplers, buckets=old.buckets)
                entry.handle = self._build_handle(
                    name, host, seed_handle, hot=entry.hot,
                    version=old.version + 1)
                entry.host_artifacts = host
                entry.last_used = self._tick()
                self._m_events.inc(1, model=name, event="swaps")
                if entry.hot:
                    self._demote_lru(keep=name)
                self._sync_gauges_locked()
                return entry.handle

    def acquire(self, name: str) -> ModelHandle:
        """Dispatch-time lookup: promote if cold (LRU-evicting under the
        budget), bump recency, return the immutable handle."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise UnknownModel(name)
            if not entry.hot:
                entry.handle = self._build_handle(
                    name, entry.host_artifacts, entry.handle, hot=True)
                entry.hot = True
                self._m_events.inc(1, model=name, event="promotions")
                self._demote_lru(keep=name)
                self._sync_gauges_locked()
            entry.last_used = self._tick()
            self._m_events.inc(1, model=name, event="acquires")
            return entry.handle

    def dispatch(self, name: str, n: int, sampler: str, *, seed: int,
                 pad_to: Optional[int] = None,
                 version: Optional[int] = None):
        """Acquire ``name`` and enqueue one batch of ``n`` rows; returns
        ``(handle, sample)``. On a mesh, under the stream's lock: the batch
        is checked (``version``, a handle's, must still be current; the
        sampler must be served), published to the other ranks, acquired
        and enqueued. A failure after the publication breaks the stream
        (:meth:`~repro_torch.serving.spmd.CommandStream.abort`)."""
        if self.stream is None:
            handle = self.acquire(name)
            return handle, handle.enqueue(
                n, sampler, seed=seed,
                pad_to=handle.padding(n, seed) if pad_to is None else pad_to)
        with self.stream.lock:
            handle = self.peek(name)
            if version is not None and version != handle.version:
                raise ValueError(
                    f"model {name!r} version {version} was swapped out "
                    f"(now {handle.version}): acquire it again")
            if sampler not in handle.samplers:
                raise ValueError(f"model {name!r} does not serve sampler "
                                 f"{sampler!r}; served: "
                                 f"{list(handle.samplers)}")
            pad_to = handle.padding(n, seed) if pad_to is None else pad_to
            self.stream.publish("batch", model=name, n=int(n),
                                sampler=sampler, seed=int(seed),
                                pad_to=None if pad_to is None else int(pad_to))
            with self._applying():
                handle = self.acquire(name)
                return handle, handle.enqueue(n, sampler, seed=seed,
                                              pad_to=pad_to)

    def impute(self, name: str, X_missing, y=None, *, seed: int = 0,
               refine_rounds: int = 3,
               version: Optional[int] = None) -> np.ndarray:
        """Fill the NaN cells of ``X_missing`` with model ``name``. On a
        mesh, under the stream's lock: checked (``version``, a handle's,
        must still be current; the rows and labels must fit the model, so
        a bad request is refused before any other rank hears of it), the
        model rows published to the other ranks, then every rank imputes
        its classes' rows (:meth:`impute_part`) and the rows are gathered.
        Without a mesh, the acquired handle imputes."""
        if self.stream is None:
            return self.acquire(name).impute(X_missing, y, seed=seed,
                                             refine_rounds=refine_rounds)
        with self.stream.lock:
            handle = self.peek(name)
            if version is not None and version != handle.version:
                raise ValueError(
                    f"model {name!r} version {version} was swapped out "
                    f"(now {handle.version}): acquire it again")
            Z = handle._gen.encode_missing(X_missing, y)
            y = None if y is None else np.asarray(y)
            self.stream.publish("impute", model=name, rows=Z, labels=y,
                                seed=int(seed),
                                refine_rounds=int(refine_rounds))
            filled = self.impute_part(name, Z, y, seed=seed,
                                      refine_rounds=refine_rounds)
        return handle._gen.decode_imputed(X_missing, filled)

    def impute_part(self, name: str, Z: np.ndarray, y, *, seed: int,
                    refine_rounds: int) -> np.ndarray:
        """A published impute on this rank (rank 0 after :meth:`impute`'s
        check, a follower replaying it); a failure breaks the stream."""
        with self._applying():
            return self.peek(name).impute_part(Z, y, seed=seed,
                                               refine_rounds=refine_rounds)

    def handle(self, name: str) -> ModelHandle:
        """The handle for work outside a batch (warmup, a synchronous
        generate): :meth:`acquire` without a mesh. On a mesh,
        :meth:`peek`: there only batches acquire, on every rank alike."""
        return self.acquire(name) if self.stream is None else self.peek(name)

    def _publish(self, op: str, name: str, host: ForestArtifacts,
                 path: Optional[str], schema, **args) -> None:
        """Rank 0 of a mesh: tell the other ranks about a register / swap
        (caller holds the stream's lock and the registry's)."""
        if self.stream is None or not self.stream.leader:
            return
        from repro_torch.serving.spmd import model_payload
        self.stream.publish(
            op, name=name, model=model_payload(host, path),
            schema=None if schema is None else schema.to_dict(), **args)

    def close(self) -> None:
        """On a mesh, rank 0: tell the other ranks to leave
        :func:`~repro_torch.serving.spmd.follow`; no batch is served after.
        Nothing to do without a mesh."""
        if self.stream is None or not self.stream.leader:
            return
        with self.stream.lock:
            if not (self.stream.closed or self.stream.broken):
                self.stream.publish("stop")

    def peek(self, name: str) -> ModelHandle:
        """Lookup without promotion or recency bump (request validation)."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise UnknownModel(name)
            return entry.handle

    def warmup(self, name: Optional[str] = None) -> float:
        """Run every (sampler, bucket) of one model (or all) once."""
        names = [name] if name is not None else self.names()
        return sum(self.handle(n).warmup() for n in names)

    def names(self):
        with self._lock:
            return sorted(self._entries)

    def hot_names(self):
        with self._lock:
            return sorted(n for n, e in self._entries.items() if e.hot)

    def hot_bytes(self) -> int:
        """Device-placed model bytes right now (the ResourceMonitor's
        ``resource_hot_model_bytes`` source)."""
        with self._lock:
            return self._hot_bytes()

    def describe(self) -> dict:
        """Per-model status for ``/v1/models`` and ``/statz``. Event
        counts are a view over ``registry_model_events_total`` — the same
        series ``GET /metrics`` exports."""
        with self._lock:
            events = self._m_events.series()   # (model, event) -> n
            return {
                name: {
                    "hot": e.hot,
                    "nbytes": e.handle.nbytes,
                    "version": e.handle.version,
                    "samplers": list(e.handle.samplers),
                    "buckets": list(e.handle.buckets),
                    "n_features": e.handle.artifacts.p,
                    "n_classes": e.handle.artifacts.n_y,
                    # data provenance (rows / store fingerprint+version at
                    # fit time, base round range) — how an operator spots a
                    # stale model-vs-store pairing before/after a swap
                    "lineage": e.host_artifacts.lineage,
                    **{ev: int(events.get((name, ev), 0))
                       for ev in _EVENTS},
                    # on a mesh: the bytes of this rank's slice
                    **({} if self.mesh is None
                       else {"rank_nbytes": e.handle.rank_nbytes}),
                }
                for name, e in self._entries.items()}

    def stats_snapshot(self) -> dict:
        with self._lock:
            return {"models": self.describe(),
                    "hot_bytes": self._hot_bytes(),
                    "device_budget_bytes": self.device_budget_bytes,
                    "max_hot": self.max_hot}
