"""Generation: one class-batched solve per call.

All classes are integrated at once: ``x1`` is ``[n_y, m, p]`` and each solver
step evaluates the ``[n_y, n_sub]`` forests of that step in one
:func:`~repro_torch.forest.packed.predict_forest` call. Per-class unscaling
happens on the device too, and so do dropping the padding rows (classes get
unequal row counts) and the shuffle: one row gather (:func:`compact`) whose
index the host builds from the call's permutation, so only the ``n`` rows
the caller gets are copied to the host, already in their final order.

``pad_to`` rounds the per-class row budget up to a fixed bucket, as a
serving host does. Noise is drawn so that padding changes no kept row: x1
comes in blocks of :data:`NOISE_BLOCK` rows, each from a generator seeded by
``(seed, class, block)``, so row i's noise depends only on
``(seed, class, i)`` — a plain ``randn`` of the padded shape would not be
prefix-stable. The JAX package draws per row with ``fold_in``; the two give
different numbers, and the parity tests hand both the same x1.

:func:`sample_async` only enqueues device work; :meth:`SampleHandle.result`
is where the host waits. On a CUDA device :func:`sample_async` also
enqueues the copy of the gathered rows into pinned host memory, on the
stream that ran the solve, and records an event behind it: ``result()``
waits for that event only, then copies the rows into an array of their
own. A serving thread that resolves batch k while another thread has
already enqueued batch k+1 therefore does not wait for batch k+1's device
work.

Each call records eight spans into :func:`repro_torch.obs.default_tracer`,
all under one trace id (``sample-<k>``, a per-process count, kept on the
:class:`SampleHandle` as ``trace_id``), since ``result()`` may run on
another thread than the issue: ``sample.issue`` (the whole of
:func:`sample_async`; ``rows``, ``n_y``, ``m``, ``sampler``) over
``sample.x1``, ``sample.solve`` (``steps``: the solver's ``n_t - 1``;
``lanes``: the sub-forests of a (timestep, class) ensemble, ``n_sub``, 1
for multi-output trees and ``p`` for single-output ones; ``trees``: T, the
trees of a sub-forest; ``graph``: ``"eager"``, ``"capture"`` or
``"replay"``, below; ``sum_tma`` / ``sum_plain``: the multi-output
summing kernels the solve ran, by kind, as the ``tree_predict`` launcher
reports them, a replay its capture's, 0 and 0 on the CPU; on a CUDA
device the host enqueuing every step, or one graph's replay),
``sample.compact`` (``rows``; ``padding_rows``, the rows dropped on the
device) and ``sample.copy`` (``bytes`` copied to the host);
``sample.result`` (``rows``) over ``sample.result.wait`` and
``sample.result.copy_out`` (``bytes`` of the rows and labels handed
over). None inside the solver's step loop. With
``REPRO_OBS_TORCH_TRACE=1`` each is a ``torch.profiler`` range too
(:mod:`repro_torch.obs.tracing`).

A bucketed call (``pad_to`` given) on one CUDA device with a
deterministic sampler replays its solve as one CUDA graph
(:mod:`repro_torch.tabgen.solve_graph`): the first call of its
``(sampler, [n_y, m, p])`` for the artifacts solves eagerly and captures
the graph (``graph="capture"``), later ones copy their x1 into it and
replay it (``"replay"``), bit-equal; every other call solves eagerly
(``"eager"``).

``mesh`` shards the solve over a ``(data, model)`` ``DeviceMesh`` of ranks
(:mod:`repro_torch.launch.mesh`), one process per device. It is a
collective: every rank calls :func:`sample_async` with the same arguments,
and every rank gets the same rows. A rank solves the classes
:func:`~repro_torch.tabgen.artifacts.class_span` gives it and the rows
``[r·k, (r+1)·k)`` of its data rank ``r`` (``k = ceil(m / n_data)``). Its
x1 comes from the same ``(seed, class, block)`` streams, drawing only the
blocks its rows touch, and a stochastic sampler's step noise is its slice
of the unsharded call's whole draw, so the rows equal the unsharded
call's on the same device type, bit for bit. ``sample_async`` enqueues
the gathers (over ``data``, then over ``model`` where classes are split),
the row gather of :func:`compact` and the copy to pinned memory behind
them; :meth:`SampleHandle.result` issues no collective.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import interpolants as itp
from repro_torch.forest.packed import PackedForest
from repro_torch.kernels.build import tallied_launches
from repro_torch.kernels.tree_predict.ops import sum_launches
from repro_torch.obs import default_tracer
from repro_torch.tabgen import solve_graph
from repro_torch.tabgen.artifacts import (ForestArtifacts, class_span,
                                          unscale, unscale_host)
from repro_torch.tabgen.samplers import default_sampler, get_sampler

NOISE_BLOCK = 1024   # rows per x1 block

_CALLS = itertools.count(1)   # generate calls of this process: trace ids

# noise streams derived from one user seed (the trainer's is 3)
_X1_STREAM, _SOLVE_STREAM, _IMPUTE_STREAM = 0, 1, 2
_LOOP_STREAM = 4


def stream_seed(*words: int) -> int:
    """A 63-bit generator seed from integer words (seed, stream, …)."""
    ss = np.random.SeedSequence([w % 2 ** 64 for w in words])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def row_noise(seed: int, n_y: int, m: int, p: int, device,
              classes: Optional[Tuple[int, int]] = None,
              rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Standard-normal x1 ``[n_y, m, p]`` whose row i of class c depends only
    on ``(seed, c, i)``. ``classes`` / ``rows`` (``[lo, hi)``) return that
    block of it, drawing only the row blocks the rows touch."""
    c0, c1 = classes or (0, n_y)
    r0, r1 = rows or (0, m)
    b0, b1 = r0 // NOISE_BLOCK, -(-r1 // NOISE_BLOCK)
    x1 = torch.empty((c1 - c0, (b1 - b0) * NOISE_BLOCK, p),
                     dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    for c in range(c0, c1):
        for b in range(b0, b1):
            gen.manual_seed(stream_seed(seed, _X1_STREAM, c, b))
            lo = (b - b0) * NOISE_BLOCK
            x1[c - c0, lo:lo + NOISE_BLOCK].normal_(generator=gen)
    off = b0 * NOISE_BLOCK
    return x1[:, r0 - off:r1 - off].contiguous()


def sample_labels(counts: np.ndarray, n: int, rng: np.random.Generator,
                  mode: str = "label") -> np.ndarray:
    """Class indices for ``n`` rows. ``label`` = deterministic empirical
    proportions (paper C.4); ``multinomial`` = iid draws."""
    counts = np.asarray(counts)
    if mode == "multinomial":
        probs = counts / counts.sum()
        idx = rng.choice(len(counts), size=n, p=probs)
    else:
        reps = np.floor(n * counts / counts.sum()).astype(int)
        rem = n - reps.sum()
        frac = n * counts / counts.sum() - reps
        extra = np.argsort(-frac)[:rem]
        reps[extra] += 1
        idx = np.repeat(np.arange(len(counts)), reps)
    idx.sort()
    return idx


def solve_all_classes(feat, thr_val, leaf, x1, mins, maxs, ts, *, solver_fn,
                      depth: int, n_t: int, multi_output: bool, eps: float,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """``[n_t, n_y, ...]`` forests and x1 ``[n_y, m, p]`` -> ``[n_y, m, p]``
    unscaled samples, every class in one batched solve."""
    forests = PackedForest(feat, thr_val, leaf, multi_output)
    x0 = solver_fn(x1, forests, depth=depth, n_t=n_t, ts=ts, eps=eps,
                   noise=noise, generator=generator)
    return unscale(x0, mins[:, None, :], maxs[:, None, :])


def resolve_mesh(mesh):
    """``None`` | ``DeviceMesh`` | ``"auto"`` -> ``DeviceMesh`` | ``None``.
    ``"auto"`` is :func:`~repro_torch.launch.mesh.auto_forest_mesh`: ``None``
    on one GPU, as for the trainer. The serving registry resolves its
    ``mesh=`` through this too."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh is None or isinstance(mesh, DeviceMesh):
        return mesh
    if isinstance(mesh, str) and mesh == "auto":
        from repro_torch.launch.mesh import auto_forest_mesh
        return auto_forest_mesh()
    raise ValueError(f"mesh={mesh!r}: expected a DeviceMesh, None or 'auto'")


class _StepNoise:
    """A stochastic sampler's step noise on one rank of a sharded solve:
    step k draws the unsharded call's whole ``[n_y, m, p]`` step from the
    shared generator (or takes ``draws[k]``) and keeps this rank's classes
    and rows. Every rank makes the full draw each step: that is the cost of
    rows equal to the unsharded call's."""

    def __init__(self, shape, classes, rows, device, generator=None,
                 draws=None):
        self.shape, self.device = shape, device
        self.cls, self.rows = slice(*classes), slice(*rows)
        self.generator, self.draws = generator, draws

    def __call__(self, k: int) -> torch.Tensor:
        if self.draws is not None:
            z = self.draws[k]
        else:
            z = torch.randn(self.shape, generator=self.generator,
                            dtype=torch.float32, device=self.device)
        return z[self.cls, self.rows]


_gather_check = threading.local()


@contextlib.contextmanager
def checked_gathers(check: Callable[[], None]):
    """Within the block, this thread's next :func:`_gather` first calls
    ``check()`` (once): a serving mesh's failure check, which raises there
    when a rank failed its part of the command."""
    _gather_check.fn = check
    try:
        yield
    finally:
        _gather_check.fn = None


def _gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """``[size · t.shape[0], ...]``: ``t`` of every rank of ``group``
    stacked in rank order. On a CUDA group it is enqueued: the current
    stream waits for it, the host does not."""
    check = getattr(_gather_check, "fn", None)
    if check is not None:
        _gather_check.fn = None
        check()
    out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def solve_sharded(artifacts: ForestArtifacts, mesh, ts, *, m: int,
                  solver_fn, x1: Callable, noise=None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """The sharded solve: ``[n_y, m, p]`` unscaled samples on every rank
    of ``mesh``, a collective.

    This rank solves classes ``[c0, c1)`` (:func:`class_span`) and rows
    ``[r0, r1)`` of its data rank. ``x1(classes, rows)`` returns that block
    of the call's ``[n_y, m, p]`` x1. A stochastic ``solver_fn`` takes its
    step noise from ``noise`` (the whole ``[n_t - 1, n_y, m, p]``) or else
    from ``generator``, in either case this rank's slice of the whole
    draw. ``artifacts`` may be the whole model on this rank's device or
    the slice :meth:`ForestArtifacts.shard` made for it, on the mesh's
    device type (:func:`sample_async` checks that). The gathers are
    enqueued (over ``data``, then over ``model`` where classes are split);
    on a CUDA mesh the host does not wait for them.
    """
    from repro_torch.forest.distributed import Shards
    fcfg = artifacts.config
    n_y, p, device = artifacts.n_y, artifacts.p, artifacts.device
    sh = Shards.from_mesh(mesh)
    c0, c1 = class_span(mesh, n_y)
    feat, thr_val, leaf, mins, maxs = artifacts.class_tensors(c0, c1)
    k = -(-m // sh.data_size)
    r0 = min(sh.data_rank * k, m)
    r1 = min(r0 + k, m)
    x = None
    if r1 > r0:
        step_noise = None
        if noise is not None or generator is not None:
            step_noise = _StepNoise((n_y, m, p), (c0, c1), (r0, r1), device,
                                    generator, noise)
        x = solve_all_classes(
            feat, thr_val, leaf, x1((c0, c1), (r0, r1)).contiguous(), mins,
            maxs, ts,
            solver_fn=solver_fn, depth=fcfg.max_depth, n_t=fcfg.n_t,
            multi_output=fcfg.multi_output, eps=fcfg.eps_diff,
            noise=step_noise)
    if r1 - r0 < k:                                   # pad to k rows
        pad = torch.zeros((c1 - c0, k, p), dtype=torch.float32,
                          device=device)
        if x is not None:
            pad[:, :r1 - r0] = x
        x = pad
    x = _gather(x, sh.data_group, sh.data_size)       # [n_data·c, k, p]
    x = x.view(sh.data_size, c1 - c0, k, p).transpose(0, 1)
    x = x.reshape(c1 - c0, sh.data_size * k, p)[:, :m]
    if c1 - c0 < n_y:                                 # classes split
        x = _gather(x, sh.model_group, sh.model_size)
    return x.contiguous()


def _resolve_sampler(fcfg, sampler: Optional[str]):
    """Name -> spec, validated against the artifacts' interpolant family."""
    name = sampler or default_sampler(fcfg.method, fcfg.diff_sampler)
    spec = get_sampler(name)
    if spec.method != fcfg.method:
        raise ValueError(
            f"sampler {name!r} integrates {spec.method!r} but artifacts "
            f"were trained with method={fcfg.method!r}")
    return name, spec


class SampleHandle:
    """An in-flight :func:`sample`: device work enqueued, host finish
    deferred. ``result()`` waits for the rows to reach the host and hands
    them over with their labels.

    ``x`` is the ``[n, p]`` rows in their final order: on the CPU, or a
    pinned host tensor that a copy from the device is filling; ``ready`` is
    then the CUDA event recorded behind that copy, and ``result()`` waits on
    it and on nothing else. ``y`` is the labels, built on the host at issue.
    ``trace_id`` is the call's own trace: its ``sample.result*`` spans join
    its ``sample.issue`` ones under it.
    """

    def __init__(self, x: torch.Tensor, y: np.ndarray, ready=None,
                 trace_id: Optional[str] = None):
        self._x = x
        self._y = y
        self.ready = ready
        self.trace_id = trace_id
        # trace context, stamped by the serving scheduler via tag(): which
        # coalesced batch this dispatch is, and which request traces ride it
        self.batch_id: Optional[int] = None
        self.trace_ids: Tuple[str, ...] = ()

    def tag(self, *, batch_id: Optional[int] = None,
            trace_ids: Sequence[str] = ()) -> "SampleHandle":
        """Attach serving trace context (metadata, never read by the
        sampling math). Returns self."""
        self.batch_id = batch_id
        self.trace_ids = tuple(trace_ids)
        return self

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(X [n, p], y [n])``, once: the handle lets go of its rows as it
        hands them over, and a second call raises ``RuntimeError``. ``X``
        owns its memory: the caller may keep it without holding the pinned
        buffer, which the caching host allocator then hands to a later
        call."""
        if self._x is None:
            raise RuntimeError(
                "SampleHandle.result() hands a call's rows over once, and "
                "this handle's were already taken: keep the (X, y) that the "
                "first result() returned")
        tracer, tid = default_tracer(), self.trace_id
        with tracer.span("sample.result", trace_id=tid) as sp:
            with tracer.span("sample.result.wait", trace_id=tid):
                if self.ready is not None:
                    self.ready.synchronize()        # this batch's copy only
            with tracer.span("sample.result.copy_out", trace_id=tid) as co:
                X = _copy_out(self._x)
                co.attrs["bytes"] = X.nbytes + self._y.nbytes
            self._x = None
            sp.attrs["rows"] = len(X)
        return X, self._y


# Below this many bytes one thread copies the rows out. After a short copy
# the intra-op pool's idle threads delay the host's next kernel launches:
# on an H100's 8-core host, 4,000 rows of 368 columns (5.9 MB) took 0.28 ms
# on the pool against 0.52 ms on one thread, but the p95 of 400 launches
# after it read 20 ms against 3.4 ms. A large fresh array is faulted in
# faster by the pool: 120,000 rows (177 MB) took 58 ms against 80 ms.
POOL_COPY_BYTES = 64 * 2 ** 20


def _copy_out(x: torch.Tensor) -> np.ndarray:
    """``x`` as a NumPy array that owns its memory."""
    if x.numel() * x.element_size() < POOL_COPY_BYTES:
        return x.cpu().numpy().copy()
    X = np.empty(tuple(x.shape), dtype=np.float32)
    torch.from_numpy(X).copy_(x)
    return X


def compact(x_all: torch.Tensor, per_class: np.ndarray, classes: np.ndarray,
            perm: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
    """``([n, p] rows, [n] labels)``: the unpadded rows of ``x_all``
    ``[n_y, m, p]`` (the first ``per_class[c]`` of class ``c``), in class
    order, then shuffled by ``perm``, as one row gather on ``x_all``'s
    device. The index is built on the host and, on a CUDA device, uploaded
    from pinned memory so that the host does not wait for the stream."""
    n_y, m, p = x_all.shape
    # row j of the class-ordered rows is padded row j + start[its class]
    start = np.arange(n_y) * m - (np.cumsum(per_class) - per_class)
    src = (np.repeat(start, per_class) + np.arange(len(perm)))[perm]
    src = torch.from_numpy(src)
    if x_all.device.type == "cuda":
        src = src.pin_memory().to(x_all.device, non_blocking=True)
    return (x_all.reshape(n_y * m, p).index_select(0, src),
            np.repeat(classes, per_class)[perm])


def _copy_to_host(x: torch.Tensor):
    """``(pinned host tensor, event)``: the device-to-host copy of ``x``
    enqueued on the current stream, which ran the solve, and an event
    recorded behind it. The caching host allocator reuses the pinned
    buffers."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(x.device))
    return host, ready


def sample_async(artifacts: ForestArtifacts, n: int, *,
                 sampler: Optional[str] = None, seed: int = 0,
                 pad_to: Optional[int] = None, mesh=None) -> SampleHandle:
    """Enqueue a generate call on the artifacts' device without waiting.

    :func:`sample` is ``sample_async(...).result()``, so both paths give the
    same rows by construction. With ``mesh`` (``None`` | ``DeviceMesh`` |
    ``"auto"``) every rank of the mesh makes the same call (a collective);
    ``artifacts`` is the whole model on the rank's device or its
    :meth:`~ForestArtifacts.shard` slice.
    """
    tracer, tid = default_tracer(), f"sample-{next(_CALLS)}"
    with tracer.span("sample.issue", trace_id=tid, rows=n) as sp:
        fcfg = artifacts.config
        name, spec = _resolve_sampler(fcfg, sampler)
        mesh = resolve_mesh(mesh)
        if mesh is None and artifacts.is_slice:
            artifacts._require_whole("sample without its mesh")
        if mesh is not None and mesh.device_type != artifacts.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot sample from "
                             f"artifacts on {artifacts.device}")
        rng = np.random.default_rng(seed)
        label_idx = sample_labels(artifacts.counts, n, rng,
                                  fcfg.label_sampler)
        n_y = artifacts.n_y
        per_class = np.bincount(label_idx, minlength=n_y)
        perm = rng.permutation(n)
        m = int(per_class.max())
        if pad_to is not None:
            if pad_to < m:
                raise ValueError(f"pad_to={pad_to} < largest class batch {m}")
            m = int(pad_to)
        sp.attrs.update(n_y=n_y, m=m, sampler=name)
        device = artifacts.device
        key = solve_graph.graph_key(device, sampler=name,
                                    stochastic=spec.stochastic, pad_to=pad_to,
                                    shape=(n_y, m, artifacts.p), mesh=mesh)
        graph = solve_graph.lookup(artifacts, key) if key else None
        ts = generator = None
        if graph is None:
            ts = itp.timesteps(fcfg.method, fcfg.n_t, fcfg.eps_diff,
                               fcfg.t_schedule, device=device)
            if spec.stochastic:
                generator = torch.Generator(device=device)
                generator.manual_seed(stream_seed(seed, _SOLVE_STREAM))

        def x1(classes=None, rows=None):
            with tracer.span("sample.x1", trace_id=tid):
                return row_noise(seed, n_y, m, artifacts.p, device, classes,
                                 rows)

        def solve(x1_all):
            return solve_all_classes(
                artifacts.feat, artifacts.thr_val, artifacts.leaf, x1_all,
                artifacts.mins, artifacts.maxs, ts, solver_fn=spec.fn,
                depth=fcfg.max_depth, n_t=fcfg.n_t,
                multi_output=fcfg.multi_output, eps=fcfg.eps_diff,
                generator=generator)

        # a rank of a mesh draws its block of x1 inside the solve
        x1_all = x1() if mesh is None else None
        # a replay's static output is read by compact before the next
        # replay may overwrite it
        with graph.use() if graph else contextlib.nullcontext():
            with tracer.span("sample.solve", trace_id=tid,
                             steps=fcfg.n_t - 1,
                             lanes=artifacts.feat.shape[2],
                             trees=artifacts.feat.shape[3],
                             graph="eager") as ss, \
                    tallied_launches() as launched:
                if graph is not None:
                    ss.attrs["graph"] = "replay"
                    x_all = graph.replay(x1_all)
                elif mesh is None:
                    x_all = solve(x1_all)
                    if key is not None:
                        ss.attrs["graph"] = "capture"
                        solve_graph.capture(artifacts, key, solve, x1_all,
                                            ts)
                else:
                    x_all = solve_sharded(artifacts, mesh, ts, m=m,
                                          solver_fn=spec.fn, x1=x1,
                                          generator=generator)
                ss.attrs.update(sum_launches(launched))
            with tracer.span("sample.compact", trace_id=tid, rows=n,
                             padding_rows=n_y * m - n):
                x, y = compact(x_all, per_class,
                               np.asarray(artifacts.classes), perm)
        with tracer.span("sample.copy", trace_id=tid, bytes=0) as cp:
            ready = None
            if device.type == "cuda":
                x, ready = _copy_to_host(x)
                cp.attrs["bytes"] = x.numel() * x.element_size()
        return SampleHandle(x, y, ready, tid)


def sample(artifacts: ForestArtifacts, n: int, *,
           sampler: Optional[str] = None, seed: int = 0,
           pad_to: Optional[int] = None, mesh=None):
    """Generate ``n`` rows (and their labels) from trained artifacts.

    ``pad_to`` fixes the per-class row bucket (>= the largest per-class
    request); for the deterministic samplers it changes no row. ``mesh``
    shards the solve over a mesh of ranks (see :func:`sample_async`); the
    rows equal the unsharded call's on the same device type.
    """
    return sample_async(artifacts, n, sampler=sampler, seed=seed,
                        pad_to=pad_to, mesh=mesh).result()


def sample_loop_reference(artifacts: ForestArtifacts, n: int, *,
                          sampler: Optional[str] = None, seed: int = 0,
                          x1: Optional[Callable] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """The pre-redesign path: one solver call per class, host-side
    unscaling (float64, as the JAX package's). Kept as the baseline of the
    generation benchmark, and as executable documentation of what the
    class-batched path replaced.

    Class ``yi``'s x1 ``[n_c, p]`` is the tensor ``x1(yi, (n_c, p))`` if
    given, else drawn from a generator seeded by ``(seed, yi)``; a
    stochastic sampler draws its noise from that generator too.
    """
    fcfg = artifacts.config
    _, spec = _resolve_sampler(fcfg, sampler)
    rng = np.random.default_rng(seed)
    label_idx = sample_labels(artifacts.counts, n, rng, fcfg.label_sampler)
    device = artifacts.device
    ts = itp.timesteps(fcfg.method, fcfg.n_t, fcfg.eps_diff, fcfg.t_schedule,
                       device=device)
    mins = artifacts.mins.cpu().numpy()
    maxs = artifacts.maxs.cpu().numpy()
    outs, labels = [], []
    for yi in range(artifacts.n_y):
        n_c = int((label_idx == yi).sum())
        if n_c == 0:
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, _LOOP_STREAM, yi))
        if x1 is None:
            x1_c = torch.randn((n_c, artifacts.p), generator=gen,
                               device=device)
        else:
            x1_c = x1(yi, (n_c, artifacts.p)).to(device, torch.float32)
        x0 = spec.fn(x1_c[None], artifacts.class_forest(yi),
                     depth=fcfg.max_depth, n_t=fcfg.n_t, ts=ts,
                     eps=fcfg.eps_diff,
                     generator=gen if spec.stochastic else None)
        outs.append(unscale_host(x0[0].cpu().numpy(), mins[yi], maxs[yi]))
        labels.append(np.full((n_c,), artifacts.classes[yi]))
    X = np.concatenate(outs, axis=0)
    y = np.concatenate(labels, axis=0)
    perm = rng.permutation(len(X))
    return X[perm], y[perm]
