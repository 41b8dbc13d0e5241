"""A bucketed generate call's solve, replayed as one CUDA graph.

A call with ``pad_to`` solves at a fixed ``[n_y, m, p]``, the shape of a
serving bucket, so the same launches repeat call after call: an euler
solve of 100 timesteps enqueues 99 steps of ``tree_predict`` and the
step's elementwise kernels. On one CUDA device, for a deterministic
sampler, the first call of a shape solves eagerly, as every other call
does, and then captures the same solve into a CUDA graph
(:meth:`SolveGraph.capture`); a capture runs nothing on the device. Later
calls of the shape copy their x1 into the graph's static input and replay
it (:meth:`SolveGraph.replay`): the host enqueues one graph launch in place
of every step's launches. The kernels, their inputs and their order are the
eager solve's, so the rows are bit-equal.

:func:`graph_key` is the policy, a function of what the call can observe;
no option turns it on or off. It bypasses (the solve runs eagerly) a CPU
device, an unbucketed call (``pad_to`` None: its ``m`` follows the request
and the label draw, so a graph of each shape has no assured return), a
mesh (the sharded solve enqueues collectives) and a stochastic sampler
(``em`` draws from a ``torch.Generator`` each step). The serving plane
gives ``pad_to`` only where a request fits a bucket
(``ModelHandle.padding``): an oversize request solves at its exact size,
a shape of its own, and eagerly.

The graphs of an artifacts object live as long as it does (a finalizer;
nothing here holds the artifacts), at most :data:`GRAPHS_PER_MODEL` of
them, the least recently used evicted, so a serving refresh or eviction
frees their memory pools with the model. The registry's device budget
(``ModelRegistry(device_budget_bytes=)``) counts the artifacts and not
these pools. A graph also keys on the device addresses of the weights it
reads, so artifacts whose tensors were reassigned capture anew.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels.build import add_launches, recorded_launches

# an upper bound: serving's default buckets (64, 256, 1,024 rows a class)
# times the three deterministic samplers, of which a model serves its
# default sampler alone unless it is registered with more
GRAPHS_PER_MODEL = 9


def graph_key(device, *, sampler: str, stochastic: bool,
              pad_to: Optional[int], shape, mesh=None) -> Optional[tuple]:
    """``(sampler, shape, device)`` for a call whose solve a CUDA graph
    replays, or None where it runs eagerly: a device other than CUDA, a
    ``mesh``, a ``stochastic`` sampler or no ``pad_to``. ``shape`` is the
    call's ``(n_y, m, p)``."""
    device = torch.device(device)
    if (device.type != "cuda" or mesh is not None or pad_to is None
            or stochastic):
        return None
    return sampler, tuple(int(s) for s in shape), device


class SolveGraph:
    """One captured solve and everything its replays read and write: the
    static x1, the timestep grid the capture was given, the output in the
    graph's private memory pool, and the launches the capture recorded.

    A call's copy-in, replay and the reading of :attr:`out` form one
    critical section (:meth:`use`): a later call may overwrite both static
    tensors only once an earlier one has gathered its rows from ``out``.
    """

    def __init__(self, graph, x1: torch.Tensor, out: torch.Tensor,
                 ts: torch.Tensor, launches: collections.Counter,
                 stream: torch.cuda.Stream):
        self.graph, self.x1, self.out, self.ts = graph, x1, out, ts
        self.launches = launches
        self.lock = threading.Lock()
        self._stream = stream        # the stream of the last use
        self._done = torch.cuda.Event()

    @classmethod
    def capture(cls, solve: Callable[[torch.Tensor], torch.Tensor],
                x1: torch.Tensor, ts: torch.Tensor) -> "SolveGraph":
        """Capture ``solve`` (x1 -> unscaled rows, reading ``ts``) at
        ``x1``'s shape, on a side stream that waits for the current one.
        Not ``torch.cuda.graph``: it synchronizes the device and empties
        the caching allocators, pinned host buffers included."""
        device = x1.device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.stream(side), \
                recorded_launches() as launches:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                static_x1 = torch.empty_like(x1)   # in the graph's pool
                out = solve(static_x1)
            finally:
                graph.capture_end()
        return cls(graph, static_x1, out, ts, launches, current)

    @contextlib.contextmanager
    def use(self):
        """One call's critical section. A call on another stream than the
        last use's waits for that use first."""
        with self.lock:
            stream = torch.cuda.current_stream(self.x1.device)
            if stream != self._stream:
                stream.wait_event(self._done)
            try:
                yield self
            finally:
                self._done.record(stream)
                self._stream = stream

    def replay(self, x1: torch.Tensor) -> torch.Tensor:
        """The solve of ``x1`` on the current stream: ``out``, which the
        next replay overwrites. Call inside :meth:`use`. The launches the
        capture recorded, summing kernels by kind among them, are added to
        the counters and to this thread's
        :func:`~repro_torch.kernels.build.tallied_launches`, so a replayed
        call's ``sample.solve`` span reports its capture's."""
        self.x1.copy_(x1)
        self.graph.replay()
        add_launches(self.launches)
        return self.out


class _Graphs:
    """The graphs of one artifacts object, least recently used first."""

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: "collections.OrderedDict[tuple, SolveGraph]" = \
            collections.OrderedDict()

    def get(self, key) -> Optional[SolveGraph]:
        with self.lock:
            entry = self.entries.get(key)
            if entry is not None:
                self.entries.move_to_end(key)
            return entry

    def put(self, key, make: Callable[[], SolveGraph]) -> None:
        """``make()`` under the key unless one is there already; drops the
        least recently used past :data:`GRAPHS_PER_MODEL`."""
        with self.lock:
            if key not in self.entries:
                self.entries[key] = make()
            self.entries.move_to_end(key)
            while len(self.entries) > GRAPHS_PER_MODEL:
                self.entries.popitem(last=False)


# id(artifacts) -> its graphs; a finalizer of the artifacts removes the entry
_GRAPHS: Dict[int, _Graphs] = {}
_GRAPHS_LOCK = threading.Lock()


def graphs_of(artifacts) -> _Graphs:
    """The graphs captured from ``artifacts``, made at first use and
    dropped when the artifacts are collected."""
    with _GRAPHS_LOCK:
        graphs = _GRAPHS.get(id(artifacts))
        if graphs is None:
            graphs = _GRAPHS[id(artifacts)] = _Graphs()
            weakref.finalize(artifacts, _GRAPHS.pop, id(artifacts), None)
        return graphs


def _full_key(artifacts, key: tuple) -> tuple:
    weights = (artifacts.feat, artifacts.thr_val, artifacts.leaf,
               artifacts.mins, artifacts.maxs)
    return key + (tuple(t.data_ptr() for t in weights),)


def lookup(artifacts, key: tuple) -> Optional[SolveGraph]:
    """The graph of ``key`` (:func:`graph_key`) for ``artifacts``, if one
    was captured."""
    return graphs_of(artifacts).get(_full_key(artifacts, key))


def capture(artifacts, key: tuple, solve: Callable, x1: torch.Tensor,
            ts: torch.Tensor) -> None:
    """Capture ``solve`` for ``artifacts`` under ``key`` (see
    :meth:`SolveGraph.capture`), unless another call already has."""
    graphs_of(artifacts).put(_full_key(artifacts, key),
                             lambda: SolveGraph.capture(solve, x1, ts))
