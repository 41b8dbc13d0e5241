"""The generate driver: a window of euler calls through
``TabularGenerator.generate_async`` / ``result``, as a user draws samples.

Set-up makes the whole model of the configuration (every timestep and
class, seeded random weights made on the device in a few large calls:
features in ``[0, p)``, thresholds in ``[-1, 1]`` with ~10% +inf, small
leaves so the flow stays bounded) and warms up the cell's own call shape
with the mix's calls in flight. The window issues calls of the mix's
``rows`` (and ``pad_to`` a class), each with a new seed drawn from the run's
seed, keeping ``in_flight`` of them issued: a client that issues call k+1
before it asks for call k's rows (``in_flight`` 2) or one that waits for
each reply (1). A call's latency runs from its issue to its rows on the
host. Issuing stops once ``--seconds`` have passed; the calls in flight
are finished and counted.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, List

import numpy as np
import torch

from harness import reference as ref
from harness.trace import Wrapper, span


@dataclasses.dataclass
class State:
    cell: object
    gen: object
    model: Dict
    seeds: np.random.Generator
    rng_check: np.random.Generator
    predict_shapes: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)
    calls_seen: int = 0


def random_model(config: Dict, seed: int, device) -> Dict:
    """The configuration's whole model with seeded random weights, made on
    the device: ``feat`` / ``thr`` ``[n_t, n_y, T, H]``, ``leaf`` ``[n_t,
    n_y, T, L, p]``, per-class ``mins`` / ``maxs`` ``[n_y, p]``."""
    f = config["forest"]
    if not f["multi_output"]:
        raise ValueError("the generate driver serves multi-output models")
    n_t, n_y, p = f["n_t"], config["n_classes"], config["p"]
    T, depth = f["n_trees"], f["max_depth"]
    H, L = 2 ** depth - 1, 2 ** depth
    g = torch.Generator(device=device)
    g.manual_seed(ref.stream_seed(seed, 11))
    feat = torch.randint(0, p, (n_t, n_y, T, H), generator=g, device=device,
                         dtype=torch.int32)
    thr = torch.rand((n_t, n_y, T, H), generator=g, device=device) * 2 - 1
    thr[torch.rand(thr.shape, generator=g, device=device) < 0.1] = math.inf
    leaf = torch.randn((n_t, n_y, T, L, p), generator=g,
                       device=device).mul_(0.05)
    mins = torch.rand((n_y, p), generator=g, device=device)
    maxs = mins + 0.5 + 1.5 * torch.rand((n_y, p), generator=g, device=device)
    return {"feat": feat, "thr": thr, "leaf": leaf, "mins": mins,
            "maxs": maxs, "depth": depth, "classes": np.arange(n_y),
            "counts": np.full(n_y, config["rows_per_class"])}


def generator(config: Dict, model: Dict):
    """A ``TabularGenerator`` serving ``model`` (the arrays as they are,
    with one sub-forest a class)."""
    from repro_torch.config import ForestConfig
    from repro_torch.tabgen import ForestArtifacts, TabularGenerator
    fcfg = ForestConfig(**config["forest"])
    shape = model["feat"].shape[:2] + (1,)
    arts = ForestArtifacts(
        feat=model["feat"][:, :, None], thr_val=model["thr"][:, :, None],
        leaf=model["leaf"][:, :, None],
        best_round=torch.full(shape, fcfg.n_trees - 1, dtype=torch.int32,
                              device=model["feat"].device),
        rounds_run=torch.full(shape, fcfg.n_trees, dtype=torch.int32,
                              device=model["feat"].device),
        val_curve=torch.zeros(shape + (fcfg.n_trees,),
                              device=model["feat"].device),
        mins=model["mins"], maxs=model["maxs"], classes=model["classes"],
        counts=model["counts"], config=fcfg)
    gen = TabularGenerator(fcfg)
    gen.artifacts = arts
    return gen


def setup(cell) -> State:
    model = random_model(cell.config, cell.seed, cell.device)
    state = State(cell, generator(cell.config, model), model,
                  np.random.default_rng([cell.seed, 4]),
                  np.random.default_rng([cell.seed, 5]))
    mix = cell.mix
    # warm-up: the cell's own call shape, with the mix's calls in flight
    handles = [issue(state, int(state.seeds.integers(2 ** 62)))
               for _ in range(mix["in_flight"])]
    for h in handles:
        h.result()
    return state


def issue(state: State, seed: int):
    mix = state.cell.mix
    if state.cell.control:
        return _ReferenceCall(state, seed)
    return state.gen.generate_async(mix["rows"], seed=seed,
                                    pad_to=mix.get("pad_to"))


class _ReferenceCall:
    """The control: the reference in bfloat16 in the program's place."""

    def __init__(self, state: State, seed: int):
        self.args = (state.model, state.cell.mix["rows"], seed,
                     state.cell.mix.get("pad_to"))

    def result(self):
        return ref.generate_call(*self.args, dtype=torch.bfloat16)


def instrument(state: State, w: Wrapper) -> None:
    """Spans around the solve's kernel and the host finish; the kernel
    calls' shapes."""
    def note(x, feat, thr_val, leaf, depth):
        B, S, T = feat.shape[:3]
        state.predict_shapes.append(
            (B, S, T, depth, x.shape[2], leaf.shape[-1], x.shape[1]))
    w.wrap("repro_torch.forest.packed", "forest_predict",
           "bench.tree_predict", note)


def window(state: State, seconds: float, tracing: bool) -> Dict:
    mix = state.cell.mix
    pending: collections.deque = collections.deque()
    calls: List[Dict] = []
    t_start = time.perf_counter()

    def start():
        seed = int(state.seeds.integers(2 ** 62))
        t0 = time.perf_counter()
        with span("bench.issue", tracing):
            pending.append((seed, t0, issue(state, seed)))

    start()
    while pending:
        while (len(pending) < mix["in_flight"]
               and time.perf_counter() - t_start < seconds):
            start()
        seed, t0, handle = pending.popleft()
        t_ask = time.perf_counter()
        with span("bench.result", tracing):
            X, y = handle.result()
        t1 = time.perf_counter()
        calls.append({"t0": t0 - t_start, "t1": t1 - t_start,
                      "rows": len(X), "result_s": t1 - t_ask})
        keep(state, seed, X, y)
        if not pending and t1 - t_start < seconds:
            start()
    t_end = calls[-1]["t1"]
    return {"calls": calls, "elapsed_s": t_end, "seconds": seconds,
            "overrun_s": t_end - seconds,
            "rows": sum(c["rows"] for c in calls),
            "latencies_s": [c["t1"] - c["t0"] for c in calls]}


def keep(state: State, seed: int, X, y) -> None:
    """A sample of ``check_calls`` finished calls, drawn from the seed as
    they finish (reservoir sampling)."""
    k = state.cell.mix["check_calls"]
    i = state.calls_seen
    state.calls_seen += 1
    if i < k:
        state.kept.append((seed, X, y))
    else:
        j = int(state.rng_check.integers(i + 1))
        if j < k:
            state.kept[j] = (seed, X, y)


def check(state: State) -> Dict[str, float]:
    """The reference recomputes every sampled call from the model and the
    call's seed. ``row_gap``: the largest gap of a value, relative to its
    class's span of the feature. ``label_mismatch``: rows whose class
    differs (exact). ``rows_missing``: rows asked for and not returned, or
    returned and not asked for (exact)."""
    state.gen = None
    if state.cell.device.type == "cuda":
        torch.cuda.empty_cache()
    mix = state.cell.mix
    model = state.model
    sp = ref.span(model["mins"], model["maxs"]).cpu().numpy()
    gap, labels, missing = 0.0, 0, 0
    for seed, X, y in state.kept:
        Xr, yr = ref.generate_call(model, mix["rows"], seed,
                                   mix.get("pad_to"))
        missing += abs(len(X) - len(Xr))
        if len(X) != len(Xr):
            continue
        labels += int((np.asarray(y) != yr).sum())
        gap = max(gap, float(np.max(np.abs(X - Xr) / sp[yr])))
    return {"row_gap": gap, "label_mismatch": float(labels),
            "rows_missing": float(missing)}


def shapes(state: State) -> Dict:
    cfg = state.cell.config
    f = cfg["forest"]
    return {"n_y": cfg["n_classes"], "p": cfg["p"], "T": f["n_trees"],
            "depth": f["max_depth"], "out": cfg["p"],
            "steps": f["n_t"] - 1, "rows": state.cell.mix["rows"],
            "predict_shapes": list(state.predict_shapes)}
