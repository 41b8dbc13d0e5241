"""The generate driver of single-output models: the window of euler calls
of :mod:`harness.drivers.generate`, through
``TabularGenerator.generate_async`` / ``result``, over a model whose
(timestep, class) ensembles hold one scalar-leaf sub-forest an output
column (``multi_output`` false, S = p lanes), checked against
:mod:`harness.reference_so`.

It takes :func:`~harness.drivers.generate.keep` and
:func:`~harness.drivers.generate.instrument` from the generate driver.
Its own are the model (``feat`` / ``thr`` ``[n_t, n_y, p, T, H]``,
``leaf`` ``[n_t, n_y, p, T, L, 1]``, made on the device a timestep at a
time), the generator (artifacts with ``n_sub = p``), the control (the SO
reference in bfloat16), the check and the shapes; and :func:`setup`,
:func:`issue` and :func:`window`, which are the generate driver's own but
call this module's :func:`issue`: the generate driver's call its own
``issue`` by name, which sends the control to the multi-output reference.

The required work of a call (:func:`shapes`, read by
``metrics/gen_mfu_pct.py`` through :func:`harness.work.generate_call_s`):
at each solver step the rows read and written once, each of a class's
S·T scalar trees read once (2H + L words), and one add per row, tree and
lane. Reported as ``T`` = S·T trees of ``out`` = 1, the multi-output count
reads exactly that.
"""
from __future__ import annotations

import collections
import math
import time
from typing import Dict, List

import numpy as np
import torch

from harness import reference as ref
from harness import reference_so as ref_so
from harness.drivers.generate import State, instrument, keep  # noqa: F401
from harness.trace import span


def random_model(config: Dict, seed: int, device) -> Dict:
    """The configuration's whole single-output model with seeded random
    weights, made on the device: ``feat`` / ``thr`` ``[n_t, n_y, p, T,
    H]`` (features in ``[0, p)``, thresholds in ``[-1, 1]`` with ~10%
    +inf), ``leaf`` ``[n_t, n_y, p, T, L, 1]`` from N(0, 0.05²), so that a
    lane's sum of its trees' leaves spreads as a multi-output tree's column
    does, and per-class ``mins`` / ``maxs`` ``[n_y, p]``."""
    f = config["forest"]
    if f["multi_output"]:
        raise ValueError("the generate_so driver serves single-output "
                         "models")
    n_t, n_y, p = f["n_t"], config["n_classes"], config["p"]
    T, depth = f["n_trees"], f["max_depth"]
    H, L = 2 ** depth - 1, 2 ** depth
    g = torch.Generator(device=device)
    g.manual_seed(ref.stream_seed(seed, 12))
    feat = torch.empty((n_t, n_y, p, T, H), dtype=torch.int32,
                       device=device)
    thr = torch.empty((n_t, n_y, p, T, H), device=device)
    leaf = torch.empty((n_t, n_y, p, T, L, 1), device=device)
    for i in range(n_t):        # a timestep at a time: no model-size temps
        feat[i].random_(0, p, generator=g)
        thr[i].uniform_(-1.0, 1.0, generator=g)
        thr[i].masked_fill_(torch.rand(thr[i].shape, generator=g,
                                       device=device) < 0.1, math.inf)
        leaf[i].normal_(0.0, 0.05, generator=g)
    mins = torch.rand((n_y, p), generator=g, device=device)
    maxs = mins + 0.5 + 1.5 * torch.rand((n_y, p), generator=g, device=device)
    return {"feat": feat, "thr": thr, "leaf": leaf, "mins": mins,
            "maxs": maxs, "depth": depth, "classes": np.arange(n_y),
            "counts": np.full(n_y, config["rows_per_class"])}


def generator(config: Dict, model: Dict):
    """A ``TabularGenerator`` serving ``model``: the arrays as they are,
    ``n_sub = p`` sub-forests a class."""
    from repro_torch.config import ForestConfig
    from repro_torch.tabgen import ForestArtifacts, TabularGenerator
    fcfg = ForestConfig(**config["forest"])
    dev = model["feat"].device
    shape = model["feat"].shape[:3]
    arts = ForestArtifacts(
        feat=model["feat"], thr_val=model["thr"], leaf=model["leaf"],
        best_round=torch.full(shape, fcfg.n_trees - 1, dtype=torch.int32,
                              device=dev),
        rounds_run=torch.full(shape, fcfg.n_trees, dtype=torch.int32,
                              device=dev),
        val_curve=torch.zeros(shape + (fcfg.n_trees,), device=dev),
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
    """The control: the SO reference in bfloat16 in the program's place."""

    def __init__(self, state: State, seed: int):
        self.args = (state.model, state.cell.mix["rows"], seed,
                     state.cell.mix.get("pad_to"))

    def result(self):
        return ref_so.generate_call_so(*self.args, dtype=torch.bfloat16)


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


def check(state: State) -> Dict[str, float]:
    """The SO reference recomputes every sampled call from the model and
    the call's seed. ``row_gap``: the largest gap of a value, relative to
    its class's span of the feature. ``label_mismatch``: rows whose class
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
        Xr, yr = ref_so.generate_call_so(model, mix["rows"], seed,
                                         mix.get("pad_to"))
        missing += abs(len(X) - len(Xr))
        if len(X) != len(Xr):
            continue
        labels += int((np.asarray(y) != yr).sum())
        gap = max(gap, float(np.max(np.abs(X - Xr) / sp[yr])))
    return {"row_gap": gap, "label_mismatch": float(labels),
            "rows_missing": float(missing)}


def shapes(state: State) -> Dict:
    """The call's shapes; ``T`` counts the S·T scalar trees of a class and
    ``out`` is 1 (module docstring)."""
    cfg = state.cell.config
    f = cfg["forest"]
    return {"n_y": cfg["n_classes"], "p": cfg["p"],
            "T": cfg["p"] * f["n_trees"], "depth": f["max_depth"], "out": 1,
            "steps": f["n_t"] - 1, "rows": state.cell.mix["rows"],
            "predict_shapes": list(state.predict_shapes)}
