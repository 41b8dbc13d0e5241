"""The fit driver: a window of ``fit_artifacts`` calls, as a user trains a
dataset's grid of ensembles call by call.

Set-up makes the showers of every energy class from the seed (the same
rows a class for every seed), draws the calls' classes and fit seeds, and
warms up with a one-round fit of the cell's own group. Each call of the
window trains the mix's ``n_t_per_call`` timesteps x ``classes_per_call``
classes (one ensemble each) through
``repro_torch.tabgen.fitting.fit_artifacts``, with checkpoints streamed to a
fresh directory under ``TMPDIR`` that is removed after the call. The
bridge noise comes from the benchmark (``noise=``), drawn on the device
from the call's fit seed, so the reference can draw the same.

``fit_artifacts`` trains a whole grid of ``n_t`` timesteps from t = 0 and
has no entry for a chosen one, so a call of one timestep trains t = 0,
where the bridge's rows are the showers themselves and which the sampler
never evaluates. No cell of ``BENCHMARK.json`` uses this driver until the
program can train a timestep drawn from the seed.

A call cannot be cut, so the window runs calls until ``--seconds`` have
passed and finishes the call in progress; the record keeps the overrun.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from harness import reference as ref
from harness.showers import showers
from harness.trace import Wrapper, span

_NOISE_STREAM = 7


@dataclasses.dataclass
class State:
    cell: object
    fcfg: object
    data: Dict[int, np.ndarray]
    plan: List[tuple]
    rng_check: np.random.Generator
    hist_shapes: list = dataclasses.field(default_factory=list)
    kept: dict = dataclasses.field(default_factory=dict)


def forest_config(config: Dict, **changes):
    from repro_torch.config import ForestConfig
    return dataclasses.replace(ForestConfig(**config["forest"]), **changes)


def noise_fn(fit_seed: int, device):
    """The bridge noise of a call: ensemble ``eid``'s split ``split`` (0
    train, 1 validation) from a generator seeded by ``(fit_seed, eid,
    split)`` on the device."""
    def noise(eid, split, shape):
        gen = torch.Generator(device=device)
        gen.manual_seed(ref.stream_seed(fit_seed, _NOISE_STREAM, eid, split))
        return torch.randn(shape, generator=gen, device=device), None
    return noise


def call_rows(state: State, classes) -> tuple:
    X = np.concatenate([state.data[c] for c in classes])
    y = np.repeat(np.asarray(classes), [len(state.data[c]) for c in classes])
    return X, y


def setup(cell) -> State:
    cfg, mix = cell.config, cell.mix
    n_cls, k = cfg["n_classes"], mix["classes_per_call"]
    fcfg = forest_config(cfg, n_t=mix["n_t_per_call"],
                         hist_bf16=bool(cell.control))
    rows = cfg["rows_per_class"]
    data = {c: showers(cfg["dataset"], np.full(rows, c),
                       seed=[cell.seed, 1, c]) for c in range(n_cls)}
    rng = np.random.default_rng([cell.seed, 2])
    order = np.concatenate([rng.permutation(n_cls) for _ in range(64)])
    plan = [(tuple(sorted(int(c) for c in order[i * k:(i + 1) * k])),
             int(rng.integers(2 ** 62)))
            for i in range(len(order) // k)]
    state = State(cell, fcfg, data, plan,
                  np.random.default_rng([cell.seed, 3]))
    # warm-up: one round of the cell's own group, every level's shapes
    _fit(state, plan[-1], dataclasses.replace(fcfg, n_trees=1))
    return state


def _fit(state: State, call, fcfg):
    from repro_torch.tabgen.fitting import fit_artifacts
    classes, fit_seed = call
    X, y = call_rows(state, classes)
    ckpt = tempfile.mkdtemp(prefix="portbench-fit-")
    try:
        arts = fit_artifacts(X, y, fcfg, seed=fit_seed, checkpoint_dir=ckpt,
                             device=state.cell.device,
                             noise=noise_fn(fit_seed, state.cell.device))
        if state.cell.device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return arts


def instrument(state: State, w: Wrapper) -> None:
    """Spans around the fit's layers; the histogram calls' shapes."""
    def note(codes, node_id, g, w_, n_nodes, n_bins, ens=None):
        E = codes.shape[0] if codes.dim() == 3 else 1
        state.hist_shapes.append(
            (codes.shape[-2], codes.shape[-1], g.shape[2], g.shape[0],
             n_nodes, n_bins, codes.element_size(), E))
    w.wrap("repro_torch.forest.tree", "build_histogram", "bench.hist", note)
    w.wrap("repro_torch.forest.tree", "best_splits", "bench.best_splits")
    w.wrap("repro_torch.tabgen.fitting", "prepare_classes",
           "bench.prepare_classes")
    w.wrap("repro_torch.tabgen.fitting", "weighted_edges",
           "bench.weighted_edges")
    w.wrap("repro_torch.train.checkpoint", "write_batch_npz",
           "bench.checkpoint")


def launches() -> int:
    from repro_torch.kernels.hist.ops import histogram
    return getattr(histogram, "launches", 0)


def window(state: State, seconds: float, tracing: bool) -> Dict:
    calls = []
    hist0 = launches()
    t_start = time.perf_counter()
    for i, call in enumerate(state.plan):
        t0 = time.perf_counter()
        with span("bench.call", tracing):
            arts = _fit(state, call, state.fcfg)
        t1 = time.perf_counter()
        n_ens = state.fcfg.n_t * len(call[0])
        calls.append({"t0": t0 - t_start, "t1": t1 - t_start,
                      "ensembles": n_ens})
        # a sample of one call, drawn from the seed as the calls finish
        if state.rng_check.random() < 1.0 / (i + 1):
            state.kept = {"call": call, "arts": arts}
        del arts
        if t1 - t_start >= seconds:
            break
    t_end = calls[-1]["t1"]
    return {"calls": calls, "elapsed_s": t_end, "seconds": seconds,
            "overrun_s": t_end - seconds,
            "ensembles": sum(c["ensembles"] for c in calls),
            "hist_launches": launches() - hist0}


def check(state: State) -> Dict[str, float]:
    """The reference follows one ensemble of the sampled call, drawn from
    the seed, through every round: its leaves and validation curve in
    each, its splits in the mix's ``check_split_rounds`` rounds, drawn from
    the seed (:func:`harness.reference.follow_fit`)."""
    classes, fit_seed = state.kept["call"]
    rounds = state.fcfg.n_trees
    split_rounds = state.rng_check.choice(
        rounds, min(rounds, int(state.cell.mix["check_split_rounds"])),
        replace=False)
    yi = int(state.rng_check.integers(len(classes)))
    ti = int(state.rng_check.integers(state.fcfg.n_t))
    arts = state.kept["arts"]
    prog = {f: getattr(arts, f)[ti, yi, 0].cpu().numpy()
            for f in ("feat", "thr_val", "leaf", "val_curve")}
    prog["mins"] = arts.mins[yi].cpu().numpy()
    prog["maxs"] = arts.maxs[yi].cpu().numpy()
    state.kept["arts"] = arts = None
    device = state.cell.device
    if device.type == "cuda":
        torch.cuda.empty_cache()
    fcfg = dataclasses.asdict(state.fcfg)
    rows = state.data[classes[yi]]
    shape = (len(rows) * fcfg["duplicate_k"], rows.shape[1])
    noise = noise_fn(fit_seed, device)
    eid = ti * len(classes) + yi
    t = float(ref.flow_grid(fcfg["n_t"])[ti])
    return ref.follow_fit(rows, noise(eid, 0, shape)[0],
                          noise(eid, 1, shape)[0], t, fcfg, prog, device,
                          split_rounds=sorted(int(r) for r in split_rounds))


def shapes(state: State) -> Dict:
    """What the metric readers need of the configuration's shapes."""
    cfg = state.cell.config
    f = state.fcfg
    p = cfg["p"]
    return {"n": cfg["rows_per_class"] * f.duplicate_k, "p": p,
            "out": p if f.multi_output else 1, "depth": f.max_depth,
            "n_bins": f.n_bins, "rounds": f.n_trees,
            "lanes": 1 if f.multi_output else p,
            "hist_shapes": list(state.hist_shapes)}
