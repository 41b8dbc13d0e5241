"""Forest training driver: the port's ``repro.launch.train_forest``.

Fits the (timestep, class) ensemble grid, on one device or sharded over a
``(data, model)`` mesh of ranks (``--mesh``), with streaming checkpoints
(``--checkpoint-dir`` / ``--resume``), and saves artifacts in the JAX
package's format. ``--device cpu`` runs the plain PyTorch path; without it
the fit takes the GPU and raises where there is none.

Out-of-core training from an ingested store (``repro_torch.launch.ingest``)
on one device: rows are read from the store's shards, class stats come
from its manifest:

  PYTHONPATH=src python -m repro_torch.launch.train_forest \\
      --data-dir data/synth --mesh none --device cpu --out model

Sharded, one process per rank under ``torchrun``, which sets the ranks in
the environment; the process group is NCCL on GPUs and gloo with
``--device cpu``:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m \\
      repro_torch.launch.train_forest --data-dir data/synth --mesh 2x1 \\
      --device cpu --out model

A ``1x1`` mesh without ``torchrun`` builds a one-rank group itself. The
sharded trainer trains its batches one after another, writing each
batch's checkpoint as it finishes, like the single-device one.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist


def parse_mesh(spec: str, device: torch.device):
    """``none`` | ``auto`` | ``DxM`` (data x model ranks) -> ``(mesh or
    None, whether a process group was initialised here)``. A ``DxM`` mesh
    needs an initialised process group of D·M ranks (``torchrun``), except
    ``1x1``, which initialises a one-rank group if there is none."""
    from repro_torch.launch.mesh import auto_forest_mesh, forest_mesh
    if spec == "none":
        return None, False
    if spec == "auto":
        return auto_forest_mesh(), False
    dims = tuple(int(d) for d in spec.split("x"))
    if len(dims) != 2:
        raise ValueError(f"--mesh {spec!r}: expected 'auto', 'none' or DxM")
    owned = not dist.is_initialized() and dims == (1, 1)
    if owned:
        dist.init_process_group(_backend(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    return forest_mesh(*dims, device), owned


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _init_from_env(device: torch.device) -> bool:
    """Under ``torchrun`` (``WORLD_SIZE`` in the environment): initialise
    the process group from it and take this rank's GPU. Returns whether a
    group was initialised here."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(_backend(device))
    return True


def _demo_data(n: int, p: int, n_y: int, seed: int):
    from repro_torch.data.tabular import synthetic_resource_dataset
    return synthetic_resource_dataset(n, p, n_y, seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None,
                    help=".npz with X [n, p] (and optionally y [n])")
    ap.add_argument("--data-dir", default=None,
                    help="DatasetStore directory from "
                         "repro_torch.launch.ingest: an out-of-core fit "
                         "(overrides --data/--demo)")
    ap.add_argument("--demo", action="store_true",
                    help="train on a synthetic dataset instead of --data")
    ap.add_argument("--demo-rows", type=int, default=2048)
    ap.add_argument("--demo-cols", type=int, default=8)
    ap.add_argument("--demo-classes", type=int, default=2)
    ap.add_argument("--mesh", default="auto",
                    help="'auto' (all GPUs), 'none' (one device), or DxM "
                         "e.g. 2x1 (under torchrun)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the GPU")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ensembles-per-batch", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="base path for the saved .npz/.json artifact pair")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="after the fit, write the process metrics "
                         "registry as Prometheus text ('-' for stdout)")
    ap.add_argument("--seed", type=int, default=0)
    # ForestConfig knobs (paper Table 9 names)
    ap.add_argument("--method", default="flow",
                    choices=("flow", "diffusion"))
    ap.add_argument("--n-t", type=int, default=10)
    ap.add_argument("--duplicate-k", type=int, default=20)
    ap.add_argument("--n-trees", type=int, default=40)
    ap.add_argument("--max-depth", type=int, default=5)
    ap.add_argument("--n-bins", type=int, default=64)
    ap.add_argument("--learning-rate", type=float, default=0.3)
    ap.add_argument("--reg-lambda", type=float, default=1.0)
    ap.add_argument("--sigma", type=float, default=0.0)
    ap.add_argument("--multi-output", action="store_true")
    ap.add_argument("--early-stop-rounds", type=int, default=0)
    ap.add_argument("--int8-codes", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.config import ForestConfig
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.tabgen import fitting

    device = resolve_device(args.device)
    owned = _init_from_env(device)
    try:
        rank = dist.get_rank() if dist.is_initialized() else 0
        say = print if rank == 0 else (lambda *a, **k: None)
        if args.data_dir:
            from repro_torch.data.store import DatasetStore
            X, y = DatasetStore(args.data_dir), None
            say(f"store {args.data_dir}: {X.n_rows} rows x {X.p} cols in "
                f"{X.n_shards} shards ({X.nbytes / 2**20:.1f} MiB on disk, "
                "streamed — not resident)")
        elif args.demo or args.data is None:
            X, y = _demo_data(args.demo_rows, args.demo_cols,
                              args.demo_classes, args.seed)
            say(f"demo dataset: X {X.shape}, {args.demo_classes} classes")
        else:
            with np.load(args.data) as d:
                X = d["X"]
                y = d["y"] if "y" in d.files else None
            say(f"loaded {args.data}: X {X.shape}"
                + (f", y {y.shape}" if y is not None else ", unlabeled"))

        fcfg = ForestConfig(
            method=args.method, n_t=args.n_t, duplicate_k=args.duplicate_k,
            n_trees=args.n_trees, max_depth=args.max_depth,
            n_bins=args.n_bins, learning_rate=args.learning_rate,
            reg_lambda=args.reg_lambda, sigma=args.sigma,
            multi_output=args.multi_output,
            early_stop_rounds=args.early_stop_rounds,
            int8_codes=args.int8_codes)
        mesh, made = parse_mesh(args.mesh, device)
        owned = owned or made
        if mesh is None and args.data_dir:
            say(f"trainer: out-of-core store fit on one rank ({device}, "
                "rows read from the store's shards)")
        elif mesh is None:
            say(f"trainer: single-device ({device})")
        else:
            shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
            say(f"trainer: sharded over {shape} ranks on {device}")

        t0 = time.time()
        art = fitting.fit_artifacts(
            X, y, fcfg, seed=args.seed, checkpoint_dir=args.checkpoint_dir,
            resume=args.resume, ensembles_per_batch=args.ensembles_per_batch,
            mesh=mesh, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
        n_ens = art.n_t * art.n_y
        # every ensemble trains on all n rows, duplicated K-fold
        rows = X.shape[0] * fcfg.duplicate_k * n_ens
        say(f"trained {n_ens} ensembles ({art.n_t} timesteps x {art.n_y} "
            f"classes) in {wall:.2f}s -> {rows / wall:,.0f} "
            "ensemble-rows/sec")
        say(json.dumps({"wall_s": round(wall, 3),
                        "ensemble_rows_per_sec": round(rows / wall),
                        "rows_per_sec": round(X.shape[0] * n_ens / wall)}))
        if args.out and rank == 0:
            base = art.save(args.out)
            say(f"artifacts saved to {base}.npz / {base}.json")
        if args.metrics_dump and rank == 0:
            from repro_torch.launch.metrics import dump
            dump(args.metrics_dump)
        return art
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
