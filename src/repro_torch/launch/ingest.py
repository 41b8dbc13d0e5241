"""Dataset ingestion driver: stream any row source into a DatasetStore.

The port's ``repro.launch.ingest``: numpy only, and the store it writes is
the JAX package's format. One pass over the source writes the columnar
row-sharded store plus the precomputed statistics every fit needs (class
histogram, per-class min/max scalers, mergeable per-feature quantile
sketches) — see :mod:`repro_torch.data.store`. ``train_forest --data-dir``
then fits out-of-core from the result.

Sources (exactly one):

  --synthetic NxPxC   paper D.1 generator, e.g. ``--synthetic 1000000x32x4``
  --calo NAME:N       synthetic CaloChallenge showers, e.g.
                      ``--calo photons_mini:120000``
  --npz FILE          an .npz with ``X [n, p]`` (optionally ``y [n]``) —
                      loaded once by numpy, so it must fit in RAM; a plain
                      ``.npy`` feature file streams via memmap instead
                      (never fully resident)
  --csv FILE          numeric CSV, streamed line-chunk by line-chunk
                      (``--label-col`` marks an integer label column)

Examples::

  PYTHONPATH=src python -m repro_torch.launch.ingest \
      --out data/synth1m --synthetic 1000000x32x4 --shard-rows 65536

  PYTHONPATH=src python -m repro_torch.launch.ingest \
      --out data/synth1m --synthetic 1000000x32x4 --resume   # after a crash

A crash mid-ingest leaves a consistent partial store; re-running with
``--resume`` (same source spec — fingerprint-checked) skips the committed
shards and finishes the stream.
"""
from __future__ import annotations

import argparse
import io
import json
import time

import numpy as np


def _npz_batches(path: str, batch_rows: int):
    """.npy sources stream via a true memmap (only the yielded chunk is
    ever resident); .npz archives are zip members numpy loads whole —
    fine up to RAM, use .npy (or re-save) for larger-than-RAM inputs."""
    if path.endswith(".npy"):
        X, y = np.load(path, mmap_mode="r"), None
    else:
        with np.load(path) as d:   # np.load ignores mmap_mode inside .npz
            X = d["X"]
            y = d["y"] if "y" in d.files else None
    for s in range(0, X.shape[0], batch_rows):
        xb = np.asarray(X[s:s + batch_rows], np.float32)
        yield (xb, np.asarray(y[s:s + batch_rows])) if y is not None \
            else xb


def _csv_batches(path: str, batch_rows: int, label_col):
    """Stream a numeric CSV without loading it whole; non-numeric first
    line is treated as a header and skipped."""
    def parse(lines):
        arr = np.loadtxt(io.StringIO("".join(lines)), delimiter=",",
                         ndmin=2, dtype=np.float64)
        if label_col is None:
            return arr.astype(np.float32)
        y = arr[:, label_col].astype(np.int64)
        X = np.delete(arr, label_col % arr.shape[1], axis=1)
        return X.astype(np.float32), y

    with open(path) as f:
        first = f.readline()
        buf = []
        try:
            np.loadtxt(io.StringIO(first), delimiter=",")
            buf.append(first)
        except ValueError:
            pass                                   # header line
        for line in f:
            if line.strip():
                buf.append(line)
            if len(buf) >= batch_rows:
                yield parse(buf)
                buf = []
        if buf:
            yield parse(buf)


def _source_batches(args):
    """(batches iterator, fingerprintable source description)."""
    if args.synthetic:
        from repro_torch.data.tabular import synthetic_resource_batches
        n, p, n_y = (int(v) for v in args.synthetic.split("x"))
        # batch_rows is part of the stream identity: batch b draws from
        # PRNG stream [seed, b], so a resume under a different --batch-rows
        # would skip rows of a *different* stream — fingerprint it
        spec = {"kind": "synthetic", "n": n, "p": p, "n_y": n_y,
                "seed": args.seed, "batch_rows": args.batch_rows}
        return (synthetic_resource_batches(
            n, p, n_y, batch_rows=args.batch_rows, seed=args.seed), spec)
    if args.calo:
        from repro_torch.data.calorimeter import generate_batches
        name, n = args.calo.split(":")
        spec = {"kind": "calo", "dataset": name, "n": int(n),
                "seed": args.seed, "batch_rows": args.batch_rows}
        return (generate_batches(name, int(n), batch_rows=args.batch_rows,
                                 seed=args.seed), spec)
    if args.npz:
        return (_npz_batches(args.npz, args.batch_rows),
                {"kind": "npz", "path": args.npz})
    if args.csv:
        return (_csv_batches(args.csv, args.batch_rows, args.label_col),
                {"kind": "csv", "path": args.csv,
                 "label_col": args.label_col})
    raise SystemExit("pick a source: --synthetic / --calo / --npz / --csv")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="store directory to create (or resume)")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--synthetic", default=None, metavar="NxPxC")
    src.add_argument("--calo", default=None, metavar="NAME:N")
    src.add_argument("--npz", default=None,
                     help=".npz with X/y (RAM-resident) or a .npy feature "
                          "file (memmap-streamed)")
    src.add_argument("--csv", default=None)
    ap.add_argument("--label-col", type=int, default=None,
                    help="CSV column holding integer labels")
    ap.add_argument("--batch-rows", type=int, default=8192,
                    help="rows per source batch (peak ingest memory knob)")
    ap.add_argument("--shard-rows", type=int, default=65536,
                    help="rows per on-disk shard")
    ap.add_argument("--sketch-entries", type=int, default=2048,
                    help="quantile-sketch summary size per feature (exact "
                         "below this many rows; ~1/entries rank error "
                         "beyond)")
    ap.add_argument("--resume", action="store_true",
                    help="continue a crashed ingest (fingerprint-checked)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="after the ingest, write the process metrics "
                         "registry as Prometheus text ('-' for stdout)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.data.store import ingest

    batches, spec = _source_batches(args)
    t0 = time.time()
    store = ingest(batches, args.out, shard_rows=args.shard_rows,
                   resume=args.resume, source=spec,
                   sketch_entries=args.sketch_entries)
    wall = time.time() - t0
    classes, counts, _, _ = store.class_stats()
    summary = {
        "store": args.out,
        "n_rows": store.n_rows,
        "p": store.p,
        "n_shards": store.n_shards,
        "dataset_bytes": store.nbytes,
        "classes": {int(c): int(k) for c, k in zip(classes, counts)},
        "wall_s": round(wall, 3),
        "rows_per_sec": round(store.n_rows / max(wall, 1e-9)),
    }
    print(json.dumps(summary))
    print(f"ingested {store.n_rows} rows x {store.p} cols into "
          f"{store.n_shards} shards at {args.out} "
          f"(train: python -m repro_torch.launch.train_forest --data-dir "
          f"{args.out})")
    if args.metrics_dump:
        from repro_torch.launch.metrics import dump
        dump(args.metrics_dump)
    return store


if __name__ == "__main__":
    main()
