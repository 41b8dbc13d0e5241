"""Incremental freshness loop: append rows, extend the forest, hot-swap.

The port's twin of the JAX package's ``repro.launch.refresh``. One command
drives the whole refresh path end to end:

1. **append** — stream a row source (same flags as
   ``repro_torch.launch.ingest``) into an *existing*
   :class:`~repro_torch.data.store.DatasetStore` via
   :meth:`DatasetStore.append`: sketches merge, class stats update, the
   manifest version bumps, and readers of the old snapshot keep working.
2. **fit** — warm-start extend the base model on the grown store with
   :func:`repro_torch.tabgen.extend_artifacts` on ``--device`` (default:
   the GPU, or exit with an error; ``cpu`` runs the plain path): the base
   trees are reused verbatim and only ``--extra-trees`` new boosting
   rounds train, through the same batch loop as a cold fit.
3. **save** — write the extended artifact pair (base schema rides along),
   with lineage metadata (store fingerprint/version/rows, base round
   range) in the JSON sidecar.
4. **swap** — ``POST /v1/models/<name>/reload`` against a running
   ``repro_torch.launch.serve_http`` (or ``repro.launch.serve_http``:
   the artifacts are the same format) instance, which loads the new
   artifacts and
   atomically swaps them into the registry; in-flight requests finish on
   the old version.

Steps 1 and 4 are optional: omit the source flags to refit on the store
as-is, omit ``--server`` for an offline extend (swap later by hand).

Example — nightly refresh of a served model::

  PYTHONPATH=src python -m repro_torch.launch.refresh \
      --store data/synth1m --synthetic 100000x32x4 --seed 1 \
      --artifacts models/synth --out models/synth_v2 --extra-trees 10 \
      --server http://127.0.0.1:8433 --model synth

Observability: the run is wrapped in ``refresh.append`` / ``refresh.fit``
/ ``refresh.save`` / ``refresh.swap`` spans on the process tracer, and
records ``refresh_runs{status}``, ``refresh_rows_appended``,
``refresh_trees_added`` and the ``refresh_fit_seconds`` histogram in the
process metrics registry (``--metrics-dump`` exports them).
"""
from __future__ import annotations

import argparse
import json
import time
import urllib.error
import urllib.request


def swap_model(server: str, model: str, path: str, timeout: float = 60.0
               ) -> dict:
    """``POST {server}/v1/models/{model}/reload`` — returns the response
    body (new version/nbytes/lineage) or raises with the server's error."""
    url = f"{server.rstrip('/')}/v1/models/{model}/reload"
    body = json.dumps({"path": path}).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace")
        raise RuntimeError(
            f"reload rejected by {url}: HTTP {e.code} {detail}") from e


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", required=True,
                    help="existing DatasetStore directory to append to / "
                         "refit from")
    ap.add_argument("--artifacts", required=True,
                    help="base model artifact path (from train_forest "
                         "--out or a previous refresh)")
    ap.add_argument("--out", required=True,
                    help="path for the extended artifact pair")
    ap.add_argument("--extra-trees", type=int, required=True,
                    help="boosting rounds to add on top of the base model")
    # append source — same flags as repro_torch.launch.ingest; all optional:
    # omitting them skips the append and refits on the store as-is
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--synthetic", default=None, metavar="NxPxC")
    src.add_argument("--calo", default=None, metavar="NAME:N")
    src.add_argument("--npz", default=None)
    src.add_argument("--csv", default=None)
    ap.add_argument("--label-col", type=int, default=None)
    ap.add_argument("--batch-rows", type=int, default=8192)
    ap.add_argument("--resume", action="store_true",
                    help="finish a crashed refresh: resume the append "
                         "(fingerprint-checked) and the fit checkpoint")
    # fit knobs (subset of train_forest)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the GPU")
    ap.add_argument("--mesh", default="none",
                    help="'auto', 'none' (default) or DxM e.g. 2x1 (under "
                         "torchrun)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="streaming fit checkpoints; a dir holding the "
                         "*base* run's checkpoint is accepted (warm-base "
                         "fingerprint match) and overwritten")
    ap.add_argument("--seed", type=int, default=0)
    # swap target — optional: omit for an offline extend
    ap.add_argument("--server", default=None,
                    help="base URL of a running serve_http, e.g. "
                         "http://127.0.0.1:8433")
    ap.add_argument("--model", default=None,
                    help="registry name to hot-swap on --server")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="write the process metrics registry as Prometheus "
                         "text ('-' for stdout)")
    args = ap.parse_args(argv)
    if bool(args.server) != bool(args.model):
        raise SystemExit("--server and --model go together")

    import torch.distributed as dist

    from repro_torch.data.store import DatasetStore
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.launch.ingest import _source_batches
    from repro_torch.launch.train_forest import parse_mesh
    from repro_torch.obs import default_registry, default_tracer
    from repro_torch.tabgen import TabularGenerator, extend_artifacts

    reg, tracer = default_registry(), default_tracer()
    c_runs = reg.counter("refresh_runs", "Refresh loop runs", ("status",))
    c_rows = reg.counter("refresh_rows_appended",
                         "Rows appended to stores by refresh runs")
    c_trees = reg.counter("refresh_trees_added",
                          "Boosting rounds added by refresh runs")
    h_fit = reg.histogram("refresh_fit_seconds",
                          "Warm-start extension fit wall time",
                          buckets=(1.0, 5.0, 15.0, 60.0, 300.0, 1800.0))

    device = resolve_device(args.device)
    summary = {"store": args.store, "base": args.artifacts, "out": args.out}
    owned = False
    try:
        store = DatasetStore(args.store)
        base_rows = store.n_rows
        has_source = any((args.synthetic, args.calo, args.npz, args.csv))
        if has_source or args.resume:
            with tracer.span("refresh.append", store=args.store):
                batches, spec = (_source_batches(args) if has_source
                                 else (iter(()), None))
                store = store.append(batches, source=spec,
                                     resume=args.resume, metrics=reg,
                                     tracer=tracer)
        appended = store.n_rows - base_rows
        c_rows.inc(int(appended))
        summary.update(rows=store.n_rows, rows_appended=appended,
                       store_version=store.version)
        print(f"store {args.store}: +{appended} rows -> {store.n_rows} "
              f"(version {store.version})")

        base = TabularGenerator.load(args.artifacts, device=device)
        mesh, owned = parse_mesh(args.mesh, device)
        t0 = time.time()
        with tracer.span("refresh.fit", extra_trees=args.extra_trees):
            ext = extend_artifacts(
                base.artifacts, store, extra_trees=args.extra_trees,
                seed=args.seed, mesh=mesh,
                checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                device=device)
        fit_wall = time.time() - t0
        h_fit.observe(fit_wall)
        c_trees.inc(args.extra_trees)
        summary.update(
            fit_wall_s=round(fit_wall, 3),
            n_trees=ext.config.n_trees,
            rows_per_sec=round(store.n_rows * ext.n_t * ext.n_y
                               / max(fit_wall, 1e-9)))
        print(f"extended {base.artifacts.config.n_trees} -> "
              f"{ext.config.n_trees} trees in {fit_wall:.2f}s")

        with tracer.span("refresh.save", path=args.out):
            out_gen = TabularGenerator(ext.config, schema=base.schema)
            out_gen.artifacts = ext
            out_gen.save(args.out)
        summary["lineage"] = ext.lineage

        if args.server:
            with tracer.span("refresh.swap", model=args.model):
                resp = swap_model(args.server, args.model, args.out)
            summary.update(swapped=args.model,
                           served_version=resp.get("version"))
            print(f"swapped {args.model} on {args.server} -> "
                  f"version {resp.get('version')}")
    except Exception:
        c_runs.inc(1, status="error")
        raise
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    c_runs.inc(1, status="ok")

    print(json.dumps(summary))
    if args.metrics_dump:
        from repro_torch.launch.metrics import dump
        dump(args.metrics_dump)
    return summary


if __name__ == "__main__":
    main()
