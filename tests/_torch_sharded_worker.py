"""One rank of the port's sharded sampling and serving on a gloo group, for
``tests/test_torch_sharded_sampling.py``.

    PYTHONPATH=src python tests/_torch_sharded_worker.py RANK WORLD WORKDIR

Reads the models (``<name>.npz`` / ``.json``, saved by the port) and the
cases (``cases.json``) from WORKDIR. For each sampling case every rank
calls ``sample(mesh=)`` with the whole model and with its ``shard(mesh)``
slice and writes its rows to ``rank<r>_<case>.npz``. For each solve case
it runs ``solve_sharded`` on the JAX package's x1 and step noise
(``jax_inputs_<model>.npz``) and rank 0 writes ``solve_<case>.npz``. Then
rank 0 serves requests of 17, 40 and 90 rows from a ``ForestServer`` on
the 2x1 mesh, with a swap after the second, writing the rows and batches
to ``served.npz``, while rank 1 follows; each rank writes ``done<r>.json``.
Then rank 0 serves again with a failure planted after a batch's
publication: it writes what each request got to ``fault0.json``, and rank
1 writes how its follow ended to ``fault1.json``. For each impute case
every rank calls ``impute(mesh=)`` with the whole model, with its slice,
and with the JAX package's noise (``impute_<model>.npz``), writing
``rank<r>_impute_<case>.npz``. Rank 0 then refuses four bad imputes (three
through the HTTP plane, one through the server) and serves two imputes and
a request from a ``ForestServer`` on the 1x2 mesh, which splits the classes
(``served_impute.npz``), while rank 1 follows. Last, the failure is
planted on rank 1, in its replay of a batch and then of an impute: rank 0
writes what each call got to ``ffault_<where>0.json``, rank 1 how its
follow ended to ``ffault_<where>1.json``. The group rendezvous through a
file in WORKDIR.
"""
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REQUESTS = (17, 40, 90)


def main(rank: int, world: int, work: str) -> None:
    from repro_torch.core import interpolants as itp
    from repro_torch.launch.mesh import forest_mesh
    from repro_torch.launch.serve_forest import ForestServer
    from repro_torch.launch.serve_http import ServingApp
    from repro_torch.serving import ModelRegistry
    from repro_torch.serving.spmd import follow
    from repro_torch.tabgen import (ForestArtifacts, get_sampler, impute,
                                    sample)
    from repro_torch.tabgen.sampling import solve_sharded

    dist.init_process_group("gloo", init_method=f"file://{work}/pg",
                            rank=rank, world_size=world)
    try:
        with open(f"{work}/cases.json") as f:
            cases = json.load(f)
        models = {name: ForestArtifacts.load(f"{work}/{name}", device="cpu")
                  for name in cases["models"]}
        meshes = {tuple(s): forest_mesh(*s, "cpu") for s in cases["meshes"]}
        for c in cases["sample"]:
            mesh, art = meshes[tuple(c["mesh"])], models[c["model"]]
            kw = dict(sampler=c["sampler"], seed=c["seed"], mesh=mesh)
            X, y = sample(art, c["n"], **kw)
            Xs, ys = sample(art.shard(mesh), c["n"], **kw)
            np.savez(f"{work}/rank{rank}_{c['name']}.npz", X=X, y=y, Xs=Xs,
                     ys=ys)
        for c in cases["solve"]:
            mesh, art = meshes[tuple(c["mesh"])], models[c["model"]]
            with np.load(f"{work}/jax_inputs_{c['model']}.npz") as d:
                x1, noise = torch.from_numpy(d["x1"]), d["noise"]
            cfg = art.config
            spec = get_sampler(c["sampler"])
            out = solve_sharded(
                art, mesh, itp.timesteps(cfg.method, cfg.n_t, cfg.eps_diff,
                                         cfg.t_schedule),
                m=x1.shape[1], solver_fn=spec.fn,
                x1=lambda cls, rows: x1[cls[0]:cls[1], rows[0]:rows[1]],
                noise=torch.from_numpy(noise) if spec.stochastic else None)
            if rank == 0:
                np.savez(f"{work}/solve_{c['name']}.npz", x=out.numpy())

        mesh = meshes[(2, 1)]
        if rank == 0:
            done = serve(ForestServer, models, mesh, work)
        else:
            done = {"replayed": follow(ModelRegistry(device="cpu",
                                                     mesh=mesh))}
        with open(f"{work}/done{rank}.json", "w") as f:
            json.dump(done, f)

        if rank == 0:
            fault = serve_with_a_fault(ForestServer, models, mesh)
        else:
            t0 = time.time()
            try:
                fault = {"returned": follow(ModelRegistry(device="cpu",
                                                          mesh=mesh))}
            except Exception as exc:  # noqa: BLE001 — what the test reads
                fault = {"raised": f"{type(exc).__name__}: {exc}"[:400],
                         "after_s": time.time() - t0}
        with open(f"{work}/fault{rank}.json", "w") as f:
            json.dump(fault, f)

        for c in cases["impute"]:
            mesh, art = meshes[tuple(c["mesh"])], models[c["model"]]
            with np.load(f"{work}/impute_{c['model']}.npz") as d:
                inputs = dict(d)
            X, y = inputs["X"], inputs["y"]
            kw = dict(seed=c["seed"], refine_rounds=c["rounds"], mesh=mesh)
            np.savez(
                f"{work}/rank{rank}_impute_{c['name']}.npz",
                X=impute(art, X, y, **kw),
                Xs=impute(art.shard(mesh), X, y, **kw),
                Xj=impute(art, X, y, noise=lambda yi, shape: torch.from_numpy(
                    inputs[f"noise{yi}"]), **kw))

        mesh = meshes[(1, 2)]
        if rank == 0:
            served = serve_imputes(ForestServer, ServingApp, models, mesh,
                                   work)
        else:
            served = {"replayed": follow(ModelRegistry(device="cpu",
                                                       mesh=mesh))}
        with open(f"{work}/done_impute{rank}.json", "w") as f:
            json.dump(served, f)

        for where in ("batch", "impute"):
            if rank == 0:
                fault = serve_beside_a_follower_fault(ForestServer, models,
                                                      meshes[(1, 2)], work)
            else:
                fault = follow_with_a_fault(ModelRegistry, follow,
                                            meshes[(1, 2)], where)
            with open(f"{work}/ffault_{where}{rank}.json", "w") as f:
                json.dump(fault, f)
    finally:
        dist.destroy_process_group()


def serve(ForestServer, models, mesh, work: str) -> dict:
    """Rank 0: requests of 17, 40 and 90 rows, a swap before the last."""
    server = ForestServer(models["flow2"], device="cpu", mesh=mesh,
                          buckets=(16, 64))
    try:
        warm = server.warmup()
        served = {}
        for i, n in enumerate(REQUESTS):
            if i == 2:
                server.registry.swap(server.MODEL, models["flow2b"])
            X, y = server.submit(n).result(timeout=60)
            served[f"X{n}"], served[f"y{n}"] = X, y
        spans = server.tracer.spans(name="serve.device")
        np.savez(f"{work}/served.npz",
                 batch_ids=[s.attrs["batch_id"] for s in spans],
                 rows=[s.attrs["rows"] for s in spans], **served)
        version = server.registry.peek(server.MODEL).version
        describe = server.registry.describe()[server.MODEL]
    finally:
        server.close()
    return {"warm_s": warm, "version": version,
            "nbytes": describe["nbytes"],
            "rank_nbytes": describe["rank_nbytes"]}


def serve_with_a_fault(ForestServer, models, mesh) -> dict:
    """Rank 0: a request of 17 rows, then a failure planted in the enqueue
    of the next batch, after its publication; then one more request. The
    rank then leaves (its connections close)."""
    from repro_torch.serving.registry import ModelHandle
    server = ForestServer(models["flow2"], device="cpu", mesh=mesh,
                          buckets=(16, 64))
    enqueue = ModelHandle.enqueue

    def planted(self, *args, **kwargs):
        ModelHandle.enqueue = enqueue
        raise MemoryError("planted after the publication")

    got, calls = [], []
    server.registry.stream.on_break = lambda: calls.append("on_break")
    try:
        for i, n in enumerate((17, 40, 90)):
            if i == 1:
                ModelHandle.enqueue = planted
            try:
                X, _ = server.submit(n).result(timeout=60)
                got.append(len(X))
            except Exception as exc:  # noqa: BLE001 — what the test reads
                got.append(f"{type(exc).__name__}: {exc}")
        broken = repr(server.registry.stream.broken)
    finally:
        ModelHandle.enqueue = enqueue
        server.close()
    return {"got": got, "broken": broken, "calls": calls}


def serve_imputes(ForestServer, ServingApp, models, mesh, work: str
                  ) -> dict:
    """Rank 0 on a mesh that splits the classes: bad imputes first (through
    the HTTP plane: a label that is not a class, rows one column short, no
    labels for the conditional model; through the server: no labels), then
    two imputes (seeds 2 and 3) and a request of 40 rows."""
    server = ForestServer(models["flow2"], device="cpu", mesh=mesh,
                          buckets=(16, 64))
    try:
        with np.load(f"{work}/impute_flow2.npz") as d:
            X, y = d["X"], d["y"]
        app = ServingApp(server.registry)
        rows, labels = X.tolist(), y.tolist()
        bad = [{"rows": rows, "labels": [7] * len(rows)},
               {"rows": [r[:-1] for r in rows], "labels": labels},
               {"rows": rows}]
        refused = [list(app.impute({"model": server.MODEL, **body}))
                   for body in bad]
        try:
            server.impute(X, None, seed=2)
            refused.append("returned")
        except ValueError as exc:
            refused.append(f"ValueError: {exc}")
        got = {f"I{seed}": server.impute(X, y, seed=seed) for seed in (2, 3)}
        got["X40"], got["y40"] = server.submit(40).result(timeout=60)
        spans = server.tracer.spans(name="serve.device")
        np.savez(f"{work}/served_impute.npz",
                 batch_ids=[sp.attrs["batch_id"] for sp in spans], **got)
        broken = repr(server.registry.stream.broken)
    finally:
        server.close()
    return {"ok": True, "refused": refused, "broken": broken}


def serve_beside_a_follower_fault(ForestServer, models, mesh, work: str
                                  ) -> dict:
    """Rank 0: a request, an impute, a request and an impute, each timed,
    while rank 1's replay of the second command fails."""
    server = ForestServer(models["flow2"], device="cpu", mesh=mesh,
                          buckets=(16, 64))
    with np.load(f"{work}/impute_flow2.npz") as d:
        X, y = d["X"], d["y"]
    calls = [lambda: len(server.submit(17).result(timeout=60)[0]),
             lambda: server.impute(X, y, seed=2).shape[0],
             lambda: len(server.submit(40).result(timeout=60)[0]),
             lambda: server.impute(X, y, seed=3).shape[0]]
    got, seconds = [], []
    try:
        for call in calls:
            t0 = time.time()
            try:
                got.append(call())
            except Exception as exc:  # noqa: BLE001 — what the test reads
                got.append(f"{type(exc).__name__}: {exc}"[:300])
            seconds.append(time.time() - t0)
        broken = repr(server.registry.stream.broken)
    finally:
        server.close()
    return {"got": got, "seconds": seconds, "broken": broken}


def follow_with_a_fault(ModelRegistry, follow, mesh, where: str) -> dict:
    """Rank 1: follow, with a failure planted in the replay of the first
    batch (``where="batch"``, the second command) or of the first impute
    (the first command with ``where="impute"``; the batch before it is
    replayed)."""
    from repro_torch.serving.registry import ModelHandle
    name = "enqueue" if where == "batch" else "impute_part"
    original = getattr(ModelHandle, name)
    seen = []

    def planted(self, *args, **kwargs):
        seen.append(name)
        if where == "batch" and len(seen) == 1:
            return original(self, *args, **kwargs)
        setattr(ModelHandle, name, original)
        raise MemoryError(f"planted in the follower's {where}")

    setattr(ModelHandle, name, planted)
    t0 = time.time()
    try:
        return {"returned": follow(ModelRegistry(device="cpu", mesh=mesh))}
    except Exception as exc:  # noqa: BLE001 — what the test reads
        return {"raised": f"{type(exc).__name__}: {exc}"[:400],
                "after_s": time.time() - t0}
    finally:
        setattr(ModelHandle, name, original)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
