"""One rank of the port's sharded trainer on a gloo group, for
``tests/test_torch_distributed.py``.

    PYTHONPATH=src python tests/_torch_dist_worker.py RANK WORLD WORKDIR

Reads the rows (``data.npz``) and the cases (``cases.json``: a mesh, a
config, a seed) from WORKDIR, fits each case with the noise of
``noise_<case>.npz`` (``x1_<eid>_<split>_<shard>``, ``jit_…``), and rank 0
writes each result to ``port_<case>.npz``. The group rendezvous through a
file in WORKDIR, so concurrent test workers never share a port.
"""
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

FIELDS = ("feat", "thr_val", "leaf", "best_round", "rounds_run", "val_curve",
          "mins", "maxs")


def main(rank: int, world: int, work: str) -> None:
    from repro_torch.config import ForestConfig
    from repro_torch.launch.mesh import forest_mesh
    from repro_torch.tabgen import fit_artifacts

    dist.init_process_group("gloo", init_method=f"file://{work}/pg",
                            rank=rank, world_size=world)
    try:
        with open(f"{work}/cases.json") as f:
            cases = json.load(f)
        with np.load(f"{work}/data.npz") as d:
            X, y = d["X"], d["y"]
        for case in cases:
            with np.load(f"{work}/noise_{case['name']}.npz") as d:
                draws = {k: d[k] for k in d.files}

            def noise(eid, split, shape, shard, draws=draws):
                key = f"{eid}_{split}_{shard}"
                x1 = draws[f"x1_{key}"]
                if x1.shape != shape:
                    raise ValueError(f"noise {key}: {x1.shape} != {shape}")
                return (torch.from_numpy(x1),
                        torch.from_numpy(draws[f"jit_{key}"]))

            mesh = forest_mesh(*case["mesh"], "cpu")
            art = fit_artifacts(X, y, ForestConfig(**case["config"]),
                                seed=case["seed"], mesh=mesh, device="cpu",
                                noise=noise)
            if rank == 0:
                np.savez(f"{work}/port_{case['name']}.npz",
                         **{f: getattr(art, f).numpy() for f in FIELDS})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
