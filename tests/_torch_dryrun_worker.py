"""Run dry-run cells of the port on a fake process group, for
``tests/test_torch_dryrun.py`` (the group lives and dies in this process).

    PYTHONPATH=src python tests/_torch_dryrun_worker.py OUT.json CELLS.json

CELLS.json is a list of ``{"arch", "kind", "seq", "batch", "mesh"}``
(``arch`` "caloforest" for the forest slice, with ``rows`` and ``p``);
each LM cell runs at ``reduced()``. OUT.json gets one record a cell.
"""
import json
import sys


def main(out_path: str, cells_path: str) -> None:
    from repro_torch.config import ForestConfig, ShapeConfig
    from repro_torch.launch import dryrun

    with open(cells_path) as f:
        cells = json.load(f)
    recs = []
    try:
        for c in cells:
            mesh = tuple(c["mesh"])
            if c["arch"] == "caloforest":
                fcfg = ForestConfig(n_t=4, duplicate_k=2, n_trees=2,
                                    max_depth=3, n_bins=16)
                rec = dryrun.run_forest_cell("photons", False, fcfg=fcfg,
                                             n_rows=c["rows"], p=c["p"],
                                             debug_mesh=mesh)
            else:
                shape = ShapeConfig(f"{c['kind']}_{c['seq']}", c["seq"],
                                    c["batch"], c["kind"])
                rec = dryrun.run_cell(c["arch"], None, False, reduced=True,
                                      shape=shape, debug_mesh=mesh)
            recs.append(rec)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(recs, f, default=str)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
