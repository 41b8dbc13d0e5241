"""One rank of the port's sharded LM on a gloo group, for
``tests/test_torch_elastic.py``.

    PYTHONPATH=src python tests/_torch_elastic_worker.py RANK WORLD WORKDIR

For each case of ``cases.json`` (``{"arch", "meshes"}``) restores the
checkpoint in WORKDIR/ckpt_<arch> (the unsharded reduced model's weights,
saved by the test) onto each mesh by the sharding rules
(``checkpoint.reshard``, every rank keeping its own shard), then computes
on the DTensor model the training loss and its gradients of
``batch_<arch>.npz``, a prefill of its prompts and greedy decode tokens.
Rank 0 writes ``out_<arch>_<a>x<b>.npz``. The group rendezvous through a
file in WORKDIR.
"""
import json
import sys

import numpy as np
import torch
import torch.distributed as dist


def main(rank: int, world: int, work: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{work}/pg",
                            rank=rank, world_size=world)
    try:
        with open(f"{work}/cases.json") as f:
            cases = json.load(f)
        for case in cases:
            run_case(rank, work, case["arch"], case["meshes"])
    finally:
        dist.destroy_process_group()


def run_case(rank: int, work: str, arch: str, meshes) -> None:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models.convert import jax_leaves, params_to_jax
    from repro_torch.sharding import rules
    from repro_torch.sharding.dtensor import Layout, load_sharded
    from repro_torch.train import checkpoint as ckpt

    cfg = get_arch(arch, reduced=True)
    with np.load(f"{work}/batch_{arch}.npz") as d:
        batch = {k: torch.from_numpy(d[k]) for k in ("tokens", "labels")}
        prompts = torch.from_numpy(d["prompts"])
        n_new = int(d["n_new"])
    for a, b in meshes:
        mesh = make_debug_mesh(a, b, device="cpu")
        dp, tp = rules.axes_for_mesh(False)
        model = lm.init_params(cfg, device="cpu", seed=99)
        tree, _ = ckpt.restore(f"{work}/ckpt_{arch}",
                               params_to_jax(model))
        names = [n for n, _ in model.named_parameters()]
        host = dict(zip(names, jax_leaves(model, tree)))
        specs = rules.param_specs(model, cfg, dp, tp, a, b)
        layout = Layout(mesh, dp)
        load_sharded(model, ckpt.reshard(host, mesh, specs), layout)
        out = {}
        loss, _ = lm.loss_fn(model, batch, cfg, dtype=torch.float32,
                             remat_policy="full")
        params = list(model.parameters())
        with implicit_replication():
            grads = torch.autograd.grad(loss, params)
        out["loss"] = loss.detach().full_tensor().numpy()
        for n, g in zip(names, grads):
            out[f"grad/{n}"] = g.full_tensor().numpy()
        out["shards"] = np.array([sum(
            p.to_local().numel() for p in params)])
        logits, pc = lm.prefill_step(model, {"tokens": prompts}, cfg,
                                     dtype=torch.float32)
        out["logits"] = logits.full_tensor().numpy()
        bsz, s = prompts.shape
        full = lm.init_cache(cfg, bsz, s + n_new, torch.float32,
                             device="cpu")
        cache = layout.shard_tree(full, rules.cache_specs(
            full, dp, tp, a, b))
        with torch.no_grad():
            for dseg, sseg in zip(cache, pc):
                for key, layer in dseg.items():
                    for name, dst in layer.items():
                        src = sseg[key][name]
                        # the prefill's positions into the leading slice
                        # (each rank its part of a position-sharded cache)
                        dims = [i for i, (m, n) in enumerate(
                            zip(dst.shape, src.shape)) if m != n]
                        if dims:
                            layout.cache_write(dst, dims[0], 0, src)
                        else:
                            dst.copy_(src)
        tok = logits.full_tensor()[:, -1].argmax(-1)[:, None].int()
        toks = [tok]
        for i in range(n_new - 1):
            logits, cache = lm.decode_step(model, cache, tok, s + i, cfg,
                                           dtype=torch.float32)
            tok = logits.full_tensor()[:, -1].argmax(-1)[:, None].int()
            toks.append(tok)
        out["tokens"] = torch.cat(toks, dim=1).numpy()
        if rank == 0:
            np.savez(f"{work}/out_{arch}_{a}x{b}.npz", **out)
        dist.barrier()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
