"""The port's sharded LM against the JAX package: an elastic restore.

The reduced smollm-135m's weights (the JAX package's ``init_params``) are
saved once from the unsharded port model, then four gloo ranks
(``tests/_torch_elastic_worker.py``, one spawn) restore them onto a 2x2,
a 1x4 and a 4x1 ``("data", "model")`` mesh by the sharding rules
(``checkpoint.reshard``: every rank keeps its own shard, no scatter) and
run the DTensor model. Held to the JAX package on the host: the training
loss within 1e-5 relative (the reference's own elastic test allows 1e-3),
the prefill logits within 1e-4 of the largest, the greedy tokens equal;
the gradients within 1e-5 of each leaf's largest of the unsharded port
model's. The same spawn restores reduced dbrx-132b (routed experts split
over the model ranks) and deepseek-v2-236b (MLA, its latent decode cache
with its positions on the model ranks) onto the 2x2 mesh and holds them to
the unsharded port model on the same numbers (itself held to the JAX
package by ``tests/test_torch_moe.py``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import lm as jax_lm
from repro_torch.configs import get_arch
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import checkpoint as ckpt

MESHES = [(2, 2), (1, 4), (4, 1)]
FAMILIES = ["dbrx-132b", "deepseek-v2-236b"]
WORKER = Path(__file__).with_name("_torch_elastic_worker.py")
SRC = Path(__file__).resolve().parents[1] / "src"
B, S, N_PROMPT, S_PROMPT, N_NEW = 8, 64, 4, 16, 6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("elastic")
    jcfg = jax_get_arch("smollm-135m", True)
    cfg = get_arch("smollm-135m", True)
    init = jax.jit(jax_lm.init_params, static_argnums=1)
    jparams = init(jax.random.PRNGKey(1), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                            device="cpu")
    batch, prompts = _save(work, "smollm-135m", model)
    fam_models = {a: lm.init_params(get_arch(a, True), device="cpu", seed=2)
                  for a in FAMILIES}
    fam_inputs = {a: _save(work, a, m) for a, m in fam_models.items()}
    (work / "cases.json").write_text(json.dumps(
        [{"arch": "smollm-135m", "meshes": MESHES}]
        + [{"arch": a, "meshes": [(2, 2)]} for a in FAMILIES]))

    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), "4",
                               str(work)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        logs.append(out.decode(errors="replace")[-3000:])
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    jloss, _ = jax_lm.loss_fn(jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                              jcfg, dtype=jnp.float32, remat_policy="full")
    jlogits, _ = jax_lm.prefill_step(jparams, {"tokens": jnp.asarray(prompts)},
                                     jcfg, dtype=jnp.float32)
    jtoks, _ = jax_serve_batch(jcfg, jparams, jnp.asarray(prompts), N_NEW,
                               S_PROMPT + N_NEW, dtype=jnp.float32)
    outs = {}
    for a, b in MESHES:
        with np.load(work / f"out_smollm-135m_{a}x{b}.npz") as d:
            outs[(a, b)] = {k: d[k] for k in d.files}
    fams = {}
    for arch, m in fam_models.items():
        with np.load(work / f"out_{arch}_2x2.npz") as d:
            got = {k: d[k] for k in d.files}
        fams[arch] = (got, _unsharded(m, get_arch(arch, True),
                                      *fam_inputs[arch]))
    return {"jax_loss": float(jloss), "jax_logits": np.asarray(jlogits),
            "jax_tokens": np.asarray(jtoks),
            "grads": _unsharded(model, cfg, batch, prompts)["grads"],
            "n_params": sum(p.numel() for p in model.parameters()),
            "outs": outs, "families": fams}


def _save(work, arch, model):
    """The model's checkpoint and a batch and prompts for its case."""
    ckpt.save(str(work / f"ckpt_{arch}"), 0, params_to_jax(model))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    prompts = rng.integers(0, model.cfg.vocab, (N_PROMPT, S_PROMPT)).astype(
        np.int32)
    np.savez(work / f"batch_{arch}.npz", prompts=prompts, n_new=N_NEW,
             **batch)
    return batch, prompts


def _unsharded(model, cfg, batch, prompts):
    """The unsharded port model's loss, gradients, prefill logits and
    greedy tokens on the case's inputs."""
    from repro_torch.launch.serve import serve_batch
    loss, _ = lm.loss_fn(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                         cfg, dtype=torch.float32, remat_policy="full")
    grads = torch.autograd.grad(loss, list(model.parameters()))
    logits, _ = lm.prefill_step(model, {"tokens": torch.from_numpy(prompts)},
                                cfg, dtype=torch.float32)
    toks, _ = serve_batch(cfg, model, prompts, N_NEW, S_PROMPT + N_NEW)
    return {"loss": loss.item(), "logits": logits.numpy(), "tokens": toks,
            "grads": {n: g.numpy() for (n, _), g in
                      zip(model.named_parameters(), grads)}}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_resharded_loss_matches_the_jax_host_loss(run, mesh):
    got = float(run["outs"][mesh]["loss"])
    assert got == pytest.approx(run["jax_loss"], rel=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_resharded_gradients_match_the_unsharded_model(run, mesh):
    out = run["outs"][mesh]
    for name, want in run["grads"].items():
        got = out[f"grad/{name}"]
        tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= tol, name


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_resharded_prefill_and_greedy_tokens_match_jax(run, mesh):
    out = run["outs"][mesh]
    want = run["jax_logits"]
    assert np.abs(out["logits"] - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(out["tokens"], run["jax_tokens"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_resharded_moe_and_mla_match_the_unsharded_model(run, arch):
    got, want = run["families"][arch]
    assert float(got["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    for name, g in want["grads"].items():
        tol = 1e-5 * max(float(np.abs(g).max()), 1e-30)
        assert np.abs(got[f"grad/{name}"] - g).max() <= tol, name
    ref = want["logits"]
    assert np.abs(got["logits"] - ref).max() <= 1e-4 * np.abs(ref).max()
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_each_rank_holds_a_shard_of_the_weights(run):
    # on the 2x2 mesh the FSDP dim splits every large weight over 2 ranks
    held = int(run["outs"][(2, 2)]["shards"][0])
    assert held < run["n_params"]
