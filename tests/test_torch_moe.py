"""The port's MoE families (dbrx's routed experts, deepseek-v2's MLA with
shared and routed experts) against the JAX package, on the CPU.

Configs are the ``reduced()`` ones (the port's equal the JAX package's),
the JAX package's weights are carried across with ``params_from_jax`` and
everything runs in fp32. Layer functions are held to 1e-5, logits to 1e-4
(``assert_allclose``'s rtol = atol), the loss to 1e-5 relative and each
gradient leaf to 1e-4 of its largest entry: both packages compute the same
function with the arithmetic in another order (the port dispatches tokens
by index where the JAX package contracts one-hot tensors, and its prefill
attention is the plain version of the flash-attention kernel).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ArchConfig as JArchConfig
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import attention as jax_attn
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import serve
from repro_torch.launch.serve import merge_caches, serve_batch
from repro_torch.models import attention, blocks, lm, moe
from repro_torch.models.convert import params_from_jax, params_to_jax

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ARCHS = ("dbrx-132b", "deepseek-v2-236b")


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def configs(arch):
    """(JAX config, port config): the port's reduced config, and the JAX
    package's ArchConfig with the same fields."""
    cfg = get_arch(arch, reduced=True)
    return JArchConfig(**dataclasses.asdict(cfg)), cfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(JAX config, JAX params, port config, port model) of one family."""
    jcfg, cfg = configs(request.param)
    jparams = jax_lm.init_params(jax.random.PRNGKey(1), jcfg)
    return jcfg, jparams, cfg, params_from_jax(numpy_tree(jparams), cfg,
                                               device="cpu")


def tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

D, F_EXP, E, K = 64, 96, 4, 2


def moe_pair(seed=2):
    tree = numpy_tree(jax_moe.init_moe(jax.random.PRNGKey(seed), D, F_EXP, E,
                                       "swiglu"))
    return tree, moe.MoE(t(tree["router"]), {n: t(tree[n])
                                             for n in ("wi", "wg", "wo")})


def moe_input(b, s, seed):
    """Tokens with a shared component, so the router favours some experts
    and a capacity factor of 1.25 drops slots."""
    rng = np.random.default_rng(seed)
    common = rng.normal(size=D)
    return (rng.normal(size=(b, s, D)) + 1.5 * common).astype(np.float32)


# (regime, x shape, group_size, capacity factor): 600 tokens leave a tail
# of 88 past the last group of 256 or 512
REGIMES = [("train", (2, 300), 256, 1.25),
           ("prefill", (2, 300), 512, E / K),
           ("decode", (3, 1), 3, E / K)]


@pytest.mark.parametrize("regime,shape,group,cf", REGIMES)
def test_apply_moe_matches_jax(regime, shape, group, cf):
    tree, p = moe_pair()
    x = moe_input(*shape, seed=len(regime))
    kw = dict(n_experts=E, top_k=K, act="swiglu", group_size=group,
              capacity_factor=cf)
    want_y, want_aux = jax_moe.apply_moe(tree, jnp.asarray(x), **kw)
    with torch.no_grad():
        y, aux = moe.apply_moe(p, t(x), **kw)
        no_drop, _ = moe.apply_moe(p, t(x), **dict(kw, capacity_factor=E / K))
    close(y, want_y, LAYER_TOL)
    close(aux, want_aux, LAYER_TOL)
    n = x.shape[0] * x.shape[1]
    tail = n - n // min(group, n) * min(group, n)
    flat_x, flat_y = x.reshape(n, D), y.reshape(n, D).numpy()
    # tokens past the last group pass through as they came
    np.testing.assert_array_equal(flat_y[n - tail:], flat_x[n - tail:])
    dropped = not torch.equal(y, no_drop)
    assert dropped == (regime == "train")
    if regime != "decode":
        assert tail == 88


def test_quantized_experts_match_jax():
    tree, p = moe_pair(seed=3)
    jq = numpy_tree(jax_moe.quantize_expert_weights(tree))
    q = moe.quantize_expert_weights(p)
    for name in ("wi", "wg", "wo"):
        got = getattr(q, name)
        assert got.dtype == torch.int8 and not got.requires_grad
        np.testing.assert_array_equal(got.numpy(), jq[name])
        np.testing.assert_array_equal(getattr(q, name + "_scale").numpy(),
                                      jq[name + "_scale"])
    x = moe_input(2, 40, seed=4)
    kw = dict(n_experts=E, top_k=K, act="swiglu", capacity_factor=E / K)
    want, _ = jax_moe.apply_moe(jq, jnp.asarray(x), **kw)
    with torch.no_grad():
        got, _ = moe.apply_moe(q, t(x), **kw)
    close(got, want, LAYER_TOL)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def mla_pair(seed=5, **fields):
    _, cfg = configs("deepseek-v2-236b")
    cfg = dataclasses.replace(cfg, **fields)
    jcfg = JArchConfig(**dataclasses.asdict(cfg))
    tree = numpy_tree(jax_attn.init_mla(jax.random.PRNGKey(seed), jcfg))
    p = attention.init_mla(torch.Generator(), cfg)
    with torch.no_grad():
        for name, val in tree.items():
            if isinstance(val, dict):
                getattr(p, name).scale.copy_(t(val["scale"]))
            else:
                getattr(p, name).copy_(t(val))
    return jcfg, tree, cfg, p


@pytest.mark.parametrize("mode", ["prefill", "expanded", "absorbed"])
def test_apply_mla_matches_jax(mode):
    jcfg, tree, cfg, p = mla_pair()
    rng = np.random.default_rng(6)
    if mode == "prefill":
        s = 40
        x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
        want_y, (want_c, want_kr) = jax_attn.apply_mla(
            tree, jnp.asarray(x), jnp.asarray(pos), jcfg)
        with torch.no_grad():
            y, (c, kr) = attention.apply_mla(p, t(x), t(pos), cfg)
        close(y, want_y, LAYER_TOL)
        close(c, want_c, LAYER_TOL)
        close(kr, want_kr, LAYER_TOL)
        return
    size, idx = 24, 13
    c0 = rng.normal(size=(2, size, cfg.kv_lora_rank)).astype(np.float32)
    kr0 = rng.normal(size=(2, size, cfg.rope_head_dim)).astype(np.float32)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((2, 1), idx, np.int32)
    absorb = mode == "absorbed"
    want_y, want_cache = jax_attn.apply_mla(
        tree, jnp.asarray(x), jnp.asarray(pos), jcfg,
        cache={"c": jnp.asarray(c0), "k_rope": jnp.asarray(kr0)},
        cache_index=jnp.int32(idx), absorb=absorb)
    cache = {"c": t(c0), "k_rope": t(kr0)}
    with torch.no_grad():
        y, new_cache = attention.apply_mla(p, t(x), t(pos), cfg, cache=cache,
                                           cache_index=idx, absorb=absorb)
    assert new_cache["c"] is cache["c"]          # written in place
    close(y, want_y, LAYER_TOL)
    for name in ("c", "k_rope"):
        close(new_cache[name], want_cache[name], LAYER_TOL)


@pytest.mark.parametrize("nope, rope, width", [(16, 8, 32), (16, 16, 32),
                                               (128, 64, 192)])
def test_mla_prefill_attends_at_a_width_the_kernel_takes(nope, rope, width):
    """nope + rope = 24 is padded to 32 (q scaled to keep the softmax scale
    1/sqrt(24)); 32 and 192 are kernel widths and go as they are. The
    output equals the JAX package's unpadded attention."""
    jcfg, tree, cfg, p = mla_pair(nope_head_dim=nope, rope_head_dim=rope)
    widths = []

    def attend(q, k, v, causal):
        widths.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return attention_ref(q, k, v, causal)

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 30, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(30, dtype=np.int32), (2, 30)).copy()
    want_y, _ = jax_attn.apply_mla(tree, jnp.asarray(x), jnp.asarray(pos),
                                   jcfg)
    with torch.no_grad():
        y, _ = attention.apply_mla(p, t(x), t(pos), cfg, attend=attend)
    assert widths == [(width,) * 3] and width in HEAD_DIMS
    close(y, want_y, LAYER_TOL)


# ---------------------------------------------------------------------------
# prefill / decode / serve
# ---------------------------------------------------------------------------

def test_prefill_step_matches_jax(model):
    """B·S = 600 tokens: one group of 512 and a tail of 88 in the MoE."""
    jcfg, jparams, cfg, params = model
    toks = tokens(cfg.vocab, 2, 300, seed=1)
    want, want_c = jax_lm.prefill_step(jparams, {"tokens": jnp.asarray(toks)},
                                       jcfg, dtype=jnp.float32)
    got, caches = lm.prefill_step(params, {"tokens": t(toks)}, cfg,
                                  dtype=torch.float32)
    assert got.shape == (2, 1, cfg.vocab)
    close(got, want, LOGIT_TOL)
    assert len(caches) == len(blocks.segments_for(cfg))
    for seg, jseg in zip(caches, want_c):
        assert sorted(seg) == sorted(jseg)
        for key in seg:
            assert sorted(seg[key]) == sorted(jseg[key])
            for name, leaf in seg[key].items():
                close(leaf, jseg[key][name], LOGIT_TOL)


def test_decode_steps_match_jax(model):
    jcfg, jparams, cfg, params = model
    b, s, size = 2, 12, 16
    toks = tokens(cfg.vocab, b, s + 4, seed=3)
    _, jc = jax_lm.prefill_step(jparams, {"tokens": jnp.asarray(toks[:, :s])},
                                jcfg, dtype=jnp.float32)
    jcache = jax.tree_util.tree_map(
        lambda full, pre: full.at[..., :s, :].set(pre),
        jax_lm.init_cache(jcfg, b, size, jnp.float32), jc)
    _, pc = lm.prefill_step(params, {"tokens": t(toks[:, :s])}, cfg,
                            dtype=torch.float32)
    cache = merge_caches(lm.init_cache(cfg, b, size, torch.float32, "cpu"), pc)
    for i in range(4):
        tok = toks[:, s + i:s + i + 1]
        jlogits, jcache = jax_lm.decode_step(jparams, jcache, jnp.asarray(tok),
                                             jnp.int32(s + i), jcfg,
                                             dtype=jnp.float32)
        logits, cache = lm.decode_step(params, cache, t(tok), s + i, cfg,
                                       dtype=torch.float32)
        close(logits, jlogits, LOGIT_TOL)
    for seg, jseg in zip(cache, jcache):
        for key in seg:
            for name, leaf in seg[key].items():
                close(leaf, jseg[key][name], LOGIT_TOL)


def test_merge_caches_fills_the_latent_caches_along_s():
    """MLA's latent cache is [n, B, S, r]: axis -2 is S, as for k/v."""
    _, cfg = configs("deepseek-v2-236b")
    full = lm.init_cache(cfg, 2, 10, torch.float32, "cpu")
    pre = [{key: {name: torch.randn(leaf.shape[:-2] + (6,) + leaf.shape[-1:])
                  for name, leaf in layer.items()}
            for key, layer in seg.items()} for seg in full]
    merge_caches(full, pre)
    for seg, pseg in zip(full, pre):
        for key, layer in seg.items():
            for name, leaf in layer.items():
                assert torch.equal(leaf[..., :6, :], pseg[key][name])
                assert not leaf[..., 6:, :].any()


def test_serve_batch_greedy_tokens_equal_jax(model):
    jcfg, jparams, cfg, params = model
    b, s, max_new = 3, 10, 6
    prompts = tokens(cfg.vocab, b, s, seed=7)
    want, _ = jax_serve_batch(jcfg, jparams, jnp.asarray(prompts), max_new,
                              cache_size=s + max_new)
    got, stats = serve_batch(cfg, params, t(prompts), max_new,
                             cache_size=s + max_new)
    assert got.shape == (b, max_new) and stats["tok_per_s"] > 0
    np.testing.assert_array_equal(got, np.asarray(want))


def test_prefill_then_decode_matches_stepwise_decode(model):
    """Prefill(t0..t7) then decode(t8) == decode steps 0..8 token by token,
    as tests/test_arch_smoke.py holds the JAX package."""
    _, _, cfg, params = model
    b, s = 1, 8
    toks = t(tokens(cfg.vocab, b, s + 1, seed=0))
    cache = lm.init_cache(cfg, b, s + 1, torch.float32, "cpu")
    for i in range(s + 1):
        logits_a, cache = lm.decode_step(params, cache, toks[:, i:i + 1], i,
                                         cfg, dtype=torch.float32)
    _, pc = lm.prefill_step(params, {"tokens": toks[:, :s]}, cfg,
                            dtype=torch.float32)
    full = merge_caches(lm.init_cache(cfg, b, s + 1, torch.float32, "cpu"), pc)
    logits_b, _ = lm.decode_step(params, full, toks[:, s:s + 1], s, cfg,
                                 dtype=torch.float32)
    close(logits_a, logits_b, 2e-3)


def test_absorbed_decode_gives_the_expanded_decodes_tokens():
    jcfg, cfg = configs("deepseek-v2-236b")
    jparams = jax_lm.init_params(jax.random.PRNGKey(4), jcfg)
    params = params_from_jax(numpy_tree(jparams), cfg, device="cpu")
    prompts = t(tokens(cfg.vocab, 2, 10, seed=9))
    expanded, _ = serve_batch(cfg, params, prompts, 6, cache_size=16)
    absorbed_cfg = get_arch("deepseek-v2-236b", reduced=True)
    object.__setattr__(absorbed_cfg, "mla_absorb", True)
    absorbed, _ = serve_batch(absorbed_cfg, params, prompts, 6, cache_size=16)
    np.testing.assert_array_equal(absorbed, expanded)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_moe_arch_on_the_cpu(arch):
    cfg = get_arch(arch, reduced=True)
    gen = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "5", "--max-new",
                      "3"])
    assert gen.shape == (2, 3) and ((gen >= 0) & (gen < cfg.vocab)).all()


# ---------------------------------------------------------------------------
# the objective and its gradients; the weights' round trip
# ---------------------------------------------------------------------------

def test_loss_fn_and_gradients_match_jax(model):
    """B·S = 600 tokens at the training capacity (1.25): slots drop and a
    tail of 88 tokens passes through the last MoE group."""
    jcfg, jparams, cfg, params = model
    toks = tokens(cfg.vocab, 2, 301, seed=5)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    b["labels"][0, :5] = -1                             # masked out

    def jax_loss(p):
        return jax_lm.loss_fn(p, {k: jnp.asarray(v) for k, v in b.items()},
                              jcfg, dtype=jnp.float32, remat_policy="none")

    value_and_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    (want, wm), wgrads = value_and_grad(jparams)
    loss, m = lm.loss_fn(params, {k: t(v) for k, v in b.items()}, cfg,
                         dtype=torch.float32, remat_policy="none")
    grads = torch.autograd.grad(loss, list(params.parameters()))
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["xent"].item(), float(wm["xent"]),
                               rtol=LOSS_RTOL)
    close(m["aux"].item(), float(wm["aux"]), LAYER_TOL)
    assert float(wm["aux"]) > 0
    got = params_to_jax(params, grads)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(numpy_tree(wgrads))):
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= GRAD_TOL * scale
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(numpy_tree(wgrads)))


@pytest.mark.parametrize("quantized", [False, True])
def test_params_round_trip_through_the_jax_layout(model, quantized):
    jcfg, jparams, cfg, _ = model
    tree = numpy_tree(jparams)
    if quantized:
        for seg in tree["segments"]:
            for layer in seg.values():
                if "moe" in layer:
                    layer["moe"] = numpy_tree(
                        jax_moe.quantize_expert_weights(layer["moe"]))
    params = params_from_jax(tree, cfg, device="cpu")
    back = params_to_jax(params)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if quantized:
        toks = tokens(cfg.vocab, 2, 20, seed=6)
        want, _ = jax_lm.prefill_step(tree, {"tokens": jnp.asarray(toks)},
                                      jcfg, dtype=jnp.float32)
        got, _ = lm.prefill_step(params, {"tokens": t(toks)}, cfg,
                                 dtype=torch.float32)
        close(got, want, LOGIT_TOL)


def test_params_from_jax_names_the_moe_and_mla_leaves(model):
    _, jparams, cfg, _ = model
    key = "0_moe" if cfg.family == "moe" else "0_mla_moe"
    seg = len(blocks.segments_for(cfg)) - 1
    tree = numpy_tree(jparams)
    del tree["segments"][seg][key]["moe"]["router"]
    with pytest.raises(KeyError, match=f"{key}.moe.router"):
        params_from_jax(tree, cfg, device="cpu")
    tree = numpy_tree(jparams)
    tree["segments"][seg][key]["moe"]["bias"] = np.ones((1,), np.float32)
    with pytest.raises(KeyError, match=f"{key}.moe.bias"):
        params_from_jax(tree, cfg, device="cpu")
    if cfg.family == "mla_moe":
        tree = numpy_tree(jparams)
        del tree["segments"][0]["0_mla_dense"]["attn"]["wk_b"]
        with pytest.raises(KeyError, match="0_mla_dense.attn.wk_b"):
            params_from_jax(tree, cfg, device="cpu")
