"""The port's LM serving path (prefill -> decode) against the JAX package,
on the CPU.

The JAX package's weights are carried across with ``params_from_jax`` and
everything runs in fp32. Layer functions are held to 1e-5, logits and
caches to 1e-4 (``assert_allclose``'s rtol = atol): both packages run the
same arithmetic in another order (the port's prefill attention is the
plain version of the flash-attention kernel, the JAX package's is
``mea_attention``), and at full width the logits reach ~30, where fp32's
rounding over a 576-term dot product is ~1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import attention as jax_attn
from repro.models import blocks as jax_blocks
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch.serve import merge_caches, serve_batch
from repro_torch.models import attention, blocks, layers, lm
from repro_torch.models.convert import params_from_jax

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load(module, tree):
    """Copy a JAX layer's parameter dict into the port's module."""
    with torch.no_grad():
        for name, val in tree.items():
            if isinstance(val, dict):
                load(getattr(module, name), val)
            else:
                getattr(module, name).copy_(torch.from_numpy(np.array(val)))
    return module


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def configs(kind):
    """(JAX config, port config) of one test model: ``reduced`` is
    smollm-135m's reduced config, ``full`` its published width with 2 layers
    and a 512-token vocabulary."""
    if kind == "reduced":
        return jax_get_arch("smollm-135m", True), get_arch("smollm-135m", True)
    cut = dict(n_layers=2, vocab=512)
    return (dataclasses.replace(jax_get_arch("smollm-135m"), **cut),
            dataclasses.replace(get_arch("smollm-135m"), **cut))


def models(kind, seed=1):
    jcfg, cfg = configs(kind)
    jparams = jax_lm.init_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_jax(numpy_tree(jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def gen():
    return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 576)).astype(np.float32) * 3 + 1
    tree = {"scale": rng.normal(size=576).astype(np.float32)}
    if kind == "layernorm":
        tree["bias"] = rng.normal(size=576).astype(np.float32)
    want = jax_layers.apply_norm(tree, jnp.asarray(x), kind)
    p = load(layers.init_norm(576, kind), tree)
    with torch.no_grad():
        got = layers.apply_norm(p, torch.from_numpy(x), kind)
    close(got, want, LAYER_TOL)


@pytest.mark.parametrize("d_head", [16, 64, 160])
def test_apply_rope_matches_jax(d_head):
    rng = np.random.default_rng(d_head)
    x = rng.normal(size=(2, 33, 3, d_head)).astype(np.float32)
    pos = np.broadcast_to(np.arange(2000, 2033, dtype=np.int32), (2, 33))
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = layers.apply_rope(torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), 10000.0)
    close(got, want, LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_apply_mlp_matches_jax(act):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 576)).astype(np.float32)
    tree = numpy_tree(jax_layers.init_mlp(jax.random.PRNGKey(2), 576, 1536,
                                          act))
    want = jax_layers.apply_mlp(tree, jnp.asarray(x), act)
    p = load(layers.init_mlp(gen(), 576, 1536, act), tree)
    with torch.no_grad():
        got = layers.apply_mlp(p, torch.from_numpy(x), act)
    close(got, want, LAYER_TOL)


def test_embed_tokens_matches_jax():
    tree = numpy_tree(jax_layers.init_embed(jax.random.PRNGKey(3), 512, 576))
    toks = np.random.default_rng(2).integers(0, 512, (3, 9)).astype(np.int32)
    want = jax_layers.embed_tokens(tree, jnp.asarray(toks), jnp.float32)
    p = load(layers.init_embed(gen(), 512, 576), tree)
    got = layers.embed_tokens(p, torch.from_numpy(toks), torch.float32)
    close(got.detach(), want, 0.0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def gqa_pair(seed=4, d=576, h=9, hkv=3, dh=64):
    tree = numpy_tree(jax_attn.init_gqa(jax.random.PRNGKey(seed), d, h, hkv,
                                        dh))
    return tree, load(attention.init_gqa(gen(), d, h, hkv, dh), tree)


@pytest.mark.parametrize("s", [24, 130])
def test_apply_gqa_prefill_matches_jax(s):
    tree, p = gqa_pair()
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 576)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want_y, (want_k, want_v) = jax_attn.apply_gqa(
        tree, jnp.asarray(x), jnp.asarray(pos), theta=10000.0)
    with torch.no_grad():
        y, (k, v) = attention.apply_gqa(p, torch.from_numpy(x),
                                        torch.from_numpy(pos), theta=10000.0)
    close(y, want_y, LAYER_TOL)
    close(k, want_k, LAYER_TOL)
    close(v, want_v, LAYER_TOL)


def test_apply_gqa_decode_matches_jax():
    tree, p = gqa_pair()
    rng = np.random.default_rng(5)
    size, idx = 40, 17
    ck = rng.normal(size=(2, 3, size, 64)).astype(np.float32)
    cv = rng.normal(size=(2, 3, size, 64)).astype(np.float32)
    x = rng.normal(size=(2, 1, 576)).astype(np.float32)
    pos = np.full((2, 1), idx, np.int32)
    want_y, want_c = jax_attn.apply_gqa(
        tree, jnp.asarray(x), jnp.asarray(pos), theta=10000.0,
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cache_index=jnp.int32(idx))
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    with torch.no_grad():
        y, new_cache = attention.apply_gqa(
            p, torch.from_numpy(x), torch.from_numpy(pos), theta=10000.0,
            cache=cache, cache_index=idx)
    assert new_cache["k"] is cache["k"]          # written in place
    close(y, want_y, LAYER_TOL)
    close(new_cache["k"], want_c["k"], LAYER_TOL)
    close(new_cache["v"], want_c["v"], LAYER_TOL)


def test_apply_gqa_rejects_what_later_slices_port():
    """What apply_gqa refused before the recurrent and encoder families
    were ported, it now computes as the JAX package does: ``window`` (a
    band of 5 over 12 positions, and a decode into a ring of 5 slots),
    ``causal=False`` without RoPE (an encoder) and ``cross_kv`` (an
    encoder's keys and values, Sq != Skv)."""
    tree, p = gqa_pair(d=48, h=3, hkv=1, dh=16)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 48)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    ck, cv = (rng.normal(size=(2, 1, 7, 16)).astype(np.float32)
              for _ in range(2))
    cases = [dict(window=5), dict(causal=False, rope=False),
             dict(causal=False, rope=False, cross=True)]
    for kw in cases:
        cross = kw.pop("cross", False)
        extra = {"cross_kv": (ck, cv)} if cross else {}
        want_y, _ = jax_attn.apply_gqa(
            tree, jnp.asarray(x), jnp.asarray(pos), theta=1e4, **kw,
            **{k: tuple(map(jnp.asarray, v)) for k, v in extra.items()})
        with torch.no_grad():
            y, _ = attention.apply_gqa(
                p, torch.from_numpy(x), torch.from_numpy(pos), theta=1e4,
                **kw, **{k: tuple(map(torch.from_numpy, v))
                         for k, v in extra.items()})
        close(y, want_y, LAYER_TOL)
    ring = rng.normal(size=(2, 1, 5, 16)).astype(np.float32)
    want_y, want_c = jax_attn.apply_gqa(
        tree, jnp.asarray(x[:, :1]), jnp.full((2, 1), 13, jnp.int32),
        theta=1e4, window=5, cache={"k": jnp.asarray(ring),
                                    "v": jnp.asarray(ring)},
        cache_index=jnp.int32(13))
    cache = {"k": torch.from_numpy(ring.copy()),
             "v": torch.from_numpy(ring.copy())}
    with torch.no_grad():
        y, new = attention.apply_gqa(
            p, torch.from_numpy(x[:, :1]), torch.full((2, 1), 13), theta=1e4,
            window=5, cache=cache, cache_index=13)
    close(y, want_y, LAYER_TOL)
    close(new["k"], want_c["k"], LAYER_TOL)
    assert not torch.equal(new["k"][:, :, 3], torch.from_numpy(ring[:, :, 3]))


# ---------------------------------------------------------------------------
# prefill / decode / serve
# ---------------------------------------------------------------------------

def tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("kind,s", [("reduced", 24), ("reduced", 640),
                                    ("full", 24), ("full", 640)])
def test_prefill_step_matches_jax(kind, s):
    """640 > the JAX package's 512-row q block, so its blocked
    ``mea_attention`` scan runs (and a ragged last block)."""
    jcfg, jparams, cfg, params = models(kind)
    toks = tokens(cfg.vocab, 2, s, seed=s)
    want, want_c = jax_lm.prefill_step(jparams, {"tokens": jnp.asarray(toks)},
                                       jcfg, dtype=jnp.float32)
    got, caches = lm.prefill_step(params, {"tokens": torch.from_numpy(toks)},
                                  cfg, dtype=torch.float32)
    assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
    close(got, want, LOGIT_TOL)
    for name in ("k", "v"):
        assert caches[0]["0_dense"][name].shape == (2, 2, 3 if kind == "full"
                                                    else 1, s, cfg.d_head)
        close(caches[0]["0_dense"][name], want_c[0]["0_dense"][name],
              LOGIT_TOL)


@pytest.mark.parametrize("kind", ["reduced", "full"])
def test_decode_steps_match_jax(kind):
    jcfg, jparams, cfg, params = models(kind)
    b, s, size = 2, 12, 16
    toks = tokens(cfg.vocab, b, s + 4, seed=3)
    jlogits, jc = jax_lm.prefill_step(
        jparams, {"tokens": jnp.asarray(toks[:, :s])}, jcfg, dtype=jnp.float32)
    jcache = jax.tree_util.tree_map(
        lambda full, pre: full.at[..., :s, :].set(pre),
        jax_lm.init_cache(jcfg, b, size, jnp.float32), jc)
    _, pc = lm.prefill_step(params, {"tokens": torch.from_numpy(toks[:, :s])},
                            cfg, dtype=torch.float32)
    cache = merge_caches(lm.init_cache(cfg, b, size, torch.float32, "cpu"), pc)
    for i in range(4):
        t = toks[:, s + i:s + i + 1]
        jlogits, jcache = jax_lm.decode_step(jparams, jcache, jnp.asarray(t),
                                             jnp.int32(s + i), jcfg,
                                             dtype=jnp.float32)
        logits, cache = lm.decode_step(params, cache, torch.from_numpy(t),
                                       s + i, cfg, dtype=torch.float32)
        close(logits, jlogits, LOGIT_TOL)
    for name in ("k", "v"):
        close(cache[0]["0_dense"][name], jcache[0]["0_dense"][name], LOGIT_TOL)


def test_serve_batch_greedy_tokens_equal_jax():
    jcfg, jparams, cfg, params = models("reduced", seed=2)
    b, s, max_new = 3, 10, 6
    prompts = tokens(cfg.vocab, b, s, seed=7)
    want, _ = jax_serve_batch(jcfg, jparams, jnp.asarray(prompts), max_new,
                              cache_size=s + max_new)
    got, stats = serve_batch(cfg, params, torch.from_numpy(prompts), max_new,
                             cache_size=s + max_new)
    assert got.shape == (b, max_new) and stats["tok_per_s"] > 0
    np.testing.assert_array_equal(got, np.asarray(want))

    # no token was a near tie that rounding could flip
    logits, pc = lm.prefill_step(params, {"tokens": torch.from_numpy(prompts)},
                                 cfg, dtype=torch.float32)
    cache = merge_caches(lm.init_cache(cfg, b, s + max_new, torch.float32,
                                       "cpu"), pc)
    margins = []
    for i in range(max_new):
        top2 = torch.topk(logits[:, -1], 2).values
        margins.append((top2[:, 0] - top2[:, 1]).min().item())
        if i < max_new - 1:
            logits, cache = lm.decode_step(
                params, cache, torch.from_numpy(got[:, i:i + 1]), s + i, cfg,
                dtype=torch.float32)
    assert min(margins) > 1e-3, margins


def test_serve_batch_samples_from_its_generator():
    _, _, cfg, params = models("reduced")
    prompts = torch.from_numpy(tokens(cfg.vocab, 2, 6, seed=8))

    def sample(seed):
        g = torch.Generator().manual_seed(seed)
        return serve_batch(cfg, params, prompts, 5, cache_size=10,
                           greedy=False, generator=g)[0]

    a, b = sample(1), sample(1)
    assert a.shape == (2, 5) and ((a >= 0) & (a < cfg.vocab)).all()
    np.testing.assert_array_equal(a, b)
    # the first token is the prefill's argmax, as in the JAX package
    greedy = serve_batch(cfg, params, prompts, 5, cache_size=10)[0]
    np.testing.assert_array_equal(a[:, 0], greedy[:, 0])
    with pytest.raises(ValueError, match="cache_size"):
        serve_batch(cfg, params, prompts, 6, cache_size=10)


def test_prefill_then_decode_matches_stepwise_decode():
    """Prefill(t0..t7) then decode(t8) == decode steps 0..8 token by token,
    as tests/test_arch_smoke.py holds the JAX package."""
    _, _, cfg, params = models("reduced")
    b, s = 1, 8
    toks = torch.from_numpy(tokens(cfg.vocab, b, s + 1, seed=0))
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


def test_bf16_prefill_is_finite_and_near_fp32():
    _, _, cfg, params = models("reduced")
    toks = torch.from_numpy(tokens(cfg.vocab, 2, 20, seed=4))
    lo32, _ = lm.prefill_step(params, {"tokens": toks}, cfg,
                              dtype=torch.float32)
    lo16, c16 = lm.prefill_step(params, {"tokens": toks}, cfg)
    assert lo16.dtype == torch.float32 and torch.isfinite(lo16).all()
    assert c16[0]["0_dense"]["k"].dtype == torch.bfloat16
    assert (lo16 - lo32).abs().max().item() < 0.25


def test_params_from_jax_rejects_a_tree_that_does_not_fit():
    jcfg, jparams, cfg, _ = models("reduced")
    tree = numpy_tree(jparams)
    del tree["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        params_from_jax(tree, cfg, device="cpu")
    tree = numpy_tree(jparams)
    tree["segments"][0]["0_dense"]["attn"]["wq"] = \
        tree["segments"][0]["0_dense"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="groups"):
        params_from_jax(tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="nonesuch"):
        lm.init_params(dataclasses.replace(cfg, family="nonesuch"),
                       device="cpu")


@pytest.mark.parametrize("kind", ["rec", "mlstm", "slstm", "lattn", "enc",
                                  "dec"])
def test_unported_layer_kinds_raise(kind):
    """The kinds a later slice was to port are ported now: each builds the
    JAX package's leaves and empty cache from a config of its family (an
    enc layer has none, in both), and a kind neither package has
    raises."""
    arch = {"rec": "recurrentgemma-9b", "mlstm": "xlstm-1.3b",
            "slstm": "xlstm-1.3b", "lattn": "recurrentgemma-9b",
            "enc": "whisper-tiny", "dec": "whisper-tiny"}[kind]
    cfg, jcfg = get_arch(arch, True), jax_get_arch(arch, True)
    want = jax_blocks.init_layer(jax.random.PRNGKey(0), jcfg, kind)
    got = blocks.init_layer(torch.Generator(), cfg, kind)
    shapes = {n: tuple(t.shape) for n, t in got.named_parameters()}
    assert shapes == {
        ".".join(k.key for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    with pytest.raises(ValueError, match="kind 'nonesuch'"):
        blocks.init_layer(torch.Generator(), cfg, "nonesuch")
    if kind == "enc":          # the encoder runs once, in prefill
        with pytest.raises(ValueError):
            jax_blocks.init_layer_cache(jcfg, kind, 1, 4, jnp.float32)
        with pytest.raises(ValueError, match="no decode cache"):
            blocks.init_layer_cache(cfg, kind, 1, 4, torch.float32)
        return
    want_c = jax_blocks.init_layer_cache(jcfg, kind, 1, 4, jnp.float32,
                                         enc_len=3)
    got_c = blocks.init_layer_cache(cfg, kind, 1, 4, torch.float32,
                                    enc_len=3)
    assert sorted(got_c) == sorted(want_c)
    for name, leaf in want_c.items():
        np.testing.assert_array_equal(got_c[name].numpy(), np.asarray(leaf))


def test_registered_configs_are_the_jax_packages():
    """Every architecture the port registers is the JAX package's, field
    for field, published and reduced."""
    for arch in ARCH_IDS:
        for reduced in (False, True):
            assert dataclasses.asdict(get_arch(arch, reduced)) == \
                dataclasses.asdict(jax_get_arch(arch, reduced))
    for arch in ("dbrx-132b", "deepseek-v2-236b"):
        assert not get_arch(arch).tie_embeddings      # each has its head


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "granite-3-8b",
                                  "stablelm-12b"])
def test_dense_registry_configs_prefill_matches_jax(arch):
    jcfg, cfg = jax_get_arch(arch, True), get_arch(arch, True)
    jparams = jax_lm.init_params(jax.random.PRNGKey(3), jcfg)
    params = params_from_jax(numpy_tree(jparams), cfg, device="cpu")
    toks = tokens(cfg.vocab, 2, 40, seed=2)
    want, _ = jax_lm.prefill_step(jparams, {"tokens": jnp.asarray(toks)},
                                  jcfg, dtype=jnp.float32)
    got, _ = lm.prefill_step(params, {"tokens": torch.from_numpy(toks)}, cfg,
                             dtype=torch.float32)
    close(got, want, LOGIT_TOL)
