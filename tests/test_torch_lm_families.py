"""The port's recurrent and encoder families (xlstm-1.3b's ``ssm``,
recurrentgemma-9b's ``hybrid``, llava-next-34b's ``vlm``, whisper-tiny's
``audio_encdec``) against the JAX package, on the CPU.

Configs are the ``reduced()`` ones (the port's equal the JAX package's),
the JAX package's weights are carried across with ``params_from_jax``, the
inputs come from numpy generators with fixed seeds, and everything runs in
fp32. Logits are held within 1e-5 of the largest |logit|, every cache leaf
within 1e-5 of its largest entry, the loss within 1e-5 relative and each
gradient leaf within 1e-5 of its largest entry: both packages compute the
same function, with the prefill's attention in the plain version of the
flash-attention kernel where the JAX package runs ``mea_attention``. The
JAX side runs under ``jit``. The reference's quirks are pinned as they
are: the ``lattn`` ring after a prompt that is not a multiple of the
window, recurrentgemma's ``attn`` layers as full causal attention with a
full-size cache, and decode's cross-attention over every ``enc_len`` slot.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.models import blocks as jax_blocks
from repro.models import lm as jax_lm
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import serve, train
from repro_torch.launch.serve import merge_caches
from repro_torch.models import blocks, lm
from repro_torch.models.convert import params_from_jax, params_to_jax

TOL = 1e-5
ARCHS = ("xlstm-1.3b", "recurrentgemma-9b", "llava-next-34b", "whisper-tiny")
B, S, FRAMES, STEPS = 2, 20, 24, 4


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    """Within ``tol`` of the largest entry of ``want``."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs diff {err} > {tol} x {scale}"


def caches_close(got, want, tol=TOL):
    assert len(got) == len(want)
    for seg, jseg in zip(got, want):
        assert sorted(seg) == sorted(jseg)
        for key in seg:
            assert sorted(seg[key]) == sorted(jseg[key])
            for name, leaf in seg[key].items():
                close(leaf.float(), jseg[key][name], tol)


def jax_merge(full, pre):
    """The JAX package's serve_batch merge of prefill caches."""
    def merge(dst, src):
        if dst.shape != src.shape:
            sl = tuple(slice(0, n) for n in src.shape)
            return dst.at[sl].set(src.astype(dst.dtype))
        return src.astype(dst.dtype)
    return jax.tree_util.tree_map(merge, full, pre)


def inputs(cfg, s=S, seed=0, frames=FRAMES):
    """(prompt batch of numpy arrays, the next tokens): llava's patches,
    whisper's frames beside the tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, s + STEPS)).astype(np.int32)
    batch = {"tokens": toks[:, :s]}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio_encdec":
        batch["frames"] = rng.normal(
            size=(B, frames, cfg.d_model)).astype(np.float32)
    return batch, toks[:, s:]


def prefix(cfg):
    """Positions before the tokens (llava's patches)."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def cache_kw(cfg, frames=FRAMES):
    return {"enc_len": frames} if cfg.family == "audio_encdec" else {}


def jax_serve(jcfg, jparams, batch, nxt, size, **kw):
    """The JAX package's prefill, its caches merged into ``size``-position
    decode caches, then a decode step for each of ``nxt``'s tokens:
    (prefill logits, prefill caches,
    decode logits per step, final caches)."""
    prefill = jax.jit(functools.partial(jax_lm.prefill_step, cfg=jcfg,
                                        dtype=jnp.float32))
    decode = jax.jit(functools.partial(jax_lm.decode_step, cfg=jcfg,
                                       dtype=jnp.float32))
    logits, pc = prefill(jparams, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    cache = jax_merge(jax_lm.init_cache(jcfg, B, size, jnp.float32, **kw), pc)
    s0 = batch["tokens"].shape[1] + prefix(jcfg)
    steps = []
    for i in range(nxt.shape[1]):
        out, cache = decode(jparams, cache, jnp.asarray(nxt[:, i:i + 1]),
                            pos=jnp.int32(s0 + i))
        steps.append(np.asarray(out))
    return (np.asarray(logits), numpy_tree(pc), steps, numpy_tree(cache))


def port_serve(cfg, params, batch, nxt, size, **kw):
    logits, pc = lm.prefill_step(params, {k: t(v) for k, v in batch.items()},
                                 cfg, dtype=torch.float32)
    pre = [{k: {n: v.clone() for n, v in layer.items()}
            for k, layer in seg.items()} for seg in pc]
    cache = merge_caches(lm.init_cache(cfg, B, size, torch.float32, "cpu",
                                       **kw), pc)
    s0 = batch["tokens"].shape[1] + prefix(cfg)
    steps = []
    for i in range(nxt.shape[1]):
        out, cache = lm.decode_step(params, cache, t(nxt[:, i:i + 1]),
                                    s0 + i, cfg, dtype=torch.float32)
        steps.append(out)
    return logits, pre, steps, cache


def loss_batch(batch, nxt):
    b = dict(batch)
    b["labels"] = np.concatenate([batch["tokens"][:, 1:], nxt[:, :1]], 1)
    b["labels"][0, :3] = -1                                # masked out
    return b


def jax_loss_and_grads(jcfg, jparams, b):
    def loss(p):
        return jax_lm.loss_fn(p, {k: jnp.asarray(v) for k, v in b.items()},
                              jcfg, dtype=jnp.float32, remat_policy="none")
    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (value, metrics), grads = value_and_grad(jparams)
    return float(value), float(metrics["xent"]), numpy_tree(grads)


@functools.lru_cache(maxsize=None)
def jax_init(jcfg, seed=1):
    """The JAX package's weights for ``jcfg`` (one compile of its init)."""
    init = jax.jit(lambda k: jax_lm.init_params(k, jcfg))
    return init(jax.random.PRNGKey(seed))


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """One family at reduced(): both packages' weights, a prompt, and the
    JAX package's prefill, decode steps, loss and gradients on it."""
    cfg = get_arch(request.param, reduced=True)
    jcfg = jax_get_arch(request.param, reduced=True)
    jparams = jax_init(jcfg)
    batch, nxt = inputs(cfg)
    size = S + prefix(cfg) + STEPS
    b = loss_batch(batch, nxt)
    return dict(
        arch=request.param, cfg=cfg, jcfg=jcfg, jparams=jparams,
        params=params_from_jax(numpy_tree(jparams), cfg, device="cpu"),
        batch=batch, nxt=nxt, size=size, loss_batch=b,
        want=jax_serve(jcfg, jparams, batch, nxt, size, **cache_kw(cfg)),
        want_loss=jax_loss_and_grads(jcfg, jparams, b))


# ---------------------------------------------------------------------------
# prefill, decode, the objective
# ---------------------------------------------------------------------------

def test_prefill_step_matches_jax(family):
    f = family
    want_logits, want_caches, _, _ = f["want"]
    logits, caches, _, _ = port_serve(f["cfg"], f["params"], f["batch"],
                                      f["nxt"][:, :0], f["size"],
                                      **cache_kw(f["cfg"]))
    assert logits.shape == (B, 1, f["cfg"].vocab)
    close(logits, want_logits)
    caches_close(caches, want_caches)


def test_decode_steps_match_jax(family):
    f = family
    _, _, want_steps, want_cache = f["want"]
    _, _, steps, cache = port_serve(f["cfg"], f["params"], f["batch"],
                                    f["nxt"], f["size"], **cache_kw(f["cfg"]))
    for got, want in zip(steps, want_steps):
        close(got, want)
    caches_close(cache, want_cache)


def test_loss_fn_and_gradients_match_jax(family):
    """The port under remat "full" (its training default; the encoder's
    output flows into every decoder group's recomputation), the JAX
    package without remat: the same function."""
    f = family
    want, want_xent, want_grads = f["want_loss"]
    params = f["params"]
    loss, m = lm.loss_fn(params, {k: t(v) for k, v in f["loss_batch"].items()},
                         f["cfg"], dtype=torch.float32)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    np.testing.assert_allclose(loss.item(), want, rtol=TOL)
    np.testing.assert_allclose(m["xent"].item(), want_xent, rtol=TOL)
    got = params_to_jax(params, grads)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want_grads))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want_grads)):
        close(g, w)


def test_prefill_then_decode_matches_stepwise_decode(family):
    """Prefill(t0..t7) then decode(t8) == decode t0..t8 one by one, as
    tests/test_arch_smoke.py holds the JAX package; llava and whisper
    prefill their patches or frames with t0 first, then decode t1..t8."""
    f = family
    cfg, params = f["cfg"], f["params"]
    s = 8
    batch, _ = inputs(cfg, s=s + 1, seed=5)
    toks = t(batch["tokens"][:1])
    extra = {k: t(v[:1]) for k, v in batch.items() if k != "tokens"}
    size = s + 1 + prefix(cfg)
    kw = cache_kw(cfg)
    if extra:
        _, pc = lm.prefill_step(params, dict(extra, tokens=toks[:, :1]), cfg,
                                dtype=torch.float32)
        cache, first = merge_caches(lm.init_cache(cfg, 1, size, torch.float32,
                                                  "cpu", **kw), pc), 1
    else:
        cache, first = lm.init_cache(cfg, 1, size, torch.float32, "cpu"), 0
    for i in range(first, s + 1):
        logits_a, cache = lm.decode_step(params, cache, toks[:, i:i + 1],
                                         i + prefix(cfg), cfg,
                                         dtype=torch.float32)
    _, pc = lm.prefill_step(params, dict(extra, tokens=toks[:, :s]), cfg,
                            dtype=torch.float32)
    full = merge_caches(lm.init_cache(cfg, 1, size, torch.float32, "cpu",
                                      **kw), pc)
    logits_b, _ = lm.decode_step(params, full, toks[:, s:s + 1],
                                 s + prefix(cfg), cfg, dtype=torch.float32)
    close(logits_a, logits_b.numpy())


def test_bf16_prefill_is_finite_and_near_fp32(family):
    f = family
    batch = {k: t(v) for k, v in f["batch"].items()}
    lo32, _ = lm.prefill_step(f["params"], batch, f["cfg"],
                              dtype=torch.float32)
    lo16, c16 = lm.prefill_step(f["params"], batch, f["cfg"])
    assert lo16.dtype == torch.float32 and torch.isfinite(lo16).all()
    assert (lo16 - lo32).abs().max().item() < 0.05 * lo32.abs().max().item()
    leaves = [leaf for seg in c16 for layer in seg.values()
              for leaf in layer.values()]
    assert all(torch.isfinite(leaf.float()).all() for leaf in leaves)


def test_params_round_trip_through_the_jax_layout(family):
    tree = numpy_tree(family["jparams"])
    back = params_to_jax(params_from_jax(tree, family["cfg"], device="cpu"))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch,path", [
    ("xlstm-1.3b", ("segments", 0, "0_mlstm", "block", "b_if")),
    ("recurrentgemma-9b", ("segments", 0, "0_rec", "rec", "lambda")),
    ("recurrentgemma-9b", ("segments", 0, "0_rec", "rec", "conv", "w")),
    ("whisper-tiny", ("dec_segments", 0, "0_dec", "cross", "wk")),
    ("whisper-tiny", ("enc_segments", 0, "0_enc", "attn", "wq")),
    ("whisper-tiny", ("enc_norm", "bias"))])
def test_params_from_jax_names_the_new_leaves(arch, path):
    """A tree without one of the new leaves is refused with its path; the
    model made from the whole tree holds that leaf's numbers."""
    cfg, jcfg = get_arch(arch, True), jax_get_arch(arch, True)
    tree = numpy_tree(jax_init(jcfg))
    node = tree
    for key in path[:-1]:
        node = node[key]
    leaf = node.pop(path[-1])
    with pytest.raises(KeyError, match=".".join(map(str, path))):
        params_from_jax(tree, cfg, device="cpu")
    node[path[-1]] = leaf
    back = params_to_jax(params_from_jax(tree, cfg, device="cpu"))
    for key in path:
        back = back[key]
    np.testing.assert_array_equal(back, leaf)


# ---------------------------------------------------------------------------
# the reference's quirks, pinned
# ---------------------------------------------------------------------------

def lattn_models():
    """recurrentgemma at reduced() with pattern ("rec", "lattn"): the only
    config that runs local attention (window 16)."""
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b", True),
                              n_layers=2, pattern=("rec", "lattn"))
    jcfg = type(jax_get_arch("recurrentgemma-9b", True))(
        **dataclasses.asdict(cfg))
    jparams = jax_init(jcfg, seed=3)
    return cfg, jcfg, jparams, params_from_jax(numpy_tree(jparams), cfg,
                                               device="cpu")


@pytest.mark.parametrize("s", [20, 32])
def test_lattn_ring_matches_jax(s):
    """Prefill keeps the last 16 keys in slots 0..15 and decode writes
    position p at slot p % 16: after a prompt of 20 the first decode (p =
    20, slot 4) overwrites the key of position 8 while position 4's stays
    in slot 0; after 32 (a multiple of the window) it overwrites the
    oldest, position 16. Both packages do the same: logits and caches
    equal within 1e-5."""
    cfg, jcfg, jparams, params = lattn_models()
    batch, nxt = inputs(cfg, s=s, seed=7)
    size = s + STEPS
    want_logits, want_pc, want_steps, want_cache = jax_serve(
        jcfg, jparams, batch, nxt, size)
    logits, pc, steps, cache = port_serve(cfg, params, batch, nxt, size)
    close(logits, want_logits)
    caches_close(pc, want_pc)
    for got, want in zip(steps, want_steps):
        close(got, want)
    caches_close(cache, want_cache)
    ring = pc[0]["1_lattn"]["k"][0]                   # [B, Hkv, 16, dh]
    assert ring.shape[2] == cfg.attn_window == 16
    _, (k_all, _) = _first_lattn_keys(params, cfg, batch)
    np.testing.assert_array_equal(ring.numpy(), k_all[:, :, s - 16:].numpy())
    after = cache[0]["1_lattn"]["k"][0]
    written = [(s + i) % 16 for i in range(STEPS)]
    for slot in range(16):
        assert torch.equal(after[:, :, slot], ring[:, :, slot]) == (
            slot not in written)
    # the first write (position s) lands in slot s % 16; the oldest key
    # (position s - 16, slot 0) is the one overwritten only when 16 | s
    assert written[0] == s % 16
    assert (0 in written) == (s % 16 == 0)


def _first_lattn_keys(params, cfg, batch):
    """The lattn layer's keys over the whole prompt."""
    from repro_torch.models import attention, layers
    x = layers.embed_tokens(params.embed, t(batch["tokens"]), torch.float32)
    pos = torch.arange(x.shape[1], dtype=torch.int32)[None].expand(B, -1)
    group = params.segments[0][0]
    with torch.no_grad():
        x, _, _ = blocks.apply_layer(group["0_rec"], x, pos, cfg, "rec")
        xin = layers.apply_norm(group["1_lattn"].norm_attn, x, cfg.norm)
        return attention.apply_gqa(group["1_lattn"].attn, xin, pos,
                                   theta=cfg.rope_theta, window=16)


def test_recurrentgemma_attn_is_full_causal_with_a_full_cache():
    """attn_window (2,048 published, 16 reduced) is read only by lattn:
    the attn layers attend to every earlier position and cache all of
    them, as in the reference (20 positions > the window of 16 here)."""
    cfg = get_arch("recurrentgemma-9b", True)
    assert blocks.segments_for(cfg) == [(("rec", "rec", "attn"), 1)]
    cache = lm.init_cache(cfg, B, 40, torch.float32, "cpu")
    assert cache[0]["2_attn"]["k"].shape[-2] == 40 > cfg.attn_window
    jcache = jax_lm.init_cache(jax_get_arch("recurrentgemma-9b", True), B, 40,
                               jnp.float32)
    assert jcache[0]["2_attn"]["k"].shape == tuple(cache[0]["2_attn"]["k"]
                                                   .shape)


def test_whisper_cross_attends_every_enc_len_slot():
    """Decode's cross-attention attends to all enc_len slots, unmasked: a
    cross cache of 30 slots behind 24 frames attends to six zero keys too,
    in both packages, and gives other logits than one of 24. The default
    enc_len is 1,500 (whisper's 30 s window)."""
    cfg = get_arch("whisper-tiny", True)
    jcfg = jax_get_arch("whisper-tiny", True)
    jparams = jax_init(jcfg)
    params = params_from_jax(numpy_tree(jparams), cfg, device="cpu")
    batch, nxt = inputs(cfg, s=6, seed=9)
    got = {}
    for enc_len in (FRAMES, FRAMES + 6):
        _, _, want_steps, _ = jax_serve(jcfg, jparams, batch, nxt, 6 + STEPS,
                                        enc_len=enc_len)
        _, _, steps, cache = port_serve(cfg, params, batch, nxt, 6 + STEPS,
                                        enc_len=enc_len)
        assert cache[0]["0_dec"]["cross_k"].shape[-2] == enc_len
        for a, w in zip(steps, want_steps):
            close(a, w)
        got[enc_len] = steps[0]
    assert (got[FRAMES] - got[FRAMES + 6]).abs().max() > 1e-3
    assert lm.init_cache(cfg, 1, 4, torch.float32, "cpu")[0]["0_dec"][
        "cross_k"].shape[-2] == 1500


def test_merge_caches_copies_states_whole_and_kv_along_s():
    """The JAX package's leaf rule: a leaf of the decode cache's shape is
    copied whole (recurrent states: m [n, B, H], h [n, B, W], the conv
    windows), any other into the leading slice of each axis that differs
    (k/v along S)."""
    for arch in ("xlstm-1.3b", "recurrentgemma-9b"):
        cfg = get_arch(arch, True)
        full = lm.init_cache(cfg, B, 10, torch.float32, "cpu")
        rng = np.random.default_rng(11)
        pre = [{key: {name: torch.from_numpy(rng.normal(size=(
                    leaf.shape[:-2] + (6,) + leaf.shape[-1:])
                    if name in ("k", "v") else leaf.shape).astype(np.float32))
                      for name, leaf in layer.items()}
                for key, layer in seg.items()} for seg in full]
        want = jax_merge(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), full),
            jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), pre))
        merge_caches(full, pre)
        for seg, jseg in zip(full, want):
            for key, layer in seg.items():
                for name, leaf in layer.items():
                    np.testing.assert_array_equal(leaf.numpy(),
                                                  np.asarray(jseg[key][name]))


# ---------------------------------------------------------------------------
# the registry, the segments, the launchers
# ---------------------------------------------------------------------------

def test_registry_is_the_jax_packages():
    """All ten architectures in the JAX package's order; each config and
    its segments equal, published and reduced (recurrentgemma-9b: 12
    (rec, rec, attn) groups and a trailing (rec, rec))."""
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for reduced in (False, True):
            cfg, jcfg = get_arch(arch, reduced), jax_get_arch(arch, reduced)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert blocks.segments_for(cfg) == jax_blocks.segments_for(jcfg)
    assert blocks.segments_for(get_arch("recurrentgemma-9b")) == [
        (("rec", "rec", "attn"), 12), (("rec", "rec"), 1)]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "recurrentgemma-9b"])
def test_serve_cli_runs_the_recurrent_archs_on_the_cpu(arch):
    cfg = get_arch(arch, reduced=True)
    gen = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "5", "--max-new",
                      "3"])
    assert gen.shape == (2, 3) and ((gen >= 0) & (gen < cfg.vocab)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_takes_each_arch(arch, capsys):
    """As the JAX launcher does: llava-next on seeded stub patches,
    whisper on seeded stub frames."""
    history = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "8",
                          "--ckpt-every", "100"])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert "loss" in capsys.readouterr().out
