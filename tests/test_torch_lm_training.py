"""The port's LM training path (loss -> step -> checkpoint -> launch/train)
against the JAX package, on the CPU.

The model is smollm-135m's reduced config (2 layers, d_model 48, vocab
256); the JAX package's weights are carried across with
``params_from_jax`` and everything runs in fp32 at S <= 64. Losses are
held to 1e-5 relative, gradients and parameters to 1e-4 (``assert_allclose``
rtol = atol): both packages compute the same function with the
arithmetic in another order. Where the port should give the same bits
(a remat policy against none, a resumed run against an uninterrupted
one, a checkpoint's layout), it is held to them.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_arch as jax_get_arch
from repro.data import tokens as jax_tokens
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.train import checkpoint as jax_ckpt
from repro.train import loop as jax_loop
from repro_torch.config import TrainConfig
from repro_torch.configs import get_arch
from repro_torch.data import tokens
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, layers, lm
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S = 4, 32


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def trees_close(got, want, tol):
    """Two trees of the same layout, leaf by leaf."""
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        close(g, w, tol)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(numpy_tree(want)))


@pytest.fixture(scope="module")
def model():
    """(JAX config, JAX params, port config, port model) of the reduced
    smollm-135m, one set of weights."""
    jcfg, cfg = jax_get_arch("smollm-135m", True), get_arch("smollm-135m",
                                                           True)
    init = jax.jit(jax_lm.init_params, static_argnums=1)
    jparams = init(jax.random.PRNGKey(1), jcfg)
    return jcfg, jparams, cfg, params_from_jax(numpy_tree(jparams), cfg,
                                               device="cpu")


def batch(vocab, i=0, b=B, s=S):
    """Step i's batch (tokens and labels are views of one array: copied)."""
    return {k: v.copy() for k, v in
            tokens.FastTokenStream(vocab, s, b, seed=3).batch_at(i).items()}


def port_grads(params, b, cfg, remat="none"):
    loss, _ = lm.loss_fn(params, {k: t(v) for k, v in b.items()}, cfg,
                         dtype=torch.float32, remat_policy=remat)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss.item(), grads


# ---------------------------------------------------------------------------
# data, layers, attention
# ---------------------------------------------------------------------------

def test_token_streams_are_the_jax_package_streams():
    for i in (0, 5):
        a = tokens.FastTokenStream(300, 24, 3, seed=7).batch_at(i)
        b = jax_tokens.FastTokenStream(300, 24, 3, seed=7).batch_at(i)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    a = tokens.TokenStream(50, 6, 2, seed=1).batch_at(2)
    b = jax_tokens.TokenStream(50, 6, 2, seed=1).batch_at(2)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_softmax_xent_and_unembed_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 64)).astype(np.float32) * 4
    labels = rng.integers(0, 64, (3, 7)).astype(np.int32)
    close(layers.softmax_xent(t(logits), t(labels)),
          jax_layers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)),
          1e-6)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    tok = rng.normal(size=(64, 16)).astype(np.float32)
    head = rng.normal(size=(16, 64)).astype(np.float32)
    emb = layers.Embed(torch.Generator(), 64, 16)
    with torch.no_grad():
        emb.tokens.copy_(t(tok))
    p_head = torch.nn.Module()
    p_head.w = t(head)
    for tie in (True, False):
        want = jax_layers.unembed({"tokens": jnp.asarray(tok)},
                                  {"w": jnp.asarray(head)}, jnp.asarray(x),
                                  tie)
        got = layers.unembed(emb, p_head, t(x), tie)
        assert got.dtype == torch.float32
        close(got.detach(), want, 1e-5)


@pytest.mark.parametrize("chunk", [64, 16])
def test_chunked_xent_matches_jax(chunk):
    """Both branches: the whole sequence at once (s <= chunk) and in
    chunks recomputed in the backward pass; the value and its gradients."""
    rng = np.random.default_rng(chunk)
    x = rng.normal(size=(2, 64, 24)).astype(np.float32)
    w = rng.normal(size=(24, 128)).astype(np.float32)
    labels = rng.integers(0, 128, (2, 64)).astype(np.int32)
    mask = (rng.random((2, 64)) > 0.2).astype(np.float32)

    def jax_fn(x, w):
        return jax_lm.chunked_xent(x, w, jnp.asarray(labels),
                                   jnp.asarray(mask), chunk=chunk)

    value_and_grad = jax.jit(jax.value_and_grad(jax_fn, (0, 1)))
    want, (wgx, wgw) = value_and_grad(jnp.asarray(x), jnp.asarray(w))
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    got = lm.chunked_xent(xt, wt, t(labels), t(mask), chunk=chunk)
    gx, gw = torch.autograd.grad(got, (xt, wt))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    close(gx, wgx, GRAD_TOL)
    close(gw, wgw, GRAD_TOL)
    with pytest.raises(ValueError, match="not divisible"):
        lm.chunked_xent(t(x[:, :40]), t(w), t(labels[:, :40]),
                        t(mask[:, :40]), chunk=16)


def attention_inputs(sq, skv, hq=6, hkv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(2, hkv, skv, d)).astype(np.float32)
    v = rng.normal(size=(2, hkv, skv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sq,skv,kw", [
    (64, 64, dict(q_block=16, kv_block=32)),            # blocked, causal
    (50, 50, dict(q_block=16, kv_block=32)),            # padded blocks
    (40, 64, dict(q_block=16, kv_block=16, causal=False)),
    (48, 48, dict(q_block=16, kv_block=16, window=20)),
    (16, 48, dict(q_block=16, kv_block=16, q_offset=32)),
    (24, 24, dict()),                                   # one block: naive
])
def test_mea_attention_matches_jax(sq, skv, kw):
    q, k, v = attention_inputs(sq, skv)
    want = jax_attn.mea_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), impl="blocked", **kw)
    got = attention.mea_attention(t(q), t(k), t(v), **kw)
    close(got, want, 1e-5)


def test_mea_attention_packed_and_gradients_match_jax():
    q, k, v = attention_inputs(64, 64, seed=1)
    want = jax_attn.mea_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), block=16)
    close(attention.mea_attention_packed(t(q), t(k), t(v), block=16), want,
          1e-5)
    close(attention.mea_attention(t(q), t(k), t(v), q_block=16,
                                  kv_block=16), want, 1e-5)
    with pytest.raises(ValueError, match="multiple of the block"):
        attention.mea_attention_packed(t(q[:, :, :50]), t(k[:, :, :50]),
                                       t(v[:, :, :50]), block=16)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)

    def jax_fn(q, k, v):
        out = jax_attn.mea_attention(q, k, v, q_block=16, kv_block=32,
                                     impl="blocked")
        return jnp.sum(out * jnp.asarray(g))

    grad = jax.jit(jax.grad(jax_fn, (0, 1, 2)))
    wants = grad(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ins = [t(a).requires_grad_() for a in (q, k, v)]
    out = attention.mea_attention(*ins, q_block=16, kv_block=32)
    gots = torch.autograd.grad(torch.sum(out * t(g)), ins)
    for got, want in zip(gots, wants):
        close(got, want, GRAD_TOL)


def test_flash_attention_refuses_inputs_that_require_grad():
    q, k, v = (t(a) for a in attention_inputs(8, 8))
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape


# ---------------------------------------------------------------------------
# the objective and its gradients
# ---------------------------------------------------------------------------

def test_loss_fn_and_gradients_match_jax(model):
    jcfg, jparams, cfg, params = model
    b = batch(cfg.vocab)
    b["labels"][0, :5] = -1                             # masked out

    def jax_loss(p):
        return jax_lm.loss_fn(p, {k: jnp.asarray(v) for k, v in b.items()},
                              jcfg, dtype=jnp.float32, remat_policy="none")[0]

    value_and_grad = jax.jit(jax.value_and_grad(jax_loss))
    want, wgrads = value_and_grad(jparams)
    got, grads = port_grads(params, b, cfg)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
    trees_close(params_to_jax(params, grads), wgrads, GRAD_TOL)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_each_remat_policy_gives_the_grads_of_none(model, remat):
    _, _, cfg, params = model
    b = batch(cfg.vocab, i=1)
    ref_loss, ref = port_grads(params, b, cfg, "none")
    got_loss, got = port_grads(params, b, cfg, remat)
    assert got_loss == ref_loss
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_loss_fn_refuses_what_is_not_ported(model):
    _, _, cfg, params = model
    b = {k: t(v) for k, v in batch(cfg.vocab).items()}
    with pytest.raises(ValueError, match="remat policy 'some'"):
        lm.loss_fn(params, b, cfg, remat_policy="some")
    # the vlm family (ported since) needs its patch embeddings
    with pytest.raises(KeyError, match="patches"):
        lm.loss_fn(params, b, dataclasses.replace(cfg, family="vlm"))


# ---------------------------------------------------------------------------
# train steps, checkpoints, the launcher
# ---------------------------------------------------------------------------

TCFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
            remat_policy="none")


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_jax(model, accum):
    jcfg, jparams, cfg, _ = model
    params = params_from_jax(numpy_tree(jparams), cfg, device="cpu")
    jstep = jax_loop.make_train_step(jcfg, JTrainConfig(**TCFG),
                                     accum=accum)
    step = loop.make_train_step(cfg, TrainConfig(**TCFG), accum=accum)
    from repro.train.optim import init_opt_state as jax_init_opt
    from repro_torch.train.optim import init_opt_state
    jp = jax.tree_util.tree_map(jnp.array, jparams)
    jopt = jax_init_opt(jp)
    opt = init_opt_state(list(params.parameters()))
    for i in range(3):
        b = batch(cfg.vocab, i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        opt, m = step(params, opt, {k: t(v) for k, v in b.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=GRAD_TOL)
    trees_close(params_to_jax(params), jp, GRAD_TOL)
    trees_close(params_to_jax(params, opt["m"]), jopt["m"], GRAD_TOL)
    assert int(opt["step"]) == int(jopt["step"]) == 3


def test_checkpoint_layout_is_the_jax_package_layout(model, tmp_path):
    """The train state's tree flattens as jax.tree_util does (the treedef
    string too); a checkpoint written by either package restores in the
    other, leaf for leaf; an uncommitted directory does not count."""
    jcfg, jparams, cfg, params = model
    from repro.train.optim import init_opt_state as jax_init_opt
    from repro_torch.train.optim import init_opt_state
    jstate = (jparams, jax_init_opt(jparams))
    state = loop.state_tree(params, init_opt_state(list(params.parameters())))
    leaves, structure = ckpt.flatten(state)
    assert structure == str(jax.tree_util.tree_structure(jstate))
    assert len(leaves) == len(jax.tree_util.tree_leaves(jstate))
    ckpt.save(str(tmp_path / "port"), 4, state)
    jax_ckpt.save(str(tmp_path / "jax"), 4, jstate)
    meta = [json.loads((tmp_path / d / "step_4" / "treedef.json").read_text())
            for d in ("port", "jax")]
    assert meta[0] == meta[1]
    back, step = jax_ckpt.restore(str(tmp_path / "port"), jstate)
    assert step == 4
    trees_close(back, jstate, 0)
    back, step = ckpt.restore(str(tmp_path / "jax"), state)
    trees_close(back, state, 0)
    # an interrupted save leaves no COMMITTED marker: not a checkpoint
    shutil.copytree(tmp_path / "port" / "step_4", tmp_path / "port" / "step_9")
    (tmp_path / "port" / "step_9" / "COMMITTED").unlink()
    (tmp_path / "port" / "step_x").mkdir()
    assert ckpt.latest_step(str(tmp_path / "port")) == 4
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state)


def test_port_resumes_a_jax_checkpoint_exactly(model, tmp_path):
    """JAX trains 2 steps and commits; the port restores that commit and
    trains steps 3-4 to JAX's own losses for them. A port run resumed from
    its own commit at step 3 then equals the uninterrupted one bit for
    bit. (The layout test above has each package restore the other's
    files.)"""
    jcfg, jparams, cfg, _ = model
    tcfg = dict(TCFG, seed=1)            # the fixture's weights: PRNGKey(1)
    stream = tokens.FastTokenStream(cfg.vocab, S, B, seed=3)
    quiet = dict(log_fn=lambda *_: None, log_every=1)
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_loop.train(jcfg, JTrainConfig(**tcfg), stream.batch_at, steps=2,
                   ckpt_dir=jd, **quiet)
    shutil.copytree(jd, pd)
    *_, jhist = jax_loop.train(jcfg, JTrainConfig(**tcfg), stream.batch_at,
                               steps=4, ckpt_dir=jd, **quiet)
    *_, straight = loop.train(cfg, TrainConfig(**tcfg), stream.batch_at,
                              steps=4, ckpt_dir=pd, device="cpu", **quiet)
    assert [h["step"] for h in straight] == [h["step"] for h in jhist] == [
        3, 4]
    np.testing.assert_allclose([h["loss"] for h in straight],
                               [h["loss"] for h in jhist], rtol=LOSS_RTOL)
    shutil.rmtree(f"{pd}/step_4")
    loop.train(cfg, TrainConfig(**tcfg), stream.batch_at, steps=3,
               ckpt_dir=pd, device="cpu", **quiet)
    *_, resumed = loop.train(cfg, TrainConfig(**tcfg), stream.batch_at,
                             steps=4, ckpt_dir=pd, device="cpu", **quiet)
    assert [h["loss"] for h in resumed] == [straight[-1]["loss"]]


def test_train_cli_runs_to_its_end_and_resumes(tmp_path, capsys):
    argv = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16", "--remat", "full",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    history = train_cli.main(argv)
    assert [h["step"] for h in history] == [4]
    assert np.isfinite(history[0]["loss"])
    assert ckpt.latest_step(str(tmp_path)) == 4
    history = train_cli.main(argv[:6] + ["6"] + argv[7:])
    out = capsys.readouterr().out
    assert "[resume] restored step 4" in out and "over 6 steps" in out
    assert [h["step"] for h in history] == [6]
