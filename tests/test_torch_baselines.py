"""The port's comparison plane against the JAX package on the same inputs.

* NN-flow, NN-diffusion, TVAE and CTGAN: the JAX package's initial weights
  go through ``mlp_from_jax``, and its per-step draws are rebuilt from its
  key chain (``fold_in(key, step)``, then ``split``) and handed to the
  port's ``fit(draws=)``. After 20 steps the parameters agree within 1e-4
  and every step's loss within 1e-5 relative; ``generate`` from the same
  initial noise agrees within 1e-4 and draws the same labels.
* GaussianCopula: the same numbers, bit for bit (the same numpy).
* The Original-style trainer on two-moons (n_t = 2, K = 4, T = 4, depth
  3): the same ``(t, class, column)`` keys in the same order, tree
  structure equal, thresholds and leaves within 1e-5.
* The ``ForestGenerativeModel`` shim: its warning, ``generate`` equal to
  ``sample()`` on its artifacts, the legacy attributes.
* ``sample_loop_reference`` against the JAX package's with the same x1,
  within 1e-5.
"""
import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ForestConfig as JForestConfig
from repro.core import ctgan as jctgan
from repro.core import nn_baselines as jnn
from repro.core.copula import GaussianCopula as JCopula
from repro.core.forest_flow import ForestGenerativeModel as JShim
from repro.core.naive import NaiveForestGenerativeModel as JNaive
from repro.data.tabular import two_moons
from repro.tabgen import fit_artifacts as j_fit
from repro.tabgen.sampling import sample_labels as j_sample_labels
from repro.tabgen.sampling import sample_loop_reference as j_loop
from repro_torch.config import ForestConfig
from repro_torch.core import ctgan, nn_baselines
from repro_torch.core.copula import GaussianCopula
from repro_torch.core.forest_flow import ForestGenerativeModel
from repro_torch.core.naive import NaiveForestGenerativeModel
from repro_torch.tabgen import (artifacts_from_numpy, sample,
                                sample_loop_reference)
from repro_torch.tabgen.fitting import weighted_edges

STEPS = 20
PARAM_TOL, LOSS_RTOL, GEN_TOL = 1e-4, 1e-5, 1e-4


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def moons():
    return two_moons(120, seed=0)


@contextlib.contextmanager
def jax_losses():
    """Record the value of every ``jax.value_and_grad`` the JAX package's
    training steps take, in order (it returns the losses to no caller)."""
    losses = []
    value_and_grad = jax.value_and_grad

    def recording(fun, *args, **kwargs):
        vg = value_and_grad(fun, *args, **kwargs)

        def wrapped(*a, **kw):
            val, grad = vg(*a, **kw)
            jax.debug.callback(lambda v: losses.append(float(v)), val,
                               ordered=True)
            return val, grad

        return wrapped

    with mock.patch.object(jax, "value_and_grad", recording):
        yield losses


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_mlp_close(jparams, mlp):
    got = nn_baselines.mlp_to_numpy(mlp)
    assert len(got) == len(jparams)
    for a, b in zip(jparams, got):
        for k in ("w", "b"):
            np.testing.assert_allclose(b[k], np.asarray(a[k]), rtol=0,
                                       atol=PARAM_TOL)


# ---------------------------------------------------------------------------
# NN baselines
# ---------------------------------------------------------------------------

def test_mlp_converter_and_init():
    params = to_numpy(jnn._mlp_init(jax.random.PRNGKey(3), [5, 7, 2]))
    mlp = nn_baselines.mlp_from_jax(params, "cpu")
    x = np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32)
    with torch.no_grad():
        got = mlp(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnn._mlp_apply(params, x)),
                               rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    sizes = [400, 256, 3]
    net = nn_baselines.MLP(sizes, generator=gen)
    for layer, a in zip(net.layers, sizes):
        assert torch.count_nonzero(layer.bias) == 0
        std = layer.weight.std().item() * a ** 0.5     # w ~ a^-0.5 N(0, 1)
        assert 0.9 < std < 1.1
    # the two libraries' exp differ in the last place (1.5e-5 at e^5), and
    # sin / cos of the angle t·e^5 turn that into an absolute difference
    tt = np.linspace(0.0, 1.0, 6).astype(np.float32)
    np.testing.assert_allclose(nn_baselines.time_embed(t(tt)).numpy(),
                               np.asarray(jnn._time_embed(jnp.asarray(tt))),
                               rtol=0, atol=5e-5)


def nn_draws(method, n, batch, p, seed, eps):
    key = jax.random.PRNGKey(seed)
    out = []
    for i in range(STEPS):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, i + 1), 3)
        idx = jax.random.randint(k1, (batch,), 0, n)
        tt = jax.random.uniform(k2, (batch,),
                                minval=eps if method == "diffusion" else 0.0)
        out.append((t(idx), t(tt), t(jax.random.normal(k3, (batch, p)))))
    return out.__getitem__


@pytest.mark.parametrize("method", ["flow", "diffusion"])
def test_nn_generative_model_matches_jax(moons, method):
    X, y = moons
    kw = dict(hidden=32, depth=2, steps=STEPS, batch=64)
    with jax_losses() as losses:
        jm = jnn.NNGenerativeModel(JForestConfig(method=method), **kw)
        jm.fit(X, y, seed=0)
    init = to_numpy(jnn._mlp_init(jax.random.PRNGKey(0),
                                  [2 + 32 + 2, 32, 32, 2]))
    tm = nn_baselines.NNGenerativeModel(ForestConfig(method=method), **kw)
    tm.fit(X, y, seed=0, device="cpu", init=init,
           draws=nn_draws(method, len(X), 64, 2, 0, 1e-3))
    assert_mlp_close(jm.params, tm.net)
    np.testing.assert_allclose(tm.losses, losses, rtol=LOSS_RTOL)
    x1 = jax.random.normal(jax.random.PRNGKey(3 + 11), (50, 2))
    Xj, yj = jm.generate(50, seed=3, n_steps=10)
    Xt, yt = tm.generate(50, seed=3, n_steps=10, x1=np.asarray(x1))
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=GEN_TOL)


def test_tvae_matches_jax(moons):
    X, _ = moons
    kw = dict(latent=4, hidden=32, steps=STEPS, batch=64)
    with jax_losses() as losses:
        jm = jnn.TVAEBaseline(**kw).fit(X, seed=0)
    key = jax.random.PRNGKey(0)
    init = to_numpy({
        "enc": jnn._mlp_init(jax.random.fold_in(key, 0), [2, 32, 8]),
        "dec": jnn._mlp_init(jax.random.fold_in(key, 1), [4, 32, 2])})
    draws = []
    for i in range(STEPS):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i + 1))
        draws.append((t(jax.random.randint(k1, (64,), 0, len(X))),
                      t(jax.random.normal(k2, (64, 4)))))
    tm = nn_baselines.TVAEBaseline(**kw).fit(
        X, seed=0, device="cpu", draws=draws.__getitem__, init=init)
    assert_mlp_close(jm.params["enc"], tm.enc)
    assert_mlp_close(jm.params["dec"], tm.dec)
    np.testing.assert_allclose(tm.losses, losses, rtol=LOSS_RTOL)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (50, 4)))
    np.testing.assert_allclose(tm.generate(50, seed=3, z=z),
                               jm.generate(50, seed=3), rtol=0, atol=GEN_TOL)


def test_ctgan_matches_jax(moons):
    X, y = moons
    kw = dict(latent=8, hidden=32, steps=STEPS, batch=32)
    with jax_losses() as losses:
        jm = jctgan.CTGANBaseline(**kw).fit(X, y, seed=0)
    key = jax.random.PRNGKey(0)
    init = to_numpy({
        "gen": jnn._mlp_init(jax.random.fold_in(key, 0), [8 + 2, 32, 32, 2]),
        "dis": jnn._mlp_init(jax.random.fold_in(key, 1), [2 + 2, 32, 32, 1])})
    draws = []
    for i in range(STEPS):
        kd, kg = jax.random.split(jax.random.fold_in(key, 2 + i))
        step = []
        for k in (kd, kg):
            k1, k2 = jax.random.split(k)
            step += [t(jax.random.randint(k1, (32,), 0, len(X))),
                     t(jax.random.normal(k2, (32, 8)))]
        draws.append(tuple(step))
    tm = ctgan.CTGANBaseline(**kw).fit(X, y, seed=0, device="cpu",
                                       draws=draws.__getitem__, init=init)
    assert_mlp_close(jm.gen, tm.gen)
    # the JAX step takes the discriminator's loss, then the generator's
    np.testing.assert_allclose(tm.d_losses, losses[0::2], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm.g_losses, losses[1::2], rtol=LOSS_RTOL)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(3 + 5), (50, 8)))
    Xj, yj = jm.generate(50, seed=3)
    Xt, yt = tm.generate(50, seed=3, z=z)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=GEN_TOL)


def test_copula_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4)) @ rng.normal(size=(4, 4))
    X[:, 2] = np.round(X[:, 2])                 # ties in the ranks
    got = GaussianCopula().fit(X).generate(300, seed=5)
    want = JCopula().fit(X).generate(300, seed=5)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the Original-style trainer
# ---------------------------------------------------------------------------

def test_naive_trainer_matches_jax():
    X, y = two_moons(60, seed=0)
    kw = dict(method="flow", n_t=2, duplicate_k=4, n_trees=4, max_depth=3,
              n_bins=16, reg_lambda=1.0)
    jm = JNaive(JForestConfig(**kw)).fit(X, y, seed=0)
    tm = NaiveForestGenerativeModel(ForestConfig(**kw)).fit(X, y, seed=0,
                                                            device="cpu")
    assert [k for k, _ in tm.models] == [k for k, _ in jm.models]
    assert len(tm.models) == 2 * 2 * 2
    # the pathologies: float64 X_train [n_t, nK, p] and the stored X1, held
    assert tm._X_train.dtype == np.float64 and tm._X_train.shape == (2, 240, 2)
    np.testing.assert_array_equal(tm._X_train, jm._X_train)
    np.testing.assert_array_equal(tm._X1, jm._X1)
    for (key, a), (_, b) in zip(jm.models, tm.models):
        for f in ("feat", "best_round", "rounds_run"):
            np.testing.assert_array_equal(getattr(b, f), np.asarray(
                getattr(a, f)), err_msg=f"{key} {f}")
        for f in ("thr_val", "leaf", "val_curve"):
            np.testing.assert_allclose(getattr(b, f), np.asarray(
                getattr(a, f)), rtol=1e-5, atol=1e-5, err_msg=f"{key} {f}")


# ---------------------------------------------------------------------------
# the ForestGenerativeModel shim and the per-class loop
# ---------------------------------------------------------------------------

def test_forest_generative_model_shim(moons):
    X, y = moons
    cfg = ForestConfig(n_t=3, duplicate_k=3, n_trees=4, max_depth=3,
                       n_bins=16, early_stop_rounds=2)
    with pytest.warns(DeprecationWarning, match="repro_torch.tabgen"):
        model = ForestGenerativeModel(cfg)
    assert model.forests is None
    model.fit(X, y, seed=0, device="cpu")
    Xg, yg = model.generate(40, seed=1)
    Xs, ys = sample(model.artifacts, 40, seed=1)
    np.testing.assert_array_equal(Xg, Xs)
    np.testing.assert_array_equal(yg, ys)
    art = model.artifacts
    forests = model.forests
    assert set(forests) == {"feat", "thr_val", "leaf", "best_round",
                            "rounds_run", "val_curve"}
    assert forests["leaf"] is model.forests["leaf"]     # read back once
    for k, v in forests.items():
        np.testing.assert_array_equal(v, getattr(art, k).numpy())
    assert (model.n_y, model.p) == (2, 2)
    np.testing.assert_array_equal(model._classes, [0, 1])
    np.testing.assert_array_equal(model._counts, art.counts)
    np.testing.assert_array_equal(model._mins, art.mins.numpy())
    np.testing.assert_array_equal(model._maxs, art.maxs.numpy())
    np.testing.assert_array_equal(
        model.trees_at_best_iteration(),
        np.mean(art.best_round.numpy() + 1, axis=(1, 2)))
    missing = X[:6].copy()
    missing[::2, 0] = np.nan
    filled = model.impute(missing, y[:6], seed=0)
    assert np.isfinite(filled).all()
    np.testing.assert_array_equal(filled[1::2], missing[1::2])
    from repro_torch.core import forest_flow
    assert forest_flow.weighted_edges is weighted_edges
    public = {a for a in dir(JShim) if not a.startswith("__")}
    assert public <= set(dir(ForestGenerativeModel))


@pytest.mark.parametrize("sampler", [None, "heun"])
def test_sample_loop_reference_matches_jax(moons, sampler):
    X, y = moons
    cfg = JForestConfig(n_t=4, duplicate_k=3, n_trees=3, max_depth=3,
                        n_bins=16)
    jart = j_fit(X, y, cfg, seed=0)
    arrays = {k: np.asarray(getattr(jart, k)) for k in (
        "feat", "thr_val", "leaf", "best_round", "rounds_run", "val_curve",
        "mins", "maxs", "classes", "counts")}
    tart = artifacts_from_numpy(arrays, dataclasses.asdict(cfg), "cpu")
    n, seed = 37, 2
    # the JAX loop's x1: key PRNGKey(seed + 7), split three ways per class
    labels = j_sample_labels(np.asarray(jart.counts), n,
                             np.random.default_rng(seed), cfg.label_sampler)
    key, x1s = jax.random.PRNGKey(seed + 7), {}
    for yi in range(jart.n_y):
        n_c = int((labels == yi).sum())
        key, k1, _ = jax.random.split(key, 3)
        x1s[yi] = t(jax.random.normal(k1, (n_c, jart.p), jnp.float32))
    Xj, yj = j_loop(jart, n, seed=seed, sampler=sampler)
    Xt, yt = sample_loop_reference(tart, n, seed=seed, sampler=sampler,
                                   x1=lambda yi, shape: x1s[yi])
    assert Xt.dtype == Xj.dtype == np.float64 and Xt.shape == (n, 2)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-5)
    X2, y2 = sample_loop_reference(tart, n, seed=seed, sampler=sampler)
    assert X2.shape == (n, 2) and np.isfinite(X2).all()
    np.testing.assert_array_equal(y2, yt)
