"""The port's recurrent blocks (``repro_torch.models.recurrent``: the scans,
the temporal conv, RG-LRU, mLSTM, sLSTM) against the JAX package's
``repro.models.recurrent``, on the CPU.

Inputs come from numpy generators with fixed seeds; weights are the JAX
package's initialisations carried across. The scans are bit-equal to
``jax.lax.associative_scan`` run op by op (the port follows its recursion;
under ``jit`` XLA fuses the multiply-add, which moves the last place).
Everything else runs the JAX side under ``jit`` (one compile instead of
one per op) and is held to 1e-5 of the largest entry of what it is
compared with: both sides compute in fp32 and differ only in the two
libraries' ``exp`` / ``log`` / ``tanh``, fused multiply-adds and the order
of a matrix product's sums. One case is held another way: a 256-step
mLSTM chunk with N(0, 1) gates, where fp32 itself lands ~1e-5 of the
largest output from the float64 result in both packages, so the port is
held to a float64 copy of itself no farther than the JAX package is.
"""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from repro_torch.models import recurrent as rec

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs diff {err} > {tol} x {scale}"


def load(module, tree):
    """Copy a JAX parameter dict into the port's module of the same
    names."""
    with torch.no_grad():
        for name, value in tree.items():
            if isinstance(value, dict):
                load(getattr(module, name), value)
            else:
                getattr(module, name).copy_(t(value))
    return module


def states_close(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for name in want:
        close(got[name].float(), np.asarray(want[name], np.float32), tol)


D, W, H, K = 32, 48, 4, 4


def rglru_pair(seed=0):
    tree = jrec.init_rglru_block(jax.random.PRNGKey(seed), D, W, K)
    return tree, load(rec.init_rglru_block(torch.Generator(), D, W, K), tree)


def mlstm_pair(seed=1):
    tree = jrec.init_mlstm_block(jax.random.PRNGKey(seed), D, W, H, K)
    return tree, load(rec.init_mlstm_block(torch.Generator(), D, W, H, K),
                      tree)


def slstm_pair(seed=2):
    tree = jrec.init_slstm_block(jax.random.PRNGKey(seed), D, H)
    return tree, load(rec.init_slstm_block(torch.Generator(), D, H), tree)


def jax_run(fn, *args, **static):
    """``fn(*args, **static)``, compiled once by ``jax.jit``."""
    compiled = jax.jit(functools.partial(fn, **static))
    return compiled(*args)


def normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# scans and the conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 37])
def test_scans_equal_jax_bit_for_bit(n):
    """Lengths that are not powers of two take the odd branch of the
    recursion (37 at two of its five levels, 7 at both of its two); 1
    returns the input."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 1)).astype(np.float32)
    b = rng.normal(size=(2, n, 3, 5)).astype(np.float32)
    want = jrec._linear_scan(jnp.asarray(a), jnp.asarray(b))
    got = rec._linear_scan(t(a), t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f = np.log(rng.uniform(0.1, 1.0, (2, n, 3))).astype(np.float32)
    i = rng.normal(size=(2, n, 3)).astype(np.float32)
    want = jrec._maxplus_scan(jnp.asarray(f), jnp.asarray(i))
    got = rec._maxplus_scan(t(f), t(i))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scan_is_the_recurrence():
    a = np.random.default_rng(3).uniform(0.5, 1.0, (1, 37)).astype(np.float32)
    b = normal((1, 37), 4)
    h, want = 0.0, []
    for at, bt in zip(a[0].astype(np.float64), b[0].astype(np.float64)):
        h = at * h + bt
        want.append(h)
    close(rec._linear_scan(t(a), t(b))[0], np.array(want), 1e-6)


def test_causal_conv1d_and_its_decode_match_jax():
    tree, p = rglru_pair()
    x = normal((2, 9, W), 5)
    close(rec.causal_conv1d(p.conv, t(x)).detach(),
          jax_run(jrec.causal_conv1d, tree["conv"], jnp.asarray(x)))
    state, x_new = normal((2, K - 1, W), 6), normal((2, W), 7)
    want, want_state = jax_run(jrec.conv1d_decode, tree["conv"],
                               jnp.asarray(x_new), jnp.asarray(state))
    got, got_state = rec.conv1d_decode(p.conv, t(x_new), t(state))
    close(got.detach(), want)
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


# ---------------------------------------------------------------------------
# the blocks, full sequence and decode
# ---------------------------------------------------------------------------

def test_rglru_block_matches_jax():
    tree, p = rglru_pair()
    x = normal((2, 30, D), 8)
    want, want_state = jax_run(jrec.apply_rglru_block, tree, jnp.asarray(x),
                               return_state=True)
    s0 = {"h": normal((2, W), 9), "conv": normal((2, K - 1, W), 10)}
    xd = normal((2, 1, D), 11)
    want_d, want_dstate = jax_run(
        jrec.apply_rglru_decode, tree, jnp.asarray(xd),
        {k: jnp.asarray(v) for k, v in s0.items()})
    with torch.no_grad():
        got, state = rec.apply_rglru_block(p, t(x), return_state=True)
        got_d, dstate = rec.apply_rglru_decode(
            p, t(xd), {k: t(v) for k, v in s0.items()})
    close(got, want)
    states_close(state, want_state)
    close(got_d, want_d)
    states_close(dstate, want_dstate)


def mlstm_inputs(s, seed=12):
    q, k, v = (normal((2, H, s, 12), seed + j) for j in range(3))
    i_t = normal((2, H, s), seed + 3)
    f_t = np.log(np.random.default_rng(seed + 4).uniform(0.5, 1.0, (2, H, s))
                 ).astype(np.float32)
    return q, k, v, i_t, f_t


def mlstm_sequence_f64(*args, chunk):
    """The port's ``mlstm_sequence`` with every float32 in float64."""
    src = inspect.getsource(rec._mlstm_chunks)
    src = src.replace("torch.float32", "torch.float64").replace(
        ".float()", ".double()")
    space = dict(vars(rec))
    exec(src, space)
    return space["_mlstm_chunks"](*(a.double() for a in args), chunk, False)


@pytest.mark.parametrize("s,chunk", [(40, 16), (8, 256)])
def test_mlstm_sequence_matches_jax(s, chunk):
    """40 / 16 pads the last of three chunks (input gates -1e30)."""
    args = mlstm_inputs(s)
    want, want_state = jax_run(jrec.mlstm_sequence, *map(jnp.asarray, args),
                               chunk=chunk, return_state=True)
    got, state = rec.mlstm_sequence(*map(t, args), chunk=chunk,
                                    return_state=True)
    close(got, want)
    states_close(state, want_state)


def test_mlstm_long_chunk_is_as_close_to_float64_as_jax():
    """300 steps at the published chunk of 256 (the second padded): fp32
    lands ~1e-5 of the largest output from float64 in both packages here,
    so the port is held to the float64 result no farther than 1.5x the JAX
    package's distance, and to the JAX package within 1e-4."""
    args = mlstm_inputs(300)
    want = np.asarray(jax_run(jrec.mlstm_sequence, *map(jnp.asarray, args),
                              chunk=256))
    got = rec.mlstm_sequence(*map(t, args), chunk=256).numpy()
    exact = mlstm_sequence_f64(*map(t, args), chunk=256).numpy()
    port_err = np.abs(got - exact).max()
    jax_err = np.abs(want - exact).max()
    assert port_err <= 1.5 * jax_err
    close(got, want, 1e-4)


def test_mlstm_rows_with_no_mass_give_zero_not_nan():
    """Input gates at the -1e30 sentinel: the stabiliser stays at -1e30,
    max(|den|, exp(-m)) is inf and the row is 0, as in the reference."""
    q, k, v = (normal((1, 2, 20, 8), seed) for seed in (17, 18, 19))
    i_t = normal((1, 2, 20), 20)
    i_t[..., :6] = -1e30
    f_t = np.full((1, 2, 20), -0.1, np.float32)
    args = (q, k, v, i_t, f_t)
    want = np.asarray(jax_run(jrec.mlstm_sequence, *map(jnp.asarray, args),
                              chunk=8))
    got = rec.mlstm_sequence(*map(t, args), chunk=8).numpy()
    assert np.isfinite(got).all() and not got[..., :6, :].any()
    assert not want[..., :6, :].any()
    close(got, want)


def test_mlstm_decode_matches_jax():
    q, k, v = (normal((2, H, 12), seed) for seed in (21, 22, 23))
    i_t, f_t = normal((2, H), 24), -np.abs(normal((2, H), 25))
    s0 = {"C": normal((2, H, 12, 12), 26), "n": normal((2, H, 12), 27),
          "m": normal((2, H), 28)}
    want, want_state = jax_run(
        jrec.mlstm_decode, *map(jnp.asarray, (q, k, v, i_t, f_t)),
        {n: jnp.asarray(a) for n, a in s0.items()})
    got, state = rec.mlstm_decode(*map(t, (q, k, v, i_t, f_t)),
                                  {n: t(a) for n, a in s0.items()})
    close(got, want)
    states_close(state, want_state)


def block_and_decode(jseq, jdec, seq, dec, tree, p, x, xd):
    """Both packages' sequence form over x (with its state), then one
    decode step from that state; the decode's inputs are the JAX
    package's own state."""
    want, want_state = jseq(tree, jnp.asarray(x))
    want_d, want_dstate = jdec(tree, jnp.asarray(xd), want_state)
    with torch.no_grad():
        got, state = seq(p, t(x), return_state=True)
        close(got, want)
        states_close(state, want_state)
        got_d, dstate = dec(p, t(xd), {n: t(a) for n, a in
                                       want_state.items()})
    close(got_d, want_d)
    states_close(dstate, want_dstate)


def test_mlstm_block_matches_jax():
    tree, p = mlstm_pair()
    block_and_decode(
        functools.partial(jax_run, jrec.apply_mlstm_block, n_heads=H,
                          chunk=16, return_state=True),
        functools.partial(jax_run, jrec.apply_mlstm_decode, n_heads=H),
        functools.partial(rec.apply_mlstm_block, n_heads=H, chunk=16),
        functools.partial(rec.apply_mlstm_decode, n_heads=H),
        tree, p, normal((2, 40, D), 29), normal((2, 1, D), 30))


def test_slstm_block_matches_jax():
    tree, p = slstm_pair()
    block_and_decode(
        functools.partial(jax_run, jrec.apply_slstm_block, n_heads=H,
                          return_state=True),
        functools.partial(jax_run, jrec.apply_slstm_decode, n_heads=H),
        functools.partial(rec.apply_slstm_block, n_heads=H),
        functools.partial(rec.apply_slstm_decode, n_heads=H),
        tree, p, normal((2, 33, D), 31), normal((2, 1, D), 32))


# block: (pair, the port's sequence form, its decode, the JAX sequence form)
BLOCKS = {
    "rglru": (rglru_pair, rec.apply_rglru_block, rec.apply_rglru_decode,
              jrec.apply_rglru_block),
    "mlstm": (mlstm_pair,
              functools.partial(rec.apply_mlstm_block, n_heads=H, chunk=8),
              functools.partial(rec.apply_mlstm_decode, n_heads=H),
              functools.partial(jrec.apply_mlstm_block, n_heads=H, chunk=8)),
    "slstm": (slstm_pair, functools.partial(rec.apply_slstm_block, n_heads=H),
              functools.partial(rec.apply_slstm_decode, n_heads=H),
              functools.partial(jrec.apply_slstm_block, n_heads=H)),
}
INIT_STATES = {
    "rglru": (lambda: rec.rglru_init_state(1, W, K, torch.bfloat16),
              lambda: jrec.rglru_init_state(1, W, K, jnp.bfloat16)),
    "mlstm": (lambda: rec.mlstm_init_state(1, W, H, K),
              lambda: jrec.mlstm_init_state(1, W, H, K)),
    "slstm": (lambda: rec.slstm_init_state(1, D, H),
              lambda: jrec.slstm_init_state(1, D, H)),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_decode_steps_continue_the_sequence(block):
    """The sequence form over 21 steps = the sequence form over 17 then 4
    decode steps from its state (the chunked mLSTM over three chunks)."""
    pair, seq, dec, _ = BLOCKS[block]
    _, p = pair()
    x = t(normal((2, 21, D), 33))
    with torch.no_grad():
        full = seq(p, x)
        y, state = seq(p, x[:, :17], return_state=True)
        outs = [y]
        for i in range(17, 21):
            y, state = dec(p, x[:, i:i + 1], state)
            outs.append(y)
    close(torch.cat(outs, dim=1), full.numpy())


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_bf16_states_keep_the_references_dtypes(block):
    """h, C, n, m (and the sLSTM cell c) fp32; RG-LRU's conv state in the
    compute dtype, mLSTM's in fp32, as the JAX package keeps them; the
    initial states equal."""
    pair, seq, _, jseq = BLOCKS[block]
    tree, p = pair()
    x = normal((1, 9, D), 34)
    with torch.no_grad():
        _, state = seq(p, t(x).bfloat16(), return_state=True)
    _, want = jax_run(jseq, tree, jnp.asarray(x, jnp.bfloat16),
                      return_state=True)
    assert sorted(state) == sorted(want)
    for name, leaf in want.items():
        assert str(state[name].dtype)[6:] == str(leaf.dtype), name
    init, jinit = (f() for f in INIT_STATES[block])
    for name, leaf in jinit.items():
        assert str(init[name].dtype)[6:] == str(leaf.dtype), name
        np.testing.assert_array_equal(init[name].float().numpy(),
                                      np.asarray(leaf, np.float32))


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_gradients_match_jax(block):
    """The gradient of sum(y^2) through each block (the scans' and the
    chunked mLSTM's backward) to its input and every weight."""
    pair, seq, _, jseq = BLOCKS[block]
    tree, p = pair()
    x = normal((2, 13, D), 35)

    def jloss(tr, xx):
        return jnp.sum(jseq(tr, xx) ** 2)

    want_p, want_x = jax_run(jax.grad(jloss, argnums=(0, 1)), tree,
                             jnp.asarray(x))
    xt = t(x).requires_grad_()
    (seq(p, xt) ** 2).sum().backward()
    close(xt.grad, want_x)
    flat = jax.tree_util.tree_flatten_with_path(want_p)[0]
    assert len(flat) == len(list(p.parameters()))
    for path, want in flat:
        node = p
        for key in path:
            node = getattr(node, key.key)
        close(node.grad, want)
