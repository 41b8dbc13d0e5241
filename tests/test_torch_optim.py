"""The port's AdamW (``repro_torch.train.optim``) against the JAX package's
(``repro.train.optim``) on the same parameters and gradients.

Twelve steps of a small parameter tree cover the warmup (4 steps), the
cosine part and the floor after ``total_steps``; clipping on (a clip below
the gradients' norm), off (``grad_clip = 0``) and at the default; fp32 and
bf16 moments. Parameters, moments and the learning rate agree within 1e-6;
the gradient norm within 1e-6 relative (it sums the same squares in
another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.train import optim as jopt
from repro_torch.config import TrainConfig
from repro_torch.train import optim as topt

SHAPES = [(3, 4), (4,), (5, 2)]


def test_train_config_is_a_field_for_field_copy():
    assert ([(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(JTrainConfig)])
    cfg = TrainConfig()
    assert (cfg.beta2, cfg.eps, cfg.grad_clip, cfg.warmup_steps) == (
        0.95, 1e-8, 1.0, 100)


def test_lr_schedule_matches_jax():
    kw = dict(learning_rate=1e-2, warmup_steps=4, total_steps=10)
    for step in range(0, 14):
        want = float(jopt.lr_schedule(jnp.int32(step), JTrainConfig(**kw)))
        got = topt.lr_schedule(torch.tensor(step, dtype=torch.int32),
                               TrainConfig(**kw))
        assert got.dtype == torch.float32
        assert abs(got.item() - want) <= 1e-9, step


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0, 0.05])
def test_adamw_update_matches_jax(grad_clip, moments):
    rng = np.random.default_rng(0)
    kw = dict(learning_rate=1e-2, warmup_steps=4, total_steps=10,
              weight_decay=0.1, grad_clip=grad_clip)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.tensor(p) for p in params]
    jo = jopt.init_opt_state(jp, getattr(jnp, moments))
    to = topt.init_opt_state(tp, getattr(torch, moments))
    for i in range(12):
        # large and small gradients in turns: clipping bites on some steps
        grads = [rng.normal(size=s).astype(np.float32) * (0.3 if i % 2 else 3)
                 for s in SHAPES]
        jp, jo, jm = jopt.adamw_update([jnp.asarray(g) for g in grads], jo,
                                       jp, jcfg)
        tp, to, tm = topt.adamw_update([torch.tensor(g) for g in grads], to,
                                       tp, tcfg)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        assert abs(tm["lr"].item() - float(jm["lr"])) <= 1e-6
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)
        for key in ("m", "v"):
            for a, b in zip(jo[key], to[key]):
                assert b.dtype == getattr(torch, moments)
                np.testing.assert_allclose(
                    b.float().numpy(), np.asarray(a, np.float32), rtol=0,
                    atol=1e-6)


def test_optimizer_step_applies_adamw_update_in_place():
    """``AdamW.step()`` on a module's parameters equals the functional
    update; a parameter without a gradient counts as a zero gradient."""
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 2)
    unused = torch.nn.Parameter(torch.ones(4))
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6)
    params = [p.detach().clone() for p in (*net.parameters(), unused)]
    state = topt.init_opt_state(params)
    opt = topt.AdamW([*net.parameters(), unused], cfg)
    x = torch.randn(5, 3)
    for _ in range(4):
        opt.zero_grad(set_to_none=True)
        net(x).square().mean().backward()
        grads = [p.grad.clone() for p in net.parameters()]
        grads.append(torch.zeros(4))
        params, state, want = topt.adamw_update(grads, state, params, cfg)
        got = opt.step()
        assert torch.equal(got["lr"], want["lr"])
        for p, q in zip((*net.parameters(), unused), params):
            assert torch.equal(p.detach(), q)
    assert not torch.equal(unused.detach(), torch.ones(4))   # decayed
