"""CTGAN-style conditional tabular GAN baseline (paper Table 2, [95]).

The PyTorch twin of ``repro.core.ctgan``: MLP generator and discriminator,
the class one-hot as condition, the non-saturating GAN loss with an R1
gradient penalty on real rows (``torch.autograd.grad(...,
create_graph=True)``). Each step updates the discriminator first, then the
generator against the *updated* discriminator; both train with the JAX
package's AdamW (betas 0.5 / 0.9, 20 warmup steps). Sized for the
benchmark-suite comparison role, not for SOTA GAN training.

``fit(draws=)`` is called as ``draws(step)`` and returns ``(d_idx, d_z,
g_idx, g_z)``: the discriminator's and the generator's row indices and
latents of that step; ``fit(init=)`` takes the JAX package's ``{"gen": […],
"dis": […]}`` parameter lists; ``generate(z=)`` takes the latents.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.config import TrainConfig
from repro_torch.core.nn_baselines import (MLP, Draws, as_f32,
                                           mlp_from_jax, one_hot,
                                           sample_label_idx, scaler, seeded)
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.train.optim import AdamW


class CTGANBaseline:
    def __init__(self, latent: int = 32, hidden: int = 128,
                 steps: int = 2000, batch: int = 128, lr: float = 2e-4):
        self.latent, self.hidden = latent, hidden
        self.steps, self.batch, self.lr = steps, batch, lr

    def fit(self, X, y=None, *, seed: int = 0,
            device: Optional[Device] = None, draws: Optional[Draws] = None,
            init=None):
        device = resolve_device(device)
        X = np.asarray(X, np.float32)
        n, p = X.shape
        self.p = p
        self._mins, self._maxs, self._span = scaler(X)
        Xs = (X - self._mins) / self._span * 2 - 1
        if y is None:
            y = np.zeros((n,), np.int64)
        self._classes, y_idx = np.unique(y, return_inverse=True)
        n_y = len(self._classes)
        self.n_y = n_y
        self._counts = np.bincount(y_idx, minlength=n_y)

        gen = seeded(seed, device)
        if init is None:
            self.gen = MLP([self.latent + n_y, self.hidden, self.hidden, p],
                           generator=gen, device=device)
            self.dis = MLP([p + n_y, self.hidden, self.hidden, 1],
                           generator=gen, device=device)
        else:
            self.gen = mlp_from_jax(init["gen"], device)
            self.dis = mlp_from_jax(init["dis"], device)
        tcfg = TrainConfig(learning_rate=self.lr, warmup_steps=20,
                           total_steps=self.steps, weight_decay=0.0,
                           beta1=0.5, beta2=0.9)
        g_opt = AdamW(self.gen.parameters(), tcfg)
        d_opt = AdamW(self.dis.parameters(), tcfg)
        Xd = torch.from_numpy(Xs).to(device)
        yd = one_hot(y_idx, n_y, device)

        def draw(step):
            if draws is not None:
                return tuple(a.to(device) for a in draws(step))
            out = []
            for _ in range(2):
                out.append(torch.randint(0, n, (self.batch,), generator=gen,
                                         device=device))
                out.append(torch.randn((self.batch, self.latent),
                                       generator=gen, device=device))
            return tuple(out)

        def fake_rows(z, cond):
            return torch.tanh(self.gen(torch.cat([z, cond], -1)))

        d_losses, g_losses = [], []
        for i in range(self.steps):
            d_idx, d_z, g_idx, g_z = draw(i)
            # discriminator
            real = Xd[d_idx].requires_grad_(True)
            cond = yd[d_idx]
            with torch.no_grad():
                fake = fake_rows(d_z, cond)
            d_real = self.dis(torch.cat([real, cond], -1))
            d_fake = self.dis(torch.cat([fake, cond], -1))
            # R1 penalty on real data
            grad, = torch.autograd.grad(d_real.sum(), real, create_graph=True)
            d_loss = (torch.mean(F.softplus(-d_real))
                      + torch.mean(F.softplus(d_fake))
                      + 1.0 * torch.mean(torch.sum(grad ** 2, -1)))
            d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            d_opt.step()
            # generator, against the updated discriminator
            cond = yd[g_idx]
            g_loss = torch.mean(F.softplus(
                -self.dis(torch.cat([fake_rows(g_z, cond), cond], -1))))
            g_opt.zero_grad(set_to_none=True)
            g_loss.backward()
            g_opt.step()
            d_losses.append(d_loss.detach())
            g_losses.append(g_loss.detach())
        if self.steps:
            self.d_losses = torch.stack(d_losses).cpu().numpy()
            self.g_losses = torch.stack(g_losses).cpu().numpy()
        self.dis.zero_grad(set_to_none=True)
        self.device = device
        return self

    @torch.no_grad()
    def generate(self, n: int, *, seed: int = 0, z=None):
        """``n`` rows and their labels from latents ``z`` ``[n, latent]``
        (drawn from a generator seeded ``seed + 5`` if not given)."""
        device = self.device
        y_idx = sample_label_idx(self._counts, n, seed)
        cond = one_hot(y_idx, self.n_y, device)
        if z is None:
            z = torch.randn((n, self.latent),
                            generator=seeded(seed + 5, device), device=device)
        x = torch.tanh(self.gen(torch.cat([as_f32(z, device), cond], -1)))
        x = x.cpu().numpy()
        return ((x + 1) / 2 * self._span + self._mins).astype(np.float32), \
            self._classes[y_idx]
