"""NN-backed baselines sharing the same interpolants as the forest models.

* :class:`NNGenerativeModel` — an MLP vector field trained on the identical
  CFM / score-matching losses (STaSy / TabDDPM-style, minibatched like NNs
  are); the apples-to-apples NN-vs-forest comparison the paper draws.
* :class:`TVAEBaseline` — a small tabular VAE (ELBO with Gaussian decoder).

The PyTorch twins of ``repro.core.nn_baselines``: the same losses, the same
optimizer (:class:`repro_torch.train.optim.AdamW`, the JAX package's AdamW)
and the same solvers. The layers are ``nn.Linear`` (cuBLAS on the card)
with SiLU between them, initialised as the JAX package's ``_mlp_init``
does: ``w ~ in**-0.5 · N(0, 1)``, ``b = 0``.

Both consume and emit numpy. ``fit`` and ``generate`` run on ``device``
(``None``: the GPU, or raise; ``"cpu"``: the host). Noise comes from seeded
``torch.Generator`` s on that device; the parity tests hand the JAX
package's draws over instead: ``fit(draws=)`` is called as ``draws(step)``
and returns that step's tensors, ``fit(init=)`` takes the JAX package's
parameter lists (numpy), and ``generate`` takes its initial noise.
Labels in ``generate`` come from ``np.random.default_rng(seed)`` as in the
JAX package, so both give the same labels.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.config import ForestConfig, TrainConfig
from repro_torch.core import interpolants as itp
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.train.optim import AdamW

Draws = Callable[[int], tuple]


class MLP(nn.Module):
    """``nn.Linear`` layers with SiLU between them (none after the last)."""

    def __init__(self, sizes: Sequence[int], *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        device = torch.device("cpu") if device is None else device
        # skip_init: nn.Linear's own init would draw from the global RNG
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, a, b, device=device)
            for a, b in zip(sizes[:-1], sizes[1:]))
        if generator is not None:
            with torch.no_grad():
                for layer, a, b in zip(self.layers, sizes[:-1], sizes[1:]):
                    w = torch.randn((a, b), generator=generator,
                                    device=device) * a ** -0.5
                    layer.weight.copy_(w.T)
                    layer.bias.zero_()

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i + 1 < len(self.layers):
                x = nn.functional.silu(x)
        return x


def mlp_from_jax(params, device: Optional[Device] = None) -> MLP:
    """An :class:`MLP` holding the JAX package's ``[{"w": [in, out], "b":
    [out]}, …]`` (numpy or JAX arrays); ``w`` becomes ``weight`` transposed."""
    device = resolve_device(device)
    ws = [np.asarray(layer["w"], np.float32) for layer in params]
    sizes = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    mlp = MLP(sizes, device=device)
    with torch.no_grad():
        for layer, w, src in zip(mlp.layers, ws, params):
            layer.weight.copy_(torch.tensor(w.T))
            layer.bias.copy_(torch.tensor(np.asarray(src["b"], np.float32)))
    return mlp


def mlp_to_numpy(mlp: MLP):
    """The JAX package's parameter layout of ``mlp``, as numpy."""
    return [{"w": layer.weight.detach().T.cpu().numpy(),
             "b": layer.bias.detach().cpu().numpy()} for layer in mlp.layers]


def as_f32(a, device) -> torch.Tensor:
    """A tensor or array (numpy, JAX) as an f32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


def time_embed(t, dim: int = 32):
    """Sinusoidal embedding ``[n, dim]`` of times ``t`` ``[n]``."""
    freqs = torch.exp(itp._linspace(0.0, 5.0, dim // 2)).to(t.device)
    ang = t[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def scaler(X: np.ndarray):
    """``(mins, maxs, span)`` of the columns; a constant column spans 1."""
    mins, maxs = X.min(0), X.max(0)
    return mins, maxs, np.where(maxs > mins, maxs - mins, 1.0)


def seeded(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def one_hot(y_idx: np.ndarray, n_y: int, device) -> torch.Tensor:
    return nn.functional.one_hot(torch.from_numpy(np.asarray(y_idx)).to(
        device, torch.long), n_y).to(torch.float32)


def sample_label_idx(counts: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Sorted class indices of ``n`` rows, drawn as the JAX package draws
    them."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(len(counts), size=n, p=counts / counts.sum()))


class NNGenerativeModel:
    """MLP vector field trained on the same CFM / score losses."""

    def __init__(self, fcfg: ForestConfig, hidden: int = 256, depth: int = 3,
                 steps: int = 2000, batch: int = 256, lr: float = 1e-3):
        self.fcfg = fcfg
        self.hidden, self.depth = hidden, depth
        self.steps, self.batch, self.lr = steps, batch, lr

    def fit(self, X, y=None, *, seed: int = 0,
            device: Optional[Device] = None, draws: Optional[Draws] = None,
            init=None):
        """``draws(step) -> (idx [batch], t [batch], x1 [batch, p])``;
        ``init``: the JAX package's parameter list."""
        device = resolve_device(device)
        X = np.asarray(X, np.float32)
        n, p = X.shape
        self._mins, self._maxs, self._span = scaler(X)
        Xs = (X - self._mins) / self._span * 2 - 1
        if y is None:
            y = np.zeros((n,), np.int64)
        self._classes, y_idx = np.unique(y, return_inverse=True)
        n_y = len(self._classes)
        self.p, self.n_y = p, n_y
        self._counts = np.bincount(y_idx, minlength=n_y)

        gen = seeded(seed, device)
        sizes = [p + 32 + n_y] + [self.hidden] * self.depth + [p]
        self.net = (MLP(sizes, generator=gen, device=device) if init is None
                    else mlp_from_jax(init, device))
        opt = AdamW(self.net.parameters(), TrainConfig(
            learning_rate=self.lr, warmup_steps=50, total_steps=self.steps,
            weight_decay=0.0, grad_clip=1.0))
        Xd = torch.from_numpy(Xs).to(device)
        yd = one_hot(y_idx, n_y, device)
        fcfg = self.fcfg
        t_lo = fcfg.eps_diff if fcfg.method == "diffusion" else 0.0

        def draw(step):
            if draws is not None:
                return tuple(a.to(device) for a in draws(step))
            idx = torch.randint(0, n, (self.batch,), generator=gen,
                                device=device)
            u = torch.rand((self.batch,), generator=gen, device=device)
            x1 = torch.randn((self.batch, p), generator=gen, device=device)
            return idx, t_lo + (1.0 - t_lo) * u, x1

        losses = []
        for i in range(self.steps):
            idx, t, x1 = draw(i)
            x0, yo = Xd[idx], yd[idx]
            xt, tgt = itp.make_xt_target(fcfg.method, x0, x1, t[:, None])
            # scale score targets so the regression is O(1) (precondition)
            if fcfg.method == "diffusion":
                _, sig = itp.vp_alpha_sigma(t)
                tgt = tgt * sig[:, None]
            out = self.net(torch.cat([xt, time_embed(t), yo], dim=-1))
            loss = torch.mean(torch.square(out - tgt))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        self.losses = torch.stack(losses).cpu().numpy() if losses else None
        self.device = device
        return self

    def _field(self, x, t, y_onehot):
        tt = t.expand(x.shape[0])
        out = self.net(torch.cat([x, time_embed(tt), y_onehot], dim=-1))
        if self.fcfg.method == "diffusion":
            _, sig = itp.vp_alpha_sigma(t)
            out = out / sig
        return out

    @torch.no_grad()
    def generate(self, n: int, *, seed: int = 0, n_steps: int = 50,
                 x1=None):
        """``n`` rows and their labels; ``x1`` ``[n, p]`` is the initial
        noise (drawn from a generator seeded ``seed + 11`` if not given)."""
        device = self.device
        y_idx = sample_label_idx(self._counts, n, seed)
        yo = one_hot(y_idx, self.n_y, device)
        if x1 is None:
            x = torch.randn((n, self.p), generator=seeded(seed + 11, device),
                            device=device)
        else:
            x = as_f32(x1, device)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        fcfg = self.fcfg
        if fcfg.method == "flow":
            h = 1.0 / (n_steps - 1)
            for t in np.linspace(1.0, h, n_steps - 1):
                x = x - h * self._field(x, f32(np.float32(t)), yo)
        else:
            ts = itp.timesteps("diffusion", n_steps, fcfg.eps_diff,
                               device=device).flip(0)
            for t_now, t_next in zip(ts[:-1], ts[1:]):
                a_now, s_now = itp.vp_alpha_sigma(t_now)
                a_next, s_next = itp.vp_alpha_sigma(t_next)
                score = self._field(x, t_now, yo)
                eps_hat = -s_now * score
                x0_hat = torch.clamp((x - s_now * eps_hat) / a_now, -1.5, 1.5)
                eps_hat = (x - a_now * x0_hat) / s_now
                x = a_next * x0_hat + s_next * eps_hat
        X = (x.cpu().numpy() + 1) / 2 * self._span + self._mins
        return X, self._classes[y_idx]


class TVAEBaseline:
    """Small tabular VAE (Gaussian encoder/decoder), TVAE-style."""

    def __init__(self, latent: int = 8, hidden: int = 128, steps: int = 1500,
                 batch: int = 256, lr: float = 1e-3):
        self.latent, self.hidden = latent, hidden
        self.steps, self.batch, self.lr = steps, batch, lr

    def fit(self, X, y=None, *, seed: int = 0,
            device: Optional[Device] = None, draws: Optional[Draws] = None,
            init=None):
        """``draws(step) -> (idx [batch], eps [batch, latent])``; ``init``:
        the JAX package's ``{"enc": […], "dec": […]}``. ``y`` is ignored."""
        device = resolve_device(device)
        X = np.asarray(X, np.float32)
        n, p = X.shape
        self.p = p
        self._mins, self._maxs, self._span = scaler(X)
        Xs = (X - self._mins) / self._span * 2 - 1
        gen = seeded(seed, device)
        if init is None:
            self.enc = MLP([p, self.hidden, 2 * self.latent], generator=gen,
                           device=device)
            self.dec = MLP([self.latent, self.hidden, p], generator=gen,
                           device=device)
        else:
            self.enc = mlp_from_jax(init["enc"], device)
            self.dec = mlp_from_jax(init["dec"], device)
        opt = AdamW(list(self.enc.parameters()) + list(self.dec.parameters()),
                    TrainConfig(learning_rate=self.lr, warmup_steps=50,
                                total_steps=self.steps, weight_decay=0.0))
        Xd = torch.from_numpy(Xs).to(device)

        def draw(step):
            if draws is not None:
                return tuple(a.to(device) for a in draws(step))
            idx = torch.randint(0, n, (self.batch,), generator=gen,
                                device=device)
            return idx, torch.randn((self.batch, self.latent), generator=gen,
                                    device=device)

        losses = []
        for i in range(self.steps):
            idx, eps = draw(i)
            x = Xd[idx]
            h = self.enc(x)
            mu, logvar = h[:, :self.latent], h[:, self.latent:]
            z = mu + torch.exp(0.5 * logvar) * eps
            xr = self.dec(z)
            rec = torch.mean(torch.sum(torch.square(xr - x), -1))
            kl = -0.5 * torch.mean(torch.sum(1 + logvar - mu ** 2
                                             - torch.exp(logvar), -1))
            loss = rec + 0.1 * kl
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        self.losses = torch.stack(losses).cpu().numpy() if losses else None
        self.device = device
        return self

    @torch.no_grad()
    def generate(self, n: int, *, seed: int = 0, z=None):
        """``n`` rows decoded from latents ``z`` ``[n, latent]`` (drawn from
        a generator seeded ``seed`` if not given)."""
        device = self.device
        if z is None:
            z = torch.randn((n, self.latent), generator=seeded(seed, device),
                            device=device)
        x = self.dec(as_f32(z, device))
        x = x.cpu().numpy()
        return ((x + 1) / 2 * self._span + self._mins).astype(np.float32)
