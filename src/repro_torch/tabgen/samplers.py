"""Sampler registry: named ODE/SDE solvers behind one calling convention.

The same names, interpolant families and ``stochastic`` flags as
``repro.tabgen.samplers``. Unified signature (extra keywords may be ignored):

    fn(x1, forests, *, depth, n_t, ts, eps, noise, generator) -> x0

``x1`` is ``[n_y, m, p]`` and ``forests`` a :class:`PackedForest` with
arrays ``[n_t, n_y, ...]``. A stochastic solver takes its noise from
``noise`` (an explicit tensor, as the parity tests pass it) or else from the
``torch.Generator`` ``generator``; ``noise`` may also be a callable
``noise(k)`` giving step k's draw (the sharded solve passes one).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

from repro_torch.core import generate as G


class SamplerSpec(NamedTuple):
    fn: Callable            # unified-signature solver
    method: str             # "flow" | "diffusion" — interpolant it solves
    stochastic: bool        # draws noise at each step


_REGISTRY: Dict[str, SamplerSpec] = {}


def register_sampler(name: str, *, method: str, stochastic: bool = False):
    """Decorator: register ``fn`` under ``name``. Last registration wins."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = SamplerSpec(fn, method, stochastic)
        return fn

    return deco


def get_sampler(name: str) -> SamplerSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown sampler {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def list_samplers(method: str = None) -> Tuple[str, ...]:
    return tuple(sorted(n for n, s in _REGISTRY.items()
                        if method is None or s.method == method))


def default_sampler(method: str, diff_sampler: str = "ddim") -> str:
    """The config-implied sampler name."""
    return "euler" if method == "flow" else diff_sampler


# ---------------------------------------------------------------------------
# stock solvers
# ---------------------------------------------------------------------------

@register_sampler("euler", method="flow")
def _euler(x1, forests, *, depth, n_t, ts, eps=0.0, noise=None, generator=None):
    return G.flow_euler(x1, forests, depth, n_t, ts=ts)


@register_sampler("heun", method="flow")
def _heun(x1, forests, *, depth, n_t, ts, eps=0.0, noise=None, generator=None):
    return G.flow_heun(x1, forests, depth, n_t, ts=ts)


@register_sampler("ddim", method="diffusion")
def _ddim(x1, forests, *, depth, n_t, ts, eps=1e-3, noise=None, generator=None):
    return G.diffusion_ddim(x1, forests, depth, n_t, eps, ts=ts)


@register_sampler("em", method="diffusion", stochastic=True)
def _em(x1, forests, *, depth, n_t, ts, eps=1e-3, noise=None, generator=None):
    return G.diffusion_em(x1, forests, depth, n_t, eps, ts=ts, noise=noise,
                          generator=generator)
