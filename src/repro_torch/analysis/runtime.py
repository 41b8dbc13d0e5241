"""Pin the kernel libraries built and loaded over a code region.

The JAX package's ``repro.analysis.runtime`` counts jit compiles. The port
compiles nothing at run time but its CUDA kernels: each is built by
``nvcc`` and loaded once per process (:mod:`repro_torch.kernels.build`).
:func:`capture_builds` records the builds and loads inside a ``with``
block; :func:`build_budget` fails when more kernel libraries than its
budget were built or loaded there. The serving tests use budget 0 to pin
"a same-shape swap builds and loads nothing"::

    with build_budget(0):
        registry.swap("m", new_artifacts)

    with capture_builds() as watch:
        sample(artifacts, 100)            # first use on the card
    print(watch.builds, watch.loads)
"""
from __future__ import annotations

import collections
import contextlib
from typing import Iterator, List, Optional

from repro_torch.kernels import build


class BuildWatch:
    """Kernel builds and loads between the region's start and its end (or
    now, while it runs)."""

    def __init__(self) -> None:
        self._before = build.events()
        self._after: Optional[collections.Counter] = None

    @property
    def events(self) -> collections.Counter:
        return (self._after or build.events()) - self._before

    def _named(self, kind: str) -> List[str]:
        return sorted(k for (what, k), c in self.events.items()
                      for _ in range(c) if what == kind)

    @property
    def builds(self) -> List[str]:
        """Kernels ``nvcc`` was started for, once per run."""
        return self._named("build")

    @property
    def loads(self) -> List[str]:
        """Kernels whose library was opened."""
        return self._named("load")

    @property
    def libraries(self) -> List[str]:
        """Distinct kernels built or loaded: what a budget counts."""
        return sorted({k for _, k in self.events})


@contextlib.contextmanager
def capture_builds() -> Iterator[BuildWatch]:
    """Record kernel builds and loads in the with-block; no check."""
    watch = BuildWatch()
    try:
        yield watch
    finally:
        watch._after = build.events()


@contextlib.contextmanager
def build_budget(budget: int = 0) -> Iterator[BuildWatch]:
    """Fail if more than ``budget`` kernel libraries are built or loaded in
    the with-block. Exceptions raised by the block propagate unchanged."""
    with capture_builds() as watch:
        yield watch
    if len(watch.libraries) > budget:
        raise AssertionError(
            f"kernel build budget {budget} exceeded: built {watch.builds}, "
            f"loaded {watch.loads}")
