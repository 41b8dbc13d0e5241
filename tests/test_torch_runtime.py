"""``repro_torch.analysis.runtime``: kernel builds and loads budgeted over a
region, and the serving contract it pins — a same-shape ``swap()`` builds
and loads no kernel library.

The counting tests stand a fake compiler in for ``nvcc`` (as
``tests/test_torch_serving.py`` does for the build lock). The CPU path
loads no kernel at all, so the swap contract is pinned where kernels load
by the ``cuda`` twin, and under traffic by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro_torch.analysis.runtime import build_budget, capture_builds
from repro_torch.config import ForestConfig
from repro_torch.kernels import build
from repro_torch.serving import ModelRegistry
from repro_torch.tabgen import fit_artifacts


@pytest.fixture
def fake_kernel(tmp_path, monkeypatch):
    """A kernel ``demo`` under a temporary tree whose 'nvcc' writes the
    library file; opening a library yields a placeholder."""
    monkeypatch.setattr(build, "_HERE", str(tmp_path))
    csrc = tmp_path / "demo" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "demo.cu").write_text("// kernel\n")

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            with open(cmd[cmd.index("-o") + 1], "w") as f:
                f.write("lib")

        def communicate(self):
            return ("", None)

    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(build, "open_library", lambda path, name: object())
    build._load.cache_clear()
    yield
    build._load.cache_clear()


def test_capture_builds_counts_nvcc_runs_and_loads(fake_kernel):
    with capture_builds() as watch:
        build.load("demo")
        build.load("demo")                  # cached: nothing new
        assert watch.builds == ["demo"]     # readable inside the region
    assert (watch.builds, watch.loads, watch.libraries) == (
        ["demo"], ["demo"], ["demo"])
    with capture_builds() as again:
        build.build(["demo"])               # built already: no nvcc
    assert again.builds == again.loads == []


def test_build_budget_fails_above_its_budget(fake_kernel):
    with pytest.raises(AssertionError, match="budget 0 exceeded"):
        with build_budget(0):
            build.load("demo")
    build._load.cache_clear()
    with build_budget(1) as watch:
        build.load("demo")                  # library on disk: load only
    assert (watch.builds, watch.loads) == ([], ["demo"])
    with pytest.raises(ValueError, match="propagates"):
        with build_budget(0):
            raise ValueError("propagates")


def swap_under_budget(device):
    """Serve a model once, then swap in one of the same shape and serve
    again inside ``build_budget(0)``."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(80, 3)).astype(np.float32)
    cfg = ForestConfig(n_t=3, duplicate_k=2, n_trees=3, max_depth=2,
                       n_bins=8)
    a = fit_artifacts(X, None, cfg, seed=0, device=device)
    b = fit_artifacts(X, None, cfg, seed=1, device=device)
    reg = ModelRegistry(device=device, buckets=(16,))
    reg.register("m", a)
    reg.acquire("m").generate(10, seed=0)
    with build_budget(0) as watch:
        handle = reg.swap("m", b)
        X2, _ = reg.acquire("m").generate(10, seed=0)
    assert watch.libraries == []
    assert handle.version == 2 and X2.shape == (10, 3)


def test_same_shape_swap_builds_and_loads_nothing():
    swap_under_budget("cpu")


@pytest.mark.cuda
def test_same_shape_swap_on_the_card_builds_and_loads_nothing():
    """On the card the fits and the first generate load hist and
    tree_predict; the swap and the generate after it load nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels load only there; "
                    "python3 chip_smoke.py pins the swap under traffic")
    swap_under_budget("cuda")
    loaded = build.events()
    assert loaded["load", "hist"] >= 1 and loaded["load", "tree_predict"] >= 1
