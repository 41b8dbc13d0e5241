"""The import rule: nothing the benchmark runs imports ``jax`` or the JAX
package ``repro``; the reference imports nothing of the program either.
Module names are compared by their whole top-level name."""
import ast
import os
import subprocess
import sys

from harness import cli

from conftest import BENCH, REPO


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def bench_sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py") and "tests" not in d.split(os.sep):
                yield os.path.join(d, f)


def test_whole_top_level_names():
    assert cli.forbidden_modules(["repro_torch", "repro_torch.tabgen",
                                  "reprox", "jaxtyping"]) == []
    assert cli.forbidden_modules(["repro.tabgen", "jax.numpy", "jaxlib",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in bench_sources():
        bad = top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "harness", "reference.py")
    assert top_level_imports(ref) <= {"__future__", "typing", "numpy",
                                      "torch"}


def test_a_run_loads_no_jax():
    """The program's modules that the drivers import load no JAX."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import harness.drivers.fit, harness.drivers.generate\n"
            "import repro_torch.tabgen, repro_torch.kernels.hist.ops\n"
            "from harness.cli import forbidden_modules\n"
            "print(forbidden_modules(list(sys.modules)))"
            % (BENCH, os.path.join(REPO, "src")))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
