"""A run fails, and prints no result, without a CUDA device (it never falls
back to the CPU) and in a directory that holds only BENCHMARK.json and the
benchmark's folder."""
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, REPO

ARGS = ["--workload", "photons-generate-4k", "--seed", "2147483651",
        "--seconds", "1", "--trace", "0"]


def run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    r = run(REPO)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.parametrize("argv", [["--workload", "nope", "--seed", "1",
                                   "--seconds", "1"]])
def test_unknown_cell(argv):
    r = subprocess.run([sys.executable, "portbench/run.py", *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
