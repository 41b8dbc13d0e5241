"""The control - the configuration's computation one precision lower in
the program's place - must come out as not correct: here at a tiny size on
the CPU; on the card at the cells' own sizes by ``run.py --control``
(the ``cuda`` test below)."""
import json
import subprocess
import sys

import pytest

from conftest import REPO, run_tiny


@pytest.mark.parametrize("cell", ["tiny-gen", "tiny-gen-bucket"])
def test_bf16_reference_in_the_programs_place_fails(tiny_root, cell):
    out = run_tiny(tiny_root, cell, control=True)
    assert not out["correct"], out["checks"]
    assert out["checks"]["row_gap"]["value"] > out["checks"]["row_gap"][
        "limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["photons-generate-4k", "photons-generate"])
def test_control_fails_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "2147483999", "--seconds", "1",
                        "--trace", "0", "--control"], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is False
