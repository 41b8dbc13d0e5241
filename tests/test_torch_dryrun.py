"""The port's dry run (``repro_torch.launch.dryrun``) on small fake meshes.

Two subprocesses side by side (``tests/_torch_dryrun_worker.py``: a fake
process group lives and dies in each, never in a test worker) trace every
family at ``reduced()`` x {train, prefill, decode} on a 4x2 fake mesh —
dense, moe, mla_moe, recurrent (recurrentgemma's RG-LRU + attention), vlm,
audio_encdec — plus a tiny caloforest slice; each must come back ``ok``. The dense train cell is the
counterpart of the JAX package's ``test_dryrun_code_path_small_mesh``:
FLOPs traced, collectives found, a roofline within bounds. A second
subprocess runs the CLI on one production cell (smollm-135m, decode_32k,
16x16) and checks its artifact. A real CPU tensor never takes the
kernels' fake path.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

WORKER = Path(__file__).with_name("_torch_dryrun_worker.py")
SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 300

FAMILIES = {"dense": "smollm-135m", "moe": "dbrx-132b",
            "mla_moe": "deepseek-v2-236b", "recurrent": "recurrentgemma-9b",
            "vlm": "llava-next-34b",
            "audio_encdec": "whisper-tiny"}
KINDS = ("train", "prefill", "decode")
CELLS = [(f, k) for f in FAMILIES for k in KINDS]


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun")
    cells = [{"arch": FAMILIES[f], "kind": k, "seq": 32, "batch": 8,
              "mesh": [4, 2]} for f, k in CELLS]
    cells.append({"arch": "caloforest", "rows": 512, "p": 6, "mesh": [4, 2]})
    halves = [cells[0::2], cells[1::2]]
    procs = []
    for i, half in enumerate(halves):
        (work / f"cells{i}.json").write_text(json.dumps(half))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(work / f"out{i}.json"),
             str(work / f"cells{i}.json")], env=_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, err[-3000:]
    out0 = json.loads((work / "out0.json").read_text())
    out1 = json.loads((work / "out1.json").read_text())
    recs = [r for pair in zip(out0, out1 + [None]) for r in pair
            if r is not None]
    keys = [f"{f}-{k}" for f, k in CELLS] + ["caloforest"]
    return dict(zip(keys, recs))


@pytest.mark.parametrize("cell", [f"{f}-{k}" for f, k in CELLS]
                         + ["caloforest"])
def test_family_cell_traces_ok(records, cell):
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "4x2"
    assert rec["cost_analysis_raw"]["flops"] > 0
    assert rec["memory_analysis"]["peak_bytes_per_device"] > 0


def test_dryrun_code_path_small_mesh(records):
    """A reduced smollm train step on the 4x2 fake mesh: loss_fn, its
    backward pass and AdamW traced, the rules' collectives found."""
    rec = records["dense-train"]
    assert rec["status"] == "ok"
    assert rec["chips"] == 8
    inv = rec["collective_inventory"]
    # FSDP: weights gathered at use, gradients reduce-scattered back
    assert inv.get("all-gather", 0) > 0 and inv.get("reduce-scatter", 0) > 0
    assert rec["collective_bytes_hlo_scaled"] == sum(inv.values())
    roof = rec["roofline"]
    assert 0.0 <= roof["mfu_bound"] <= 1.0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert rec["analytic"]["total_flops"] > 0
    assert rec["flops_by_op"].get("aten.mm", 0) > 0


def test_cli_writes_a_production_cell(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[ok] smollm-135m x decode_32k x 16x16" in res.stdout
    rec = json.loads((tmp_path / "smollm-135m_decode_32k_single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert 0.0 <= rec["roofline"]["mfu_bound"] <= 1.0
    assert rec["collective_inventory"]
    assert rec["memory_analysis"]["fits_80GB"]


def test_skipped_cell_is_recorded():
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell("smollm-135m", "long_500k", False)
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]


def test_a_real_cpu_tensor_never_takes_the_fake_path():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.hist.ops import histogram
    from repro_torch.kernels.hist.ref import histogram_ref
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, 16, generator=gen)
    k = torch.randn(2, 2, 16, 16, generator=gen)
    v = torch.randn(2, 2, 16, 16, generator=gen)
    torch.testing.assert_close(flash_attention(q, k, v),
                               attention_ref(q, k, v, True), rtol=0, atol=0)
    codes = torch.randint(0, 8, (40, 3), generator=gen, dtype=torch.int32)
    node = torch.randint(0, 2, (1, 40), generator=gen, dtype=torch.int32)
    g = torch.randn(1, 40, 3, generator=gen)
    w = torch.rand(40, generator=gen)
    for got, want in zip(histogram(codes, node, g, w, 2, 8),
                         histogram_ref(codes, node, g, w, 2, 8)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with FakeTensorMode():
        fq = torch.empty(2, 4, 16, 16)
        kv = fq[:, :2].clone()
        out = flash_attention(fq, kv, kv)
        assert out.shape == fq.shape
        s, c = histogram(torch.zeros(40, 3, dtype=torch.int32),
                         torch.zeros(1, 40, dtype=torch.int32),
                         torch.empty(1, 40, 3), torch.empty(40), 2, 8)
        assert s.shape == (1, 2, 3, 8, 3) and c.shape == (1, 2, 3, 8)
    assert flash_attention.launches == 0 and histogram.launches == 0
