"""The port's analytic cost model against the JAX package's.

FLOPs, HBM bytes and collective bytes count a step's work and are
hardware-free: ``cell_cost`` (every field), ``param_count``,
``active_param_count``, ``forest_cost`` and ``chip_memory_estimate``'s
bytes equal the JAX values for every arch x shape x mesh. ``roofline`` is
held to the H100's terms computed by hand. The analytic forward FLOPs
match ``traced_flops`` (FlopCounterMode's formulas over a forward of the
``_mini_dense`` probe) within the reference's ``rel=0.15``
(``tests/test_flops_model.py``); the measured ratio is 1.0 (the probe's
products are exactly the model's terms).

The JAX package's ``param_count`` traces ``init_params`` at every call;
the test memoises it (a pure function of a frozen config) so the sweep
runs in seconds.
"""
import functools

import pytest
import torch

import repro.analysis.flops as jfl
from repro.config import LM_SHAPES as JAX_SHAPES
from repro.config import ArchConfig as JArchConfig
from repro.config import ForestConfig as JForestConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.configs import get_arch as jax_get_arch
from repro_torch.analysis import flops as fl
from repro_torch.config import (LM_SHAPES, ArchConfig, ForestConfig,
                                ShapeConfig)
from repro_torch.configs import ARCH_IDS, get_arch

MESHES = [(256, 16, 16), (512, 32, 16)]   # chips, dp_size, tp_size


@pytest.fixture(scope="module")
def jax_fl():
    real = jfl.param_count
    jfl.param_count = functools.lru_cache(maxsize=None)(real)
    yield jfl
    jfl.param_count = real


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_cost_and_memory_match_jax(jax_fl, arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    assert fl.param_count(cfg) == jax_fl.param_count(jcfg)
    assert fl.active_param_count(cfg) == jax_fl.active_param_count(jcfg)
    for shape, jshape in zip(LM_SHAPES, JAX_SHAPES):
        for chips, dp, tp in MESHES:
            for kw in ({}, {"remat_policy": "dots", "attn_packed": True},
                       {"mla_absorb": True, "moe_w8": True}):
                got = fl.cell_cost(cfg, shape, chips=chips, dp_size=dp,
                                   tp_size=tp, **kw)
                want = jax_fl.cell_cost(jcfg, jshape, chips=chips,
                                        dp_size=dp, tp_size=tp, **kw)
                assert vars(got) == pytest.approx(vars(want), rel=1e-12)
            for kw in ({}, {"remat_policy": "dots", "opt_bf16": True},
                       {"moe_w8": True}):
                got = fl.chip_memory_estimate(cfg, shape, chips=chips, **kw)
                want = jax_fl.chip_memory_estimate(jcfg, jshape, chips=chips,
                                                   **kw)
                assert got["per_chip_bytes"] == pytest.approx(
                    want["per_chip_bytes"], rel=1e-12)
                assert got["fits_80GB"] == (got["per_chip_bytes"] < 80e9)


@pytest.mark.parametrize("p", [368, 533])
def test_forest_cost_matches_jax(p):
    for chips, shards in ((256, 16), (512, 32)):
        for kw in ({}, {"split_reduce": "reduce_scatter"},
                   {"hist_bf16": True, "int8_codes": True},
                   {"multi_output": True}):
            args = dict(n_t=100, duplicate_k=20, n_trees=2, max_depth=7,
                        learning_rate=1.5, n_bins=64, reg_lambda=1.0, **kw)
            got = fl.forest_cost(n_rows=122880, p=p, fcfg=ForestConfig(**args),
                                 chips=chips, data_shards=shards)
            want = jfl.forest_cost(n_rows=122880, p=p,
                                   fcfg=JForestConfig(**args), chips=chips,
                                   data_shards=shards)
            assert vars(got) == pytest.approx(vars(want), rel=1e-12)


def test_roofline_at_the_h100_peaks():
    cost = fl.CellCost(fwd_flops=1e15, total_flops=4e15, hbm_bytes=2e12,
                       coll_bytes=9e11, model_flops=3e15)
    r = fl.roofline(cost, 4)
    t_comp = 4e15 / (4 * 989e12)
    t_mem = 2e12 / (4 * 3.35e12)
    t_coll = 9e11 / (4 * 450e9)
    assert r["t_compute_s"] == pytest.approx(t_comp, rel=1e-12)
    assert r["t_memory_s"] == pytest.approx(t_mem, rel=1e-12)
    assert r["t_collective_s"] == pytest.approx(t_coll, rel=1e-12)
    assert r["dominant"] == "compute"
    assert r["roofline_fraction"] == pytest.approx(1.0)
    assert r["mfu_bound"] == pytest.approx(3e15 / (4 * 989e12) / t_comp)
    assert r["useful_flops_ratio"] == pytest.approx(0.75)
    # collective-bound once the link term dominates
    r = fl.roofline(fl.CellCost(1, 1, 1, 4.5e12, 1), 1)
    assert r["dominant"] == "collective"
    assert r["t_collective_s"] == pytest.approx(10.0)
    assert (fl.PEAK_FLOPS, fl.HBM_BW, fl.LINK_BW, fl.HBM_BYTES) == \
        (989e12, 3.35e12, 450e9, 80e9)


def _mini_dense():
    return ArchConfig(name="mini", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_head=16, d_ff=192,
                      vocab=512, norm="rmsnorm", act="swiglu")


def test_fwd_flops_match_flop_counter_dense():
    from repro_torch.models import blocks, lm
    from repro_torch.models.layers import apply_norm
    cfg = _mini_dense()
    b, s = 2, 128
    params = lm.init_params(cfg, device="cpu")
    toks = torch.zeros((b, s), dtype=torch.int32)

    def fwd():
        with torch.no_grad():
            x = torch.nn.functional.embedding(toks.long(),
                                              params.embed.tokens)
            pos = torch.arange(s)[None].expand(b, s)
            for (kinds, _), seg in zip(blocks.segments_for(cfg),
                                       params.segments):
                x, _ = blocks.apply_segment(seg, x, pos, cfg, kinds,
                                            remat_policy="none")
            x = apply_norm(params.final_norm, x, cfg.norm)
            return x @ params.embed.tokens.T

    traced = fl.traced_flops(fwd)["flops"]
    cost = fl.cell_cost(cfg, ShapeConfig("probe", s, b, "prefill"), chips=1,
                        dp_size=1, tp_size=1)
    assert traced == pytest.approx(cost.fwd_flops, rel=0.15), (
        traced, cost.fwd_flops, traced / cost.fwd_flops)
    # the JAX package's model counts the same
    jcost = jfl.cell_cost(JArchConfig(**vars(cfg)),
                          JShapeConfig("probe", s, b, "prefill"), chips=1,
                          dp_size=1, tp_size=1)
    assert cost.fwd_flops == jcost.fwd_flops


def test_flash_attention_formula_counts_full_scores():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q = torch.randn(2, 4, 32, 16)
    k = torch.randn(2, 2, 48, 16)
    got = fl.traced_flops(flash_attention, q, k, k)
    assert got["flops"] == 2 * 2 * 4 * 32 * 48 * 16 * 2
