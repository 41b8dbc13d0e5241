"""The port's flash attention against the JAX package, on the CPU.

On a CPU tensor ``flash_attention`` runs its plain version; it is held to
the Pallas kernel run in interpret mode at the cases of
tests/test_kernels.py's sweep (2e-5 in fp32, 2e-2 in bf16, its
tolerances), to the JAX ``attention_ref`` at ragged lengths the Pallas
kernel does not take, and to the JAX ``mea_attention``'s blocked scan
(2e-4, the tolerance tests/test_kernels.py holds it to the kernel). The
bf16 kernel's arithmetic (tiles of keys, P into P·V as a bf16 hi + lo
pair) is emulated here and held to the plain version within the card's
limit, and so is the fp32 kernel's (tiles of keys, key splits combined in
order) at its launch plan, which is held to the card's limits here. The
CUDA kernel is held to the plain version on the card.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.fa_kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.attention import mea_attention
from repro_torch.kernels.flash_attention import wgmma_gen
from repro_torch.kernels.flash_attention.ops import (
    FP32_STAGES, FP32_TILES, HEAD_DIMS, SMEM_PER_BLOCK, SMS, flash_attention,
    fp32_plan)
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# kernel vs plain version on the card, (atol, rtol): both sum in fp32 and
# round once to the output dtype, so bf16 outputs differ by about an ulp
CARD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 1e-2)}


def qkv(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def port(arrays, dtype, causal):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    out = flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


def close(got, want, tol):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,dtype", [
    (1, 2, 2, 128, 128, 32, True, "float32"),
    (2, 4, 2, 256, 256, 64, True, "float32"),
    (1, 8, 1, 128, 256, 64, False, "float32"),
    (2, 4, 4, 128, 128, 64, True, "bfloat16"),
    (1, 6, 3, 192, 192, 32, True, "float32"),
])
def test_matches_pallas_interpret(b, hq, hkv, sq, skv, d, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = qkv(b, hq, hkv, sq, skv, d, seed=3)
    want = flash_attention_pallas(*(jnp.asarray(a, jdt) for a in arrays),
                                  causal=causal, bq=64, bk=64, interpret=True)
    close(port(arrays, tdt, causal), want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (1, 9, 3, 100, 100, 64),       # ragged: the Pallas kernel asserts Sq % bq
    (2, 9, 3, 1, 1, 64),
    (1, 4, 2, 37, 100, 160),       # Skv > Sq
    (1, 4, 1, 70, 33, 16),         # Skv < Sq: late rows see every key
    (1, 4, 4, 90, 90, 192),        # MLA's prefill: nope + rope = 192
])
def test_matches_jax_ref_at_ragged_lengths(b, hq, hkv, sq, skv, d, causal,
                                           dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = qkv(b, hq, hkv, sq, skv, d, seed=sq)
    want = jax_attention_ref(*(jnp.asarray(a, jdt) for a in arrays), causal)
    close(port(arrays, tdt, causal), want, tol)


def test_matches_mea_attention_blocked_scan():
    """S = 640 > mea_attention's 512-row q block, so its blocked scan runs,
    with a padded last block."""
    arrays = qkv(1, 9, 3, 640, 640, 64, seed=4)
    want = mea_attention(*(jnp.asarray(a) for a in arrays), causal=True)
    close(port(arrays, torch.float32, True), want, 2e-4)


# ---------------------------------------------------------------------------
# the bf16 kernel's arithmetic, emulated in plain PyTorch
# ---------------------------------------------------------------------------

def emulate_bf16_kernel(q, k, v, causal, bk, split_p=True):
    """What csrc/flash_attention_bf16.cuh computes: bf16 q, k, v; fp32
    scores scaled after the product; tiles of ``bk`` keys with an online
    softmax from m = -1e30; l summed from the fp32 p; P into P·V as
    bf16(p) plus bf16(p - bf16(p)) (or, with ``split_p=False``, bf16(p)
    alone); fp32 accumulation; acc / max(l, 1e-30) rounded to bf16."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    kf, vf = k.float(), v.float()
    scale = float(np.float32(1.0 / math.sqrt(d)))
    m = torch.full((b, hkv, hq // hkv, sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, skv, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(keys > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        p_hi = p.bfloat16().float()
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p_hi, vt)
        if split_p:
            p_lo = (p - p_hi).bfloat16().float()
            pv = pv + torch.einsum("bhgqk,bhkd->bhgqd", p_lo, vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).bfloat16()


def worst_over_card_limit(got, want):
    """max |got - want| / (atol + rtol·|want|) at the card's bf16 limit."""
    atol, rtol = CARD_TOL["bfloat16"]
    got, want = got.float(), want.float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,bk", [
    (1, 4, 2, 300, 300, 64, True, 128),      # ragged, GQA
    (2, 3, 1, 190, 190, 64, True, 128),
    (1, 4, 4, 257, 257, 64, True, 128),      # G = 1
    (1, 4, 2, 200, 200, 256, True, 64),
    (1, 2, 1, 200, 333, 256, False, 64),     # Skv > Sq, not a tile multiple
    (1, 4, 4, 300, 300, 192, True, 64),      # MLA's width, ragged
])
def test_bf16_kernel_arithmetic_within_the_card_limit(b, hq, hkv, sq, skv, d,
                                                      causal, bk):
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in qkv(b, hq, hkv, sq, skv, d, seed=sq))
    got = emulate_bf16_kernel(q, k, v, causal, bk)
    assert worst_over_card_limit(got, attention_ref(q, k, v, causal)) <= 1.0


def test_p_rounded_once_to_bf16_breaks_the_card_limit():
    """The limit is tight enough to catch the kernel rounding P once to
    bf16, which is why P goes into P·V as a hi + lo pair."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in qkv(2, 3, 1, 190, 190, 64, seed=190))
    want = attention_ref(q, k, v, True)
    once = emulate_bf16_kernel(q, k, v, True, 128, split_p=False)
    assert worst_over_card_limit(once, want) > 1.0


# ---------------------------------------------------------------------------
# the fp32 kernel's arithmetic and launch plan
# ---------------------------------------------------------------------------

def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest even), as the tensor
    cores take an fp32 operand."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def emulate_fp32_kernel(q, k, v, causal, round_inputs=None):
    """What csrc/flash_attention.cu's fp32 kernel computes, at the tiles of
    ``fp32_plan``: q scaled by float32(1/√d) before the product; per query
    tile of ``bq`` rows, the keys it can see in tiles of ``bk`` (zero rows
    past Skv, scored -1e30), cut into ``splits`` chunks of whole tiles; an
    online softmax from m = -1e30 per chunk; the chunks' (m, l, acc)
    combined in key order; acc / max(l, 1e-30). ``round_inputs`` (e.g.
    :func:`tf32`) rounds both products' inputs."""
    rnd = round_inputs or (lambda x: x)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    plan = fp32_plan(b, hq, sq, skv, d, causal)
    bq, bk, splits = plan.bq, plan.bk, plan.splits
    scale = float(np.float32(1.0 / math.sqrt(d)))
    qf = (q.float() * scale).reshape(b, hkv, hq // hkv, sq, d)
    pad = -(-skv // bk) * bk - skv
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    out = torch.empty_like(qf)
    for q0 in range(0, sq, bq):
        qt = qf[:, :, :, q0:q0 + bq]
        rows = torch.arange(q0, q0 + qt.shape[3])[:, None]
        kend = min(skv, q0 + qt.shape[3]) if causal else skv
        n_all = -(-kend // bk)
        per = -(-n_all // splits)
        parts = []
        for split in range(splits):
            m = torch.full(qt.shape[:-1], -1e30)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(qt)
            for t in range(split * per, min(n_all, split * per + per)):
                keys = torch.arange(t * bk, t * bk + bk)[None, :]
                s = torch.einsum("bhgqd,bhkd->bhgqk", rnd(qt),
                                 rnd(kf[:, :, t * bk:t * bk + bk]))
                masked = keys >= skv
                if causal:
                    masked = masked | (keys > rows)
                s = s.masked_fill(masked, -1e30)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhgqk,bhkd->bhgqd", rnd(p),
                    rnd(vf[:, :, t * bk:t * bk + bk]))
                m = m_new
            parts.append((m, l, acc))
        mm = torch.stack([m for m, _, _ in parts]).amax(0)
        ll, aa = torch.zeros_like(mm), torch.zeros_like(qt)
        for m, l, acc in parts:
            w = torch.exp(m - mm)
            ll = ll + l * w
            aa = aa + acc * w[..., None]
        out[:, :, :, q0:q0 + bq] = aa / torch.clamp(ll, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d)


def worst_over_fp32_limit(got, want):
    """max |got - want| / (atol + rtol·|want|) at the card's fp32 limit."""
    atol, rtol = CARD_TOL["float32"]
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


# (b, hq, hkv, sq, skv, d, causal): ragged, Sq << Skv, and key splits of
# 1, 3, 4 and 8 chunks, causal or not
FP32_EMULATED = [
    (3, 44, 4, 65, 65, 64, True),        # no split, one ragged query tile
    (3, 44, 4, 70, 33, 64, True),        # Skv < Sq
    (1, 2, 1, 5, 300, 64, False),        # 8 splits of 10 key tiles
    (1, 4, 2, 100, 130, 256, True),      # causal with 4 splits
    (3, 48, 1, 70, 100, 256, False),     # MQA, no split
    (2, 3, 1, 37, 333, 192, False),      # MLA's width, 8 splits
    (2, 3, 1, 37, 333, 192, True),       # causal, 3 splits
    (2, 4, 4, 1, 1500, 192, False),      # one query, 1,500 keys
]


def test_fp32_emulated_cases_reach_every_plan():
    plans = {case: fp32_plan(*case[:2], *case[3:]) for case in FP32_EMULATED}
    assert {1, 3, 4, 8} <= {p.splits for p in plans.values()}
    assert any(p.splits > 1 and case[6] for case, p in plans.items())
    assert {64, 192, 256} <= {case[5] for case in FP32_EMULATED}


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", FP32_EMULATED)
def test_fp32_kernel_arithmetic_within_the_card_limit(b, hq, hkv, sq, skv, d,
                                                      causal):
    q, k, v = (torch.from_numpy(a)
               for a in qkv(b, hq, hkv, sq, skv, d, seed=sq + d))
    got = emulate_fp32_kernel(q, k, v, causal)
    assert worst_over_fp32_limit(got, attention_ref(q, k, v, causal)) <= 1.0


def test_tf32_inputs_break_the_fp32_limit():
    """TF32 keeps 10 mantissa bits: rounding both products' inputs to it
    puts the output past the 2e-5 limit, which is why the fp32 kernel runs
    fp32 FMAs on the CUDA cores rather than the tensor cores."""
    q, k, v = (torch.from_numpy(a) for a in qkv(2, 3, 1, 190, 190, 64,
                                                 seed=190))
    want = attention_ref(q, k, v, True)
    assert worst_over_fp32_limit(emulate_fp32_kernel(q, k, v, True),
                                 want) <= 1.0
    rounded = emulate_fp32_kernel(q, k, v, True, round_inputs=tf32)
    assert worst_over_fp32_limit(rounded, want) > 1.0


# the seven prefill shapes the fp32 kernel is timed at on the card
# (chip_smoke.py: smollm-135m serving, the MoE and the families' prefills)
FP32_PREFILLS = {
    "smollm-135m": ((8, 9, 3, 2048, 2048, 64), True),
    "dbrx-132b": ((4, 48, 8, 1024, 1024, 128), True),
    "deepseek-v2-236b MLA": ((2, 128, 128, 1024, 1024, 192), True),
    "recurrentgemma-9b": ((2, 16, 1, 2048, 2048, 256), True),
    "llava-next-34b": ((2, 56, 8, 1600, 1600, 128), True),
    "whisper-tiny encoder": ((8, 6, 6, 1500, 1500, 64), False),
    "whisper-tiny cross": ((8, 6, 6, 64, 1500, 64), False),
}


def check_plan(plan, b, hq, sq, d):
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.threads % 32 == 0 and plan.threads >= 32
    assert plan.stages == FP32_STAGES and 1 <= plan.splits <= 8
    assert plan.grid == (-(-sq // plan.bq), hq, b * plan.splits)
    # register tiles: at least 4 FMAs per shared-memory wavefront in both
    # products (the earlier SIMT design had 2)
    assert plan.s_fmas_per_wavefront >= 4
    assert plan.pv_fmas_per_wavefront >= 4


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("label", sorted(FP32_PREFILLS))
def test_fp32_plan_fits_a_block_at_every_head_dim(label, d):
    (b, hq, _, sq, skv, _), causal = FP32_PREFILLS[label]
    check_plan(fp32_plan(b, hq, sq, skv, d, causal), b, hq, sq, d)


@pytest.mark.parametrize("label", sorted(FP32_PREFILLS))
def test_fp32_plan_fills_the_card_at_the_prefill_shapes(label):
    (b, hq, _, sq, skv, d), causal = FP32_PREFILLS[label]
    plan = fp32_plan(b, hq, sq, skv, d, causal)
    check_plan(plan, b, hq, sq, d)
    assert plan.blocks >= SMS
    if label == "whisper-tiny cross":        # 48 query tiles of 64 rows
        assert (plan.splits, plan.blocks) == (4, 192)
    else:
        assert plan.splits == 1


def test_fp32_plan_splits_keys_only_where_the_query_tiles_do_not_fill():
    one = fp32_plan(2, 4, 1, 1500, 192, False)      # 8 query tiles
    assert (one.splits, one.blocks) == (8, 64)
    two_tiles = fp32_plan(1, 2, 40, 64, 64, False)   # 2 key tiles of 32
    assert two_tiles.splits == 2
    causal = fp32_plan(2, 3, 37, 333, 192, True)     # sees 37 keys: 3 tiles
    assert causal.splits == 3
    (b, hq, _, sq, skv, d), _ = FP32_PREFILLS["smollm-135m"]
    assert fp32_plan(b, hq, sq, skv, d, True).splits == 1


def test_fp32_tiles_are_the_kernels():
    """ops.FP32_TILES is the table of csrc/flash_attention.cu's Shape<D>,
    and ops.FP32_STAGES its kStages, which the kernel is built from
    (chip_smoke.py also holds the built instances' shared memory, threads
    and ring slots to the plan)."""
    from repro_torch.kernels import build
    with open(build.source("flash_attention")) as f:
        src = f.read()
    found = re.findall(r"struct Shape<(\d+)> \{ static constexpr int TR = "
                       r"(\d+), CX = (\d+), BK = (\d+), BQ = (\d+); \};", src)
    assert {int(d): tuple(map(int, t)) for d, *t in found} == FP32_TILES
    assert re.findall(r"constexpr int kStages = (\d+);", src) == [
        str(FP32_STAGES)]


def test_wgmma_header_is_the_generators_output():
    with open(wgmma_gen.HEADER) as f:
        assert f.read() == wgmma_gen.render()


def test_plain_version_is_the_cpu_path():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 4, 2, 50, 50, 32, seed=5))
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v), attention_ref(q, k, v))
    assert flash_attention.launches == before     # no kernel on the CPU


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 4, 2, 8, 8, 32, seed=6))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros(1, 3, 8, 32), k, v)
    with pytest.raises(ValueError, match="d=48"):
        z = torch.zeros(1, 2, 8, 48)
        flash_attention(z, z, z)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="Skv"):
        e = torch.zeros(1, 2, 0, 32)
        flash_attention(q, e, e)


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash_attention kernel has no "
                    "CPU mode; python3 chip_smoke.py runs it on the card")
    return torch.device("cuda")


# (b, hq, hkv, sq, skv, d, causal): every d, Sq off the bf16 kernel's
# 128-row tiles, GQA and one KV head per query head
CARD_CASES = [
    (2, 9, 3, 300, 300, 64, True),
    (1, 9, 3, 1, 1, 64, True),
    (1, 8, 1, 128, 256, 64, False),
    (1, 4, 2, 100, 70, 256, True),
    (1, 4, 4, 65, 65, 160, True),
    (1, 4, 2, 200, 200, 16, True),
    (1, 4, 2, 130, 130, 32, True),
    (1, 4, 1, 250, 250, 128, True),
    (1, 2, 2, 190, 333, 128, False),
    (1, 4, 4, 300, 300, 192, True),
    (8, 6, 6, 64, 1500, 64, False),      # short queries: 4 key splits
    (2, 4, 4, 1, 1500, 192, False),      # one query: 8 key splits
]


def test_card_cases_cover_every_head_dim_and_ragged_tiles():
    assert sorted({c[5] for c in CARD_CASES}) == sorted(HEAD_DIMS)
    assert any(c[3] % 128 and c[4] % 128 for c in CARD_CASES)
    assert any(c[1] == c[2] for c in CARD_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", CARD_CASES)
def test_cuda_kernel_matches_plain(cuda_device, b, hq, hkv, sq, skv, d, causal,
                                   dtype):
    _, tdt, _ = DTYPES[dtype]
    atol, rtol = CARD_TOL[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda_device, tdt)
               for a in qkv(b, hq, hkv, sq, skv, d, seed=sq))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 2
    ref = attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
