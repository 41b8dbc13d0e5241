"""``flash_attention``: the attention of every prefill layer.

The tensors' device picks the path. On the CPU it runs the plain PyTorch
version (:mod:`.ref`); on a CUDA device it launches the hand-written kernel
(``csrc/flash_attention.cu``, built at first use by
:mod:`repro_torch.kernels.build`) on the current stream, without a sync, or
raises. bfloat16 runs on the tensor cores (``wgmma`` fed by TMA,
``csrc/flash_attention_bf16.cuh``); float32 on the CUDA cores, with the
launch plan of :func:`fp32_plan`. ``flash_attention.launches`` counts
kernel launches, so a run can show that its main path went through the
kernel.

The work is the operator ``repro_torch::flash_attention``
(``torch.library.custom_op``), so a fake tensor (``FakeTensorMode``, the
dry run's traced steps) or a ``meta`` tensor is answered from its shape
and dtype alone (``register_fake``), with no library built and no launch;
a real tensor still takes its device's path.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = (torch.float32, torch.bfloat16)
# every head width of the configs (MLA: nope + rope = 192)
HEAD_DIMS = (16, 32, 64, 128, 160, 192, 256)
_GRID_YZ = 65535       # CUDA's limit on gridDim.y (Hq) and gridDim.z (B)

# The fp32 kernel's tile per head width, as csrc/flash_attention.cu's
# Shape<D>: d -> (TR query rows a thread, CX threads a row, BK keys a tile,
# BQ query rows a block). A thread owns TR rows, BK/CX keys of a tile and
# d/(4·CX) float4 columns of O; a block has BQ/TR·CX threads. Chosen on the
# card by scripts/probe_torch_flash_attention.py.
FP32_TILES = {16: (4, 4, 32, 64), 32: (4, 8, 32, 64), 64: (4, 8, 32, 64),
              128: (4, 8, 32, 64), 160: (4, 8, 16, 64), 192: (4, 8, 16, 64),
              256: (4, 16, 32, 64)}
FP32_STAGES = 2               # K/V ring slots, csrc's kStages
FP32_MAX_SPLITS = 8           # key splits of a query tile: a portable cluster
SMS = 132                     # H100 SXM
SMEM_PER_BLOCK = 232_448      # the most one block may use


@dataclasses.dataclass(frozen=True)
class Fp32Plan:
    """How the fp32 kernel is launched for one shape: what
    ``flash_attention_launch`` takes (``splits``) and what the instance of
    head width d fixes (``bq``, ``bk``, ``threads``, ``stages``)."""
    bq: int              # query rows a block
    bk: int              # keys a tile of the ring
    threads: int         # a block
    stages: int          # K/V ring slots (TMA, one mbarrier each)
    splits: int          # key chunks of a query tile (a cluster), 1 = none
    smem_bytes: int      # dynamic shared memory a block
    grid: tuple          # (query tiles, Hq, B·splits)
    s_fmas_per_wavefront: float    # warp FMAs per shared-memory wavefront:
    pv_fmas_per_wavefront: float   # S = Q·Kᵀ, O += P·V

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def fp32_smem_bytes(d: int, stages: int = FP32_STAGES,
                    tiles=FP32_TILES) -> int:
    """Shared memory of one fp32 block: 1,024 bytes of slack to align the
    ring, ``stages`` ring slots of a K and a V tile [BK][d], Q [BQ][d+4],
    P [BQ][BK+CX] (floats) and an mbarrier a slot."""
    _, cx, bk, bq = tiles[d]
    return (1024 + stages * 2 * bk * d * 4 + 4 * bq * (d + 4)
            + 4 * bq * (bk + cx) + 8 * stages)


def fp32_plan(b: int, hq: int, sq: int, skv: int, d: int, causal: bool,
              tiles=FP32_TILES) -> Fp32Plan:
    """The fp32 kernel's launch plan for q ``[b, hq, sq, d]`` and ``skv``
    keys (a pure function of the shape; ``tiles`` is the build's
    ``Shape<D>`` table).

    * Stages: ``FP32_STAGES`` ring slots of a K and a V tile (fixed in
      the build).
    * Splits: where ceil(sq/BQ)·hq·b blocks are fewer than the card's 132
      SMs, the keys are cut into the fewest chunks that make 132 blocks: a
      power of two up to 8, and no more than the key tiles.

    The FMAs per wavefront count a warp's 16-byte shared read as one
    128-byte wavefront per 8 distinct addresses (lanes that read the same
    row share it): 1 at CX = 8, 2 for the K and V reads at CX = 16."""
    tr, cx, bk, bq = tiles[d]
    stages = FP32_STAGES
    tiles_q = -(-sq // bq)
    if fp32_smem_bytes(d, stages, tiles) > SMEM_PER_BLOCK:
        raise ValueError(f"d={d}: the fp32 tile does not fit a block's "
                         f"shared memory")
    kend = min(skv, sq) if causal else skv
    splits = 1
    while (tiles_q * hq * b * splits < SMS and splits < FP32_MAX_SPLITS
           and splits < -(-kend // bk)):
        splits *= 2
    splits = min(splits, -(-kend // bk))
    tk, nc, wide = bk // cx, d // (4 * cx), -(-cx // 8)
    return Fp32Plan(
        bq=bq, bk=bk, threads=bq // tr * cx, stages=stages, splits=splits,
        smem_bytes=fp32_smem_bytes(d, stages, tiles),
        grid=(tiles_q, hq, b * splits),
        s_fmas_per_wavefront=4 * tr * tk / (tr + tk * wide),
        pv_fmas_per_wavefront=16 * tr * nc / (tr + 4 * nc * wide))


# the wrapper's plan of each shape it has launched
_plan = functools.lru_cache(maxsize=1024)(fp32_plan)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_fp32_config.argtypes = [i32, ptr]
    lib.flash_attention_fp32_config.restype = i32
    return lib


def fp32_config(d: int) -> dict:
    """The built fp32 instance of head width ``d``, as the card reports
    it: query rows, threads and shared-memory bytes a block, blocks (and
    warps) resident on a SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
    and K/V ring slots. Needs the card."""
    from repro_torch.kernels.build import check_launch
    out = (ctypes.c_int * 5)()
    check_launch("flash_attention",
                 _lib().flash_attention_fp32_config(d, out))
    bq, threads, smem, blocks, stages = out
    return {"bq": bq, "threads": threads, "smem_bytes": smem,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "stages": stages}



def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"expected q [B,Hq,Sq,d], k and v [B,Hkv,Skv,d]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if skv < 1:
        raise ValueError("no keys: Skv must be >= 1")
    if d not in HEAD_DIMS:
        raise ValueError(f"d={d}: the kernel takes d in {HEAD_DIMS}")


def flash_attention(q, k, v, causal: bool = True):
    """q ``[B, Hq, Sq, d]``, k and v ``[B, Hkv, Skv, d]`` (Hq = G·Hkv),
    float32 or bfloat16 -> ``softmax(q·kᵀ/√d)·v`` ``[B, Hq, Sq, d]`` in q's
    dtype, as :func:`.ref.attention_ref`. ``causal`` masks key j from query
    i where j > i (aligned top-left); any Sq and Skv. The kernel has no
    backward: inputs that require grad (with grad enabled) are refused,
    on either device, rather than given a result without a gradient
    (training attends through ``models.attention.mea_attention``)."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention has no backward: its inputs "
                         "require grad (train through "
                         "repro_torch.models.attention.mea_attention)")
    return _flash_attention_op(q, k, v, bool(causal))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    """:func:`flash_attention` on checked inputs: the plain version for a
    CPU tensor, the kernel for a CUDA tensor."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention path for device {q.device}")
    from repro_torch.kernels.build import check_launch, count_launch
    lib = _lib()
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq > _GRID_YZ or b > _GRID_YZ:
        raise ValueError(f"B={b}, Hq={hq}: each must be <= {_GRID_YZ}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries: both "
                         "kernels copy rows as 16-byte vectors")
    splits = (_plan(b, hq, sq, skv, d, causal).splits
              if q.dtype == torch.float32 else 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            q.element_size(), b, hq, hkv, sq, skv, d, int(causal), splits,
            stream)
    check_launch("flash_attention", rc)
    count_launch(flash_attention)
    return o


@_flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal):
    return torch.empty_like(q)


flash_attention.launches = 0
