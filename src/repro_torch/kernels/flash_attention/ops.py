"""``flash_attention``: the attention of every prefill layer.

The tensors' device picks the path. On the CPU it runs the plain PyTorch
version (:mod:`.ref`); on a CUDA device it launches the hand-written kernel
(``csrc/flash_attention.cu``, built at first use by
:mod:`repro_torch.kernels.build`) on the current stream, without a sync, or
raises. bfloat16 runs on the tensor cores (``wgmma`` fed by TMA,
``csrc/flash_attention_bf16.cuh``); float32 on the CUDA cores. ``flash_attention.launches`` counts kernel launches, so a run can
show that its main path went through the kernel.

The work is the operator ``repro_torch::flash_attention``
(``torch.library.custom_op``), so a fake tensor (``FakeTensorMode``, the
dry run's traced steps) or a ``meta`` tensor is answered from its shape
and dtype alone (``register_fake``), with no library built and no launch;
a real tensor still takes its device's path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = (torch.float32, torch.bfloat16)
# every head width of the configs (MLA: nope + rope = 192)
HEAD_DIMS = (16, 32, 64, 128, 160, 192, 256)
_GRID_YZ = 65535       # CUDA's limit on gridDim.y (Hq) and gridDim.z (B)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    lib.flash_attention_launch.restype = i32
    return lib


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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            q.element_size(), b, hq, hkv, sq, skv, d, int(causal), stream)
    check_launch("flash_attention", rc)
    count_launch(flash_attention)
    return o


@_flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal):
    return torch.empty_like(q)


flash_attention.launches = 0
