"""Plain PyTorch attention: the flash-attention kernel's reference.

A port of ``repro.kernels.flash_attention.ref.attention_ref``: GQA by
reshape (K/V are not repeated), the causal mask filled with -1e30, softmax
in fp32, the output in q's dtype. The CPU path of
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` and the
tests' reference.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: ``[B, Hq, Sq, d]``; k, v: ``[B, Hkv, Skv, d]``; Hq = G * Hkv.

    The causal mask is aligned top-left: query i sees keys j <= i."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / (d ** 0.5)
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)
