"""dbrx-132b — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=10752,
        vocab=100352,
        n_experts=16,
        top_k=4,
        d_ff_expert=10752,
        norm="layernorm",
        act="swiglu",
        rope_theta=500000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b-reduced",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=96,
        vocab=256,
        n_experts=4,
        top_k=2,
        d_ff_expert=96,
        norm="layernorm",
        act="swiglu",
    )
