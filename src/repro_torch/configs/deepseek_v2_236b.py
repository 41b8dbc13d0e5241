"""deepseek-v2-236b — MLA attention + fine-grained MoE (2 shared + 160 routed, top-6).

[arXiv:2405.04434; hf]
60L d_model=5120 128H d_ff=1536 (per routed expert) vocab=102400,
MLA kv_lora=512, first layer dense FFN (12288).
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b",
        family="mla_moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,   # MLA: heads share one latent; kv head count == q heads
        d_head=128,       # nope dim (v head dim matches)
        d_ff=1536,
        vocab=102400,
        n_experts=160,
        top_k=6,
        n_shared_experts=2,
        d_ff_expert=1536,
        first_k_dense=1,
        d_ff_dense=12288,
        q_lora_rank=1536,
        kv_lora_rank=512,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        norm="rmsnorm",
        act="swiglu",
        rope_theta=10000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b-reduced",
        family="mla_moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=32,
        vocab=256,
        n_experts=8,
        top_k=2,
        n_shared_experts=1,
        d_ff_expert=32,
        first_k_dense=1,
        d_ff_dense=128,
        q_lora_rank=32,
        kv_lora_rank=16,
        rope_head_dim=8,
        nope_head_dim=16,
        v_head_dim=16,
        norm="rmsnorm",
        act="swiglu",
    )
