"""phi4-mini-3.8b — dense, RoPE SwiGLU GQA, 200k vocab.

[arXiv:2412.08905; hf]
32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab=200064,
        tie_embeddings=True,
        norm="rmsnorm",
        act="swiglu",
        rope_theta=10000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=160,
        vocab=512,
        tie_embeddings=True,
        norm="rmsnorm",
        act="swiglu",
    )
