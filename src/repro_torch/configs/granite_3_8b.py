"""granite-3-8b — dense GQA.

[hf:ibm-granite/granite-3.0-2b-base; hf]
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=12800,
        vocab=49155,
        tie_embeddings=True,
        norm="rmsnorm",
        act="swiglu",
        rope_theta=10000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=192,
        vocab=256,
        tie_embeddings=True,
        norm="rmsnorm",
        act="swiglu",
    )
