"""smollm-135m — llama-arch small dense model.

[hf:HuggingFaceTB/SmolLM-135M; hf]
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_head=64,
        d_ff=1536,
        vocab=49152,
        tie_embeddings=True,
        norm="rmsnorm",
        act="swiglu",
        rope_theta=10000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="smollm-135m-reduced",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=3,
        n_kv_heads=1,
        d_head=16,
        d_ff=128,
        vocab=256,
        tie_embeddings=True,
        norm="rmsnorm",
        act="swiglu",
    )
