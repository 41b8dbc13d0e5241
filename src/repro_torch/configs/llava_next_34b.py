"""llava-next-34b — VLM; dense backbone, anyres tiling frontend (stub).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The vision frontend is a STUB per the task spec: ``input_specs()`` provides
precomputed patch embeddings which the backbone prepends to the token stream.
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_head=128,
        d_ff=20480,
        vocab=64000,
        n_patches=576,
        norm="rmsnorm",
        act="swiglu",
        rope_theta=5000000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="llava-next-34b-reduced",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=256,
        n_patches=8,
        norm="rmsnorm",
        act="swiglu",
    )
