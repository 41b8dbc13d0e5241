"""stablelm-12b — dense GQA.

[hf:stabilityai/stablelm-2-1_6b; hf]
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_head=160,
        d_ff=13824,
        vocab=100352,
        norm="layernorm",
        act="swiglu",
        rope_theta=10000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="stablelm-12b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=192,
        vocab=256,
        norm="layernorm",
        act="swiglu",
    )
