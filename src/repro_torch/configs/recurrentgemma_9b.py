"""recurrentgemma-9b — Griffin: RG-LRU recurrent blocks + local attention, 1:2.

[arXiv:2402.19427; unverified]
38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window 2048.
Pattern (rec, rec, attn) repeating; 38 = 12*(3) + 2 trailing recurrent.
Sub-quadratic: runs long_500k (bounded-window KV + constant RG-LRU state).
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_head=256,
        d_ff=12288,
        vocab=256000,
        rnn_width=4096,
        attn_window=2048,
        pattern=("rec", "rec", "attn"),
        conv1d_width=4,
        norm="rmsnorm",
        act="geglu",
        rope_theta=10000.0,
        sub_quadratic=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b-reduced",
        family="hybrid",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=128,
        vocab=256,
        rnn_width=64,
        attn_window=16,
        pattern=("rec", "rec", "attn"),
        conv1d_width=4,
        norm="rmsnorm",
        act="geglu",
        sub_quadratic=True,
    )
