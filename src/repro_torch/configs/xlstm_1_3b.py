"""xlstm-1.3b — sLSTM + mLSTM blocks (SSM family).

[arXiv:2405.04517; unverified]
48L d_model=2048 4H d_ff=0 (blocks carry their own up/down projections)
vocab=50304. Pattern: 1 sLSTM per 8 blocks (7 mLSTM : 1 sLSTM), both
expressed as associative-scannable linear recurrences (see DESIGN.md §8 on
the parallelizable sLSTM approximation). Sub-quadratic: runs long_500k.
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_head=512,
        d_ff=0,
        vocab=50304,
        rnn_width=4096,  # 2x up-projection inside mLSTM blocks
        pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
        conv1d_width=4,
        norm="rmsnorm",
        act="swiglu",
        sub_quadratic=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b-reduced",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_head=32,
        d_ff=0,
        vocab=256,
        rnn_width=128,
        pattern=("mlstm", "slstm"),
        conv1d_width=4,
        norm="rmsnorm",
        act="swiglu",
        sub_quadratic=True,
    )
