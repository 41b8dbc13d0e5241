"""whisper-tiny — encoder-decoder audio backbone; conv frontend is a STUB.

[arXiv:2212.04356; unverified]
4L (encoder) + 4L (decoder) d_model=384 6H d_ff=1536 vocab=51865.
``input_specs()`` provides precomputed frame embeddings in place of the
log-mel + conv1d stem, per the task spec.
"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="audio_encdec",
        n_layers=4,  # per stack (4 encoder + 4 decoder)
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_head=64,
        d_ff=1536,
        vocab=51865,
        norm="layernorm",
        act="gelu",
        notes="enc-dec; absolute (encoder) / learned (decoder) positions",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny-reduced",
        family="audio_encdec",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab=256,
        norm="layernorm",
        act="gelu",
    )
