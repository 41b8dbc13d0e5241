"""Configuration dataclasses of the PyTorch port.

* :class:`ArchConfig` — an LM-family transformer architecture, a
  field-for-field copy of ``repro.config.ArchConfig`` (the port serves the
  ``dense``, ``moe`` and ``mla_moe`` families so far).
* :class:`ShapeConfig`, :data:`LM_SHAPES`, :data:`SHAPES_BY_NAME` and
  :func:`shape_applicable` — the LM cells (input shape × step) of the dry
  run, copies of ``repro.config``'s.
* :class:`TrainConfig` — optimizer knobs (AdamW, its warmup-cosine
  schedule, gradient clipping), a field-for-field copy of
  ``repro.config.TrainConfig``, with the same defaults.
* :class:`ForestConfig` — ForestFlow / ForestDiffusion hyperparameters.

``ForestConfig`` is a field-for-field copy of ``repro.config.ForestConfig``
(the JAX package's config), so ``ForestConfig(**meta["config"])`` accepts every JSON sidecar the
JAX trainer writes and the port writes sidecars the JAX package reads.

Fields that only steer the JAX trainer or its TPU kernels are kept for that
round trip and ignored here:

* ``predict_impl`` ("xla" | "pallas" | "pallas_interpret") — in the port the
  device of the tensors picks the tree-predict path: a CPU tensor takes the
  plain PyTorch version, a CUDA tensor the hand-written kernel
  (:mod:`repro_torch.kernels.tree_predict.ops`).

``split_reduce`` (how the sharded trainer reduces histograms over its data
ranks), ``hist_bf16`` and ``int8_codes`` steer the port's trainer as they
steer the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """An LM-family architecture description.

    ``family`` selects the block assembly:
      - ``dense``: pre-LN GQA transformer (llama-style, SwiGLU)
      - ``moe``: dense attention + top-k routed experts (dbrx-style)
      - ``mla_moe``: MLA attention + shared/routed experts (deepseek-v2-style)
      - ``vlm``: dense backbone consuming stub patch embeddings + tokens
      - ``audio_encdec``: whisper-style encoder/decoder over stub frames
      - ``ssm``: xLSTM (mLSTM/sLSTM blocks)
      - ``hybrid``: recurrentgemma (RG-LRU blocks + interleaved local attention)
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0       # deepseek: first layer(s) use a dense FFN
    d_ff_dense: int = 0          # width of that dense FFN
    # --- MLA (deepseek-v2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0
    # --- recurrent / hybrid ---
    rnn_width: int = 0           # RG-LRU / xLSTM inner width
    attn_window: int = 0         # local attention window (hybrid)
    pattern: Tuple[str, ...] = ()  # repeating block pattern, e.g. ("rec","rec","attn")
    conv1d_width: int = 4        # temporal conv width in recurrent blocks
    # --- modality stubs ---
    n_patches: int = 0           # vlm: stub image patches prepended to the sequence
    # --- misc ---
    tie_embeddings: bool = False
    norm: str = "rmsnorm"        # or "layernorm"
    act: str = "swiglu"          # or "geglu", "gelu"
    rope_theta: float = 10000.0
    sub_quadratic: bool = False  # eligible for long_500k
    notes: str = ""

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: seq_len x global_batch and which step runs."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four LM shapes assigned to every architecture.
LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME: Dict[str, ShapeConfig] = {s.name: s for s in LM_SHAPES}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable; the reason if not.

    ``long_500k`` needs sub-quadratic attention: only the SSM / hybrid
    archs qualify. Every arch has a decoder, so decode shapes always
    apply."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, (
            "skipped: full-attention arch; 524288-token KV/attention is "
            "quadratic (documented in DESIGN.md)"
        )
    return True, ""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs shared across architectures and the NN baselines."""

    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"   # master params
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    remat_policy: str = "full"     # "full" | "dots" | "none"
    scan_layers: bool = True
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """ForestFlow / ForestDiffusion hyperparameters (paper Table 9)."""

    method: str = "flow"       # "flow" (CFM) | "diffusion" (VP-SDE score matching)
    n_t: int = 50              # timestep discretisation
    duplicate_k: int = 100     # K-fold duplication for expectation coverage
    n_trees: int = 100         # max boosting rounds per ensemble
    max_depth: int = 7
    learning_rate: float = 0.3  # eta
    reg_lambda: float = 0.0
    min_child_weight: float = 1e-6
    n_bins: int = 64           # histogram bins
    multi_output: bool = False  # MO trees (vector leaves) vs SO (per-feature ensembles)
    early_stop_rounds: int = 0  # 0 disables (paper n_ES=20 when enabled)
    sigma: float = 0.0          # CFM bridge noise
    eps_diff: float = 1e-3      # diffusion min time (paper epsilon)
    diff_sampler: str = "ddim"  # "ddim" (stable exp-integrator) | "em" (paper)
    per_class_scalers: bool = True
    label_sampler: str = "label"  # "label" (empirical) | "multinomial"
    t_schedule: str = "uniform"  # | "cosine" (denser near t=0)
    split_reduce: str = "allreduce"  # sharded trainer: | "reduce_scatter"
    hist_bf16: bool = False     # round histograms to bf16 before split search
    int8_codes: bool = False    # store bin codes at the narrowest int type
    predict_impl: Optional[str] = None  # ignored: the device picks the path
    seed: int = 0
