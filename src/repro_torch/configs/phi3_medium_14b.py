"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]

kv=10 does not divide the 16-way TP axis: kv projections replicate, q heads
pad 40->48, and the kv *cache* shards on (batch, seq) — DESIGN §4.
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.layers import PatternSparseConfig
from repro_torch.models.transformer import ModelConfig


def config(shape: ShapeSpec | None = None, sparse: bool = False) -> ModelConfig:
    max_seq = shape.seq_len if shape else 4096
    return ModelConfig(
        name="phi3_medium_14b",
        n_layers=40,
        d_model=5120,
        vocab=100352,
        layer_types=(("attn", "mlp"),) * 40,
        n_heads=40,
        n_kv_heads=10,
        d_head=128,
        rope_theta=10000.0,
        d_ff=17920,
        act="swiglu",
        norm="rmsnorm",
        sparse=PatternSparseConfig(density=0.25, num_patterns=8) if sparse
        else None,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        model_shards=16,
        max_seq=max_seq,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3_medium_14b_smoke",
        n_layers=2,
        d_model=120,
        vocab=512,
        layer_types=(("attn", "mlp"),) * 2,
        n_heads=6,
        n_kv_heads=3,  # non-divisible into heads*2: exercises kv repeat
        d_head=20,
        d_ff=256,
        model_shards=1,
        max_seq=64,
    )
