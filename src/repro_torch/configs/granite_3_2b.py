"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA.  [hf:ibm-granite/granite-3.0-2b-base; hf]
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.layers import PatternSparseConfig
from repro_torch.models.transformer import ModelConfig


def config(shape: ShapeSpec | None = None, sparse: bool = False) -> ModelConfig:
    max_seq = shape.seq_len if shape else 4096
    return ModelConfig(
        name="granite_3_2b",
        n_layers=40,
        d_model=2048,
        vocab=49155,
        layer_types=(("attn", "mlp"),) * 40,
        n_heads=32,
        n_kv_heads=8,
        d_head=64,
        rope_theta=10000.0,
        d_ff=8192,
        act="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
        sparse=PatternSparseConfig(density=0.25, num_patterns=8) if sparse
        else None,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        model_shards=16,
        max_seq=max_seq,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite_3_2b_smoke",
        n_layers=2,
        d_model=128,
        vocab=515,  # non-multiple, exercises vocab padding
        layer_types=(("attn", "mlp"),) * 2,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        d_ff=256,
        tie_embeddings=True,
        model_shards=1,
        max_seq=64,
    )
