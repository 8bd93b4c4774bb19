"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-32B family; hf]

Paper technique: block-pattern sparse MLP (gate/up/down) — the flagship
dense target (DESIGN §4).
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.layers import PatternSparseConfig
from repro_torch.models.transformer import ModelConfig


def config(shape: ShapeSpec | None = None, sparse: bool = False) -> ModelConfig:
    max_seq = shape.seq_len if shape else 4096
    return ModelConfig(
        name="qwen2_5_32b",
        n_layers=64,
        d_model=5120,
        vocab=152064,
        layer_types=(("attn", "mlp"),) * 64,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        qkv_bias=True,
        rope_theta=1e6,
        d_ff=27648,
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
        name="qwen2_5_32b_smoke",
        n_layers=2,
        d_model=128,
        vocab=512,
        layer_types=(("attn", "mlp"),) * 2,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        qkv_bias=True,
        d_ff=256,
        model_shards=1,
        max_seq=64,
    )
