"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; hf]

SWA (window 4096) makes decode O(window): long_500k RUNS for this arch.
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.layers import PatternSparseConfig
from repro_torch.models.transformer import ModelConfig

WINDOW = 4096


def config(shape: ShapeSpec | None = None, sparse: bool = False) -> ModelConfig:
    max_seq = shape.seq_len if shape else 4096
    return ModelConfig(
        name="h2o_danube_1_8b",
        n_layers=24,
        d_model=2560,
        vocab=32000,
        layer_types=(("swa", "mlp"),) * 24,
        n_heads=32,
        n_kv_heads=8,
        d_head=80,
        window=WINDOW,
        rope_theta=10000.0,
        d_ff=6912,
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
        name="h2o_danube_1_8b_smoke",
        n_layers=2,
        d_model=128,
        vocab=512,
        layer_types=(("swa", "mlp"),) * 2,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        window=16,
        d_ff=256,
        model_shards=1,
        max_seq=64,
    )
