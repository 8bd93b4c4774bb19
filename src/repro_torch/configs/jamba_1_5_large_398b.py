"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

Layer pattern: 9 blocks of 8 layers; one attention layer per block
(position 4), Mamba elsewhere (1:7); MoE replaces the MLP on every other
layer.  long_500k RUNS (hybrid: SSM state + 9 attention layers whose decode
is O(S) reads on a sequence-sharded cache).
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig


def _layer_types(n_layers: int = 72) -> tuple:
    out = []
    for i in range(n_layers):
        mixer = "attn" if i % 8 == 4 else "ssm"
        ffn = "moe" if i % 2 == 1 else "mlp"
        out.append((mixer, ffn))
    return tuple(out)


def config(shape: ShapeSpec | None = None, sparse: bool = False) -> ModelConfig:
    max_seq = shape.seq_len if shape else 4096
    return ModelConfig(
        name="jamba_1_5_large_398b",
        n_layers=72,
        d_model=8192,
        vocab=65536,
        layer_types=_layer_types(72),
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        rope_theta=10000.0,
        d_ff=24576,
        act="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(
            d_model=8192, n_experts=16, top_k=2, d_ff_expert=24576,
            model_shards=16,
        ),
        ssm=SSMConfig(
            d_model=8192, d_state=16, d_conv=4, expand=2, head_dim=64,
            n_groups=1, chunk=128, model_shards=16,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        model_shards=16,
        max_seq=max_seq,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba_smoke",
        n_layers=8,
        d_model=64,
        vocab=512,
        layer_types=_layer_types(8),
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        moe=MoEConfig(d_model=64, n_experts=4, top_k=2, d_ff_expert=32,
                      model_shards=1),
        ssm=SSMConfig(d_model=64, d_state=8, head_dim=16, chunk=8,
                      model_shards=1),
        model_shards=1,
        max_seq=64,
    )
