"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400,
MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

First layer uses a dense MLP (d_ff 12288); layers 1..59 route over 160
experts (d_ff_expert=1536) + 2 shared experts.  MLA cache = 576 floats
per token (kv_lora 512 + rope 64), decode runs the absorbed path.
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig


def config(shape: ShapeSpec | None = None, sparse: bool = False) -> ModelConfig:
    max_seq = shape.seq_len if shape else 4096
    return ModelConfig(
        name="deepseek_v2_236b",
        n_layers=60,
        d_model=5120,
        vocab=102400,
        layer_types=(("mla", "mlp"),) + (("mla", "moe"),) * 59,
        d_ff=12288,  # the single dense layer
        act="swiglu",
        norm="rmsnorm",
        mla=MLAConfig(
            d_model=5120, n_heads=128, kv_lora=512, q_lora=1536,
            d_nope=128, d_rope=64, d_v=128, model_shards=16,
        ),
        moe=MoEConfig(
            d_model=5120, n_experts=160, top_k=6, d_ff_expert=1536,
            n_shared=2, model_shards=16,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        model_shards=16,
        max_seq=max_seq,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_v2_smoke",
        n_layers=3,
        d_model=64,
        vocab=512,
        layer_types=(("mla", "mlp"),) + (("mla", "moe"),) * 2,
        d_ff=128,
        mla=MLAConfig(d_model=64, n_heads=4, kv_lora=32, q_lora=48,
                      d_nope=16, d_rope=8, d_v=16, model_shards=1),
        moe=MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared=2, model_shards=1),
        model_shards=1,
        max_seq=64,
    )
