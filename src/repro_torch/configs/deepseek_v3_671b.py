"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048 vocab=129280,
MoE 256e top-8 — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]

First 3 layers dense (d_ff 18432); MTP adds the next-next-token layer
sharing the output head.  Optimizer states run in bf16 at this scale
(DESIGN §6 memory budget: 671B x 8B/param over 512 chips).
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig


def config(shape: ShapeSpec | None = None, sparse: bool = False) -> ModelConfig:
    max_seq = shape.seq_len if shape else 4096
    return ModelConfig(
        name="deepseek_v3_671b",
        n_layers=61,
        d_model=7168,
        vocab=129280,
        layer_types=(("mla", "mlp"),) * 3 + (("mla", "moe"),) * 58,
        d_ff=18432,  # the three dense layers
        act="swiglu",
        norm="rmsnorm",
        mla=MLAConfig(
            d_model=7168, n_heads=128, kv_lora=512, q_lora=1536,
            d_nope=128, d_rope=64, d_v=128, model_shards=16,
        ),
        moe=MoEConfig(
            d_model=7168, n_experts=256, top_k=8, d_ff_expert=2048,
            n_shared=1, model_shards=16,
        ),
        mtp=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        model_shards=16,
        max_seq=max_seq,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_v3_smoke",
        n_layers=4,
        d_model=64,
        vocab=512,
        layer_types=(("mla", "mlp"),) * 2 + (("mla", "moe"),) * 2,
        d_ff=128,
        mla=MLAConfig(d_model=64, n_heads=4, kv_lora=32, q_lora=48,
                      d_nope=16, d_rope=8, d_v=16, model_shards=1),
        moe=MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared=1, model_shards=1),
        mtp=True,
        model_shards=1,
        max_seq=64,
    )
