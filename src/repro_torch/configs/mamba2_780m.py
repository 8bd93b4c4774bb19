"""mamba2-780m [ssm]: 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

Technique note (DESIGN §4): pattern sparsity applies to in/out projections;
the SSD recurrence has no weight matrix to prune.  long_500k RUNS (state
recurrence, O(1) decode).
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig


def config(shape: ShapeSpec | None = None, sparse: bool = False) -> ModelConfig:
    max_seq = shape.seq_len if shape else 4096
    return ModelConfig(
        name="mamba2_780m",
        n_layers=48,
        d_model=1536,
        vocab=50280,
        layer_types=(("ssm", "none"),) * 48,
        d_ff=0,
        norm="rmsnorm",
        tie_embeddings=True,
        ssm=SSMConfig(
            d_model=1536, d_state=128, d_conv=4, expand=2, head_dim=64,
            n_groups=1, chunk=128, model_shards=16,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        model_shards=16,
        max_seq=max_seq,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_smoke",
        n_layers=4,
        d_model=64,
        vocab=512,
        layer_types=(("ssm", "none"),) * 4,
        d_ff=0,
        tie_embeddings=True,
        ssm=SSMConfig(d_model=64, d_state=16, head_dim=16, chunk=8,
                      model_shards=1),
        model_shards=1,
        max_seq=64,
    )
