"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma.  [arXiv:2407.07726; hf]

The SigLIP vision tower is a stub per the assignment: the caller passes
precomputed patch embeddings [B, 256, d_model] as ``prefix_embeds``,
which prefix the token sequence (``models.transformer.apply_model``);
:func:`extra_inputs` gives their ``meta`` stand-in for the dry run.
Backbone is gemma-2b style: MQA (kv=1), gelu MLP, tied embeddings scaled
by sqrt(d_model).  Its head width of 256 runs the flash kernel's 256-wide
build at every prefill (8 q heads padded to 16 over the one kv head).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.transformer import ModelConfig

N_PATCHES = 256


def config(shape: ShapeSpec | None = None, sparse: bool = False) -> ModelConfig:
    max_seq = shape.seq_len if shape else 4096
    return ModelConfig(
        name="paligemma_3b",
        n_layers=18,
        d_model=2048,
        vocab=257216,
        layer_types=(("attn", "mlp"),) * 18,
        n_heads=8,
        n_kv_heads=1,
        d_head=256,
        rope_theta=10000.0,
        d_ff=16384,
        act="gelu",
        norm="rmsnorm",
        tie_embeddings=True,
        prefix_len=N_PATCHES,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        model_shards=16,
        max_seq=max_seq,
    )


def extra_inputs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    if shape.kind == "decode":
        return {}  # patches were consumed at prefill; cache holds them
    return {"prefix_embeds": torch.empty(
        (shape.global_batch, cfg.prefix_len, cfg.d_model),
        dtype=cfg.cdtype(), device="meta")}


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma_smoke",
        n_layers=2,
        d_model=64,
        vocab=512,
        layer_types=(("attn", "mlp"),) * 2,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=128,
        act="gelu",
        tie_embeddings=True,
        prefix_len=8,
        model_shards=1,
        max_seq=64,
    )
