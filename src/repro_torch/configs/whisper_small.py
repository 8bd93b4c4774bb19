"""whisper-small [audio]: 12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865
— enc-dec, conv frontend (stub).  [arXiv:2212.04356; unverified]

The 12-layer figure is per stack (12 encoder + 12 decoder).  The conv
frontend is a stub per the assignment: the caller passes precomputed
frame embeddings [B, 1500, d_model] as ``frames``; :func:`extra_inputs`
gives their ``meta`` stand-in for the dry run.  Decoder uses learned
positions (rope_theta=None) and layernorm, per the paper.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.transformer import ModelConfig

ENC_SEQ = 1500


def config(shape: ShapeSpec | None = None, sparse: bool = False) -> ModelConfig:
    max_seq = shape.seq_len if shape else 4096
    return ModelConfig(
        name="whisper_small",
        n_layers=12,
        d_model=768,
        vocab=51865,
        layer_types=(("xattn", "mlp"),) * 12,
        n_heads=12,
        n_kv_heads=12,
        d_head=64,
        rope_theta=None,  # learned positions
        d_ff=3072,
        act="gelu",
        norm="layernorm",
        encoder_layers=12,
        enc_seq=ENC_SEQ,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        model_shards=16,
        max_seq=max_seq,
    )


def extra_inputs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return {"frames": torch.empty(
        (shape.global_batch, cfg.enc_seq, cfg.d_model), dtype=cfg.cdtype(),
        device="meta")}


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper_small_smoke",
        n_layers=2,
        d_model=64,
        vocab=512,
        layer_types=(("xattn", "mlp"),) * 2,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        rope_theta=None,
        d_ff=128,
        act="gelu",
        norm="layernorm",
        encoder_layers=2,
        enc_seq=24,
        model_shards=1,
        max_seq=64,
    )
