"""Config-driven transformer assembly.

Port of ``src/repro/models/transformer.py``.  A model is a sequence of
layers; each layer is a (mixer, ffn) pair, and ``layer_types`` lists
every layer:

  mixer: 'attn' | 'swa' | 'mla' (DeepSeek's latent attention,
         ``models.mla``) | 'ssm' (Mamba-2's SSD, ``models.ssm``) |
         'xattn' (whisper's decoder: self-attention, then cross-attention
         on the encoder's output)
  ffn:   'mlp' (dense or the paper's pattern-sparse MLP) | 'moe'
         (``models.moe``) | 'none'

The stack is factored into an optional non-periodic *prefix*
(DeepSeek's leading dense layers) plus a repeating *period* (jamba's
8-layer attention/Mamba/MoE unit); period params are stacked
``[n_periods, ...]`` as in the reference, and where the reference runs
them with ``lax.scan`` the port loops over the stacked tensors in
Python.  Enc-dec (whisper) adds an encoder stack, run over stub frame
embeddings (``frames``), whose output the decoder's cross-attention
reads; a VLM (paligemma) puts stub patch embeddings (``prefix_embeds``)
in front of the tokens; DeepSeek-V3 adds its MTP head.  The reference's
remat (``jax.checkpoint``) only trades memory for recompute and is left
out: a training step (``runtime.train``) keeps every activation.

Params are a plain dict of tensors; the statics (layer kinds, attention
and MLA configs, sparse layouts with their device index tables) come
from :func:`init_statics`, so params converted from the reference
(``models.convert``) and params drawn here share them.  Caches are
updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    AttnConfig,
    attention_apply,
    attention_apply_tp,
    attention_init,
    attention_specs,
    init_kv_cache,
    is_prefill,
)
from repro_torch.models.layers import (
    PatternSparseConfig,
    embed_init,
    embed_specs,
    layernorm,
    layernorm_init,
    layernorm_specs,
    linear,
    linear_init,
    linear_specs,
    mlp_apply,
    mlp_apply_tp,
    mlp_init,
    mlp_specs,
    mlp_static,
    rmsnorm,
    rmsnorm_init,
    rmsnorm_specs,
)
from repro_torch.models.mla import (
    MLAConfig,
    init_mla_cache,
    mla_apply,
    mla_init,
    mla_specs,
)
from repro_torch.models.moe import (
    MoEConfig,
    moe_apply,
    moe_apply_tp,
    moe_init,
    moe_specs,
    moe_static,
)
from repro_torch.models.ssm import (
    SSMConfig,
    init_ssm_cache,
    ssm_apply,
    ssm_init,
    ssm_specs,
)
from repro_torch.parallel import tensor
from repro_torch.parallel.activations import shard_activation
from repro_torch.parallel.sharding import pad_to_multiple

__all__ = ["ModelConfig", "find_structure", "init_statics", "init_params",
           "init_specs", "init_cache", "apply_model", "count_params"]

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    layer_types: tuple[tuple[str, str], ...]  # (mixer, ffn) per layer
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 128
    qkv_bias: bool = False
    window: int | None = None
    rope_theta: float | None = 10000.0
    # ffn
    d_ff: int = 0
    act: str = "swiglu"
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    mtp: bool = False
    # enc-dec (whisper): encoder layer count; encoder input is stub frame
    # embeddings [B, enc_seq, d_model]
    encoder_layers: int = 0
    enc_seq: int = 0
    # vlm (paligemma): patch embeddings [B, prefix_len, d_model] in front
    prefix_len: int = 0
    # sparsity (the paper's technique, block-granular)
    sparse: PatternSparseConfig | None = None
    # numerics / distribution
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    model_shards: int = 16
    remat: bool = True  # the reference's training flag; unused here
    vocab_pad: int = 256
    max_seq: int = 4096  # cache capacity for serving
    decode_strategy: str = "gather"  # 'gather' | 'flash' (see AttnConfig)

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab, self.vocab_pad)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def attn_cfg(self, window: bool) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_head=self.d_head,
            qkv_bias=self.qkv_bias,
            window=self.window if window else None,
            rope_theta=self.rope_theta,
            model_shards=self.model_shards,
            decode_strategy=self.decode_strategy,
        )


def find_structure(
    layer_types: Sequence[tuple[str, str]]
) -> tuple[int, int]:
    """Returns (prefix_len, period) minimizing the period over small
    prefixes — a 1-layer prefix + period-1 body (DeepSeek) wins over
    prefix-0 + period-n."""
    n = len(layer_types)
    best = (0, n if n else 1)
    for prefix in range(0, min(n, 5)):
        body = layer_types[prefix:]
        m = len(body)
        if m == 0:
            if 1 < best[1]:
                best = (prefix, 1)
            continue
        for period in range(1, m + 1):
            if m % period:
                continue
            if all(body[i] == body[i % period] for i in range(m)):
                if period < best[1]:
                    best = (prefix, period)
                break
    return best


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_static(cfg: ModelConfig, ltype: tuple[str, str], device) -> dict:
    mixer, ffn = ltype
    static: dict = {"mixer": mixer, "ffn": ffn}
    if mixer in ("attn", "swa"):
        static["attn_cfg"] = cfg.attn_cfg(window=mixer == "swa")
    elif mixer == "xattn":
        static["attn_cfg"] = cfg.attn_cfg(window=False)
        static["xattn_cfg"] = dataclasses.replace(
            static["attn_cfg"], causal=False, rope_theta=None)
    elif mixer == "mla":
        assert cfg.mla is not None
        static["mla_cfg"] = cfg.mla
    elif mixer == "ssm":
        assert cfg.ssm is not None
        static["ssm_cfg"] = cfg.ssm
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn == "mlp":
        static["mlp"] = mlp_static(cfg.d_model, cfg.d_ff, act=cfg.act,
                                   sparse=cfg.sparse,
                                   model_shards=cfg.model_shards,
                                   device=device)
    elif ffn == "moe":
        assert cfg.moe is not None
        static["moe"] = moe_static(cfg.moe, device)
    elif ffn != "none":
        raise ValueError(f"unknown ffn {ffn!r}")
    return static


def _layer_params(generator, cfg: ModelConfig, static: dict, device) -> dict:
    pdt = cfg.pdtype()
    norm_init = rmsnorm_init if cfg.norm == "rmsnorm" else layernorm_init
    params = {"norm1": norm_init(cfg.d_model, pdt, device)}
    if static["mixer"] == "mla":
        params["attn"] = mla_init(generator, static["mla_cfg"], pdt, device)
    elif static["mixer"] == "ssm":
        params["attn"] = ssm_init(generator, static["ssm_cfg"], pdt, device)
    else:
        params["attn"] = attention_init(generator, static["attn_cfg"], pdt,
                                        device)
    if static["mixer"] == "xattn":
        params["xnorm"] = norm_init(cfg.d_model, pdt, device)
        params["xattn"] = attention_init(generator, static["xattn_cfg"], pdt,
                                         device)
    if static["ffn"] != "none":
        params["norm2"] = norm_init(cfg.d_model, pdt, device)
    if static["ffn"] == "mlp":
        params["mlp"], _ = mlp_init(
            generator, cfg.d_model, cfg.d_ff, act=cfg.act, sparse=cfg.sparse,
            model_shards=cfg.model_shards, param_dtype=pdt, device=device,
        )
    elif static["ffn"] == "moe":
        params["moe"], _ = moe_init(generator, cfg.moe, pdt, device)
    return params


def init_statics(cfg: ModelConfig, device=None) -> dict:
    """The model's static part: the layer structure (prefix, period,
    number of periods), each layer's kind and attention, MLA or SSM
    config, the MTP layer's (``cfg.mtp``: the kind of the last layer),
    the encoder layers' (``cfg.encoder_layers``: bidirectional attention
    without RoPE, then the MLP), and the sparse MLP layouts with their
    index tables on ``device`` (``None``: ``cuda``, raising without
    one)."""
    device = resolve_device(device)
    prefix, period = find_structure(cfg.layer_types)
    n_periods = (cfg.n_layers - prefix) // period
    statics = {
        "cfg": cfg,
        "device": device,
        "prefix": prefix,
        "period": period,
        "n_periods": n_periods,
        "prefix_layers": [_layer_static(cfg, cfg.layer_types[i], device)
                          for i in range(prefix)],
        "body": [_layer_static(cfg, cfg.layer_types[prefix + j], device)
                 for j in range(period)],
    }
    if cfg.mtp:
        statics["mtp_layer"] = _layer_static(cfg, cfg.layer_types[-1],
                                             device)
    if cfg.encoder_layers:
        enc = _layer_static(cfg, ("attn", "mlp"), device)
        enc["attn_cfg"] = dataclasses.replace(enc["attn_cfg"], causal=False,
                                              rope_theta=None)
        statics["encoder"] = enc
    return statics


def _stacked_draws(draw, n: int):
    """``n`` param trees from ``draw()``, stacked leaf by leaf along a new
    leading axis.  Each draw is copied into its row and dropped before
    the next, so one layer's params live beside the stack, never all
    ``n`` (a DeepSeek MoE layer is 15 GB in float32)."""
    stacked = None
    for i in range(n):
        layer = draw()
        if stacked is None:
            stacked = _zeros_stack(layer, n)
        for dst, src in zip(_leaves(_index(stacked, i)), _leaves(layer)):
            dst.copy_(src)
        del layer
    return stacked


def _index(tree, i: int):
    """Row ``i`` of every leaf of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _zeros_stack(tree, n: int):
    """Zeros of every leaf's shape, dtype and device with ``n`` in front."""
    if isinstance(tree, dict):
        return {k: _zeros_stack(v, n) for k, v in tree.items()}
    return tree.new_zeros((n, *tree.shape))


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Returns (params, statics) for the full model on ``device``
    (``None``: ``cuda``, raising without one), with weights drawn from
    ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    statics = init_statics(cfg, device)
    pdt = cfg.pdtype()
    norm_init = rmsnorm_init if cfg.norm == "rmsnorm" else layernorm_init
    params: dict = {"embed": embed_init(generator, cfg.padded_vocab,
                                        cfg.d_model, pdt, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(generator, cfg.d_model,
                                        cfg.padded_vocab, param_dtype=pdt,
                                        device=device)
    params["final_norm"] = norm_init(cfg.d_model, pdt, device)
    if cfg.rope_theta is None:  # whisper-style learned decoder positions
        params["dec_pos"] = (torch.randn(
            (cfg.max_seq, cfg.d_model), generator=generator,
            dtype=torch.float32, device=device) * 0.02).to(pdt)
    params["prefix_layers"] = [
        _layer_params(generator, cfg, st, device)
        for st in statics["prefix_layers"]
    ]
    params["body"] = [
        _stacked_draws(lambda st=st: _layer_params(generator, cfg, st,
                                                   device),
                       statics["n_periods"])
        for st in statics["body"]
    ]
    if cfg.encoder_layers:  # whisper: learned positions, stacked layers
        params["enc_pos"] = (torch.randn(
            (cfg.enc_seq, cfg.d_model), generator=generator,
            dtype=torch.float32, device=device) * 0.02).to(pdt)
        params["encoder"] = _stacked_draws(
            lambda: _layer_params(generator, cfg, statics["encoder"], device),
            cfg.encoder_layers)
        params["enc_norm"] = norm_init(cfg.d_model, pdt, device)
    if cfg.mtp:  # next-next-token head sharing the output head
        params["mtp_layer"] = _layer_params(generator, cfg,
                                            statics["mtp_layer"], device)
        params["mtp_proj"] = linear_init(generator, 2 * cfg.d_model,
                                         cfg.d_model, param_dtype=pdt,
                                         device=device)
        params["mtp_norm"] = norm_init(cfg.d_model, pdt, device)
    return params, statics


def _layer_specs(cfg: ModelConfig, ltype: tuple[str, str]) -> dict:
    """The specs of one layer's params (:func:`_layer_params`)."""
    mixer, ffn = ltype
    norm = rmsnorm_specs if cfg.norm == "rmsnorm" else layernorm_specs
    specs: dict = {"norm1": norm()}
    if mixer == "mla":
        specs["attn"] = mla_specs(cfg.mla)
    elif mixer == "ssm":
        specs["attn"] = ssm_specs(cfg.ssm)
    elif mixer in ("attn", "swa", "xattn"):
        specs["attn"] = attention_specs(cfg.attn_cfg(window=mixer == "swa"))
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if mixer == "xattn":
        specs["xnorm"] = norm()
        specs["xattn"] = attention_specs(cfg.attn_cfg(window=False))
    if ffn != "none":
        specs["norm2"] = norm()
    if ffn == "mlp":
        specs["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, act=cfg.act,
                                 sparse=cfg.sparse,
                                 model_shards=cfg.model_shards)
    elif ffn == "moe":
        specs["moe"] = moe_specs(cfg.moe)
    elif ffn != "none":
        raise ValueError(f"unknown ffn {ffn!r}")
    return specs


def _stacked_specs(specs):
    """A stacked tree's specs: ``None`` in front of each leaf's, for the
    leading axis the layers stack on."""
    if isinstance(specs, dict):
        return {k: _stacked_specs(v) for k, v in specs.items()}
    return (None,) + tuple(specs)


def init_specs(cfg: ModelConfig) -> dict:
    """The logical-axis specs of :func:`init_params`'s params: the tree the
    reference's ``init_params`` returns second, leaf for leaf (a tuple of
    logical axis names, or ``None``, per dim).  The stacked ``body`` and
    ``encoder`` leaves get a leading ``None``, ``prefix_layers`` and
    ``body`` are lists, and ``lm_head`` is absent when the embeddings are
    tied.  Built from the config alone: no tensor is drawn and no device
    is touched, so a full config costs nothing."""
    norm = rmsnorm_specs if cfg.norm == "rmsnorm" else layernorm_specs
    specs: dict = {"embed": embed_specs()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = linear_specs("embed", "vocab")
    specs["final_norm"] = norm()
    if cfg.rope_theta is None:
        specs["dec_pos"] = ("seq", "embed")
    prefix, period = find_structure(cfg.layer_types)
    specs["prefix_layers"] = [_layer_specs(cfg, cfg.layer_types[i])
                              for i in range(prefix)]
    specs["body"] = [_stacked_specs(_layer_specs(
        cfg, cfg.layer_types[prefix + j])) for j in range(period)]
    if cfg.encoder_layers:
        specs["enc_pos"] = ("seq", "embed")
        specs["encoder"] = _stacked_specs(_layer_specs(cfg, ("attn", "mlp")))
        specs["enc_norm"] = norm()
    if cfg.mtp:
        specs["mtp_layer"] = _layer_specs(cfg, cfg.layer_types[-1])
        specs["mtp_proj"] = linear_specs("embed", "embed")
        specs["mtp_norm"] = norm()
    return specs


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _layer_cache(static, batch: int, max_seq: int, dtype, device):
    mixer = static["mixer"]
    if mixer in ("attn", "swa"):
        return init_kv_cache(static["attn_cfg"], batch, max_seq, dtype,
                             device)
    if mixer == "xattn":
        return {"self": init_kv_cache(static["attn_cfg"], batch, max_seq,
                                      dtype, device)}
    if mixer == "mla":
        return init_mla_cache(static["mla_cfg"], batch, max_seq, dtype,
                              device)
    if mixer == "ssm":  # float32 whatever ``dtype``, as the reference's
        return init_ssm_cache(static["ssm_cfg"], batch, device=device)
    raise ValueError(mixer)


def init_cache(statics, batch: int, max_seq: int | None = None,
               dtype=torch.bfloat16, device=None):
    """Zeroed caches per prefix layer, batch first (attention ``k``/``v``
    ``[B, T, Hkv, D]``, ``xattn``'s under ``"self"``, MLA ``c_kv``
    ``[B, T, kv_lora]`` and ``k_rope`` ``[B, T, d_rope]``, SSM ``conv``
    ``[B, d_conv - 1, conv_dim]`` and ``state`` ``[B, H, P, N]`` in
    float32 whatever ``dtype``), and the same with ``n_periods`` in front
    per period position, on ``device`` (default: the statics').  An
    encoder-decoder adds ``memory`` ``[B, enc_seq, d_model]``."""
    cfg: ModelConfig = statics["cfg"]
    max_seq = max_seq or cfg.max_seq
    device = device if device is not None else statics["device"]
    cache: dict = {
        "prefix_layers": [_layer_cache(st, batch, max_seq, dtype, device)
                          for st in statics["prefix_layers"]],
        "body": [],
    }
    for st in statics["body"]:
        one = _layer_cache(st, batch, max_seq, dtype, device)
        cache["body"].append(_zeros_stack(one, statics["n_periods"]))
    if cfg.encoder_layers:
        cache["memory"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                      dtype=dtype, device=device)
    return cache


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _apply_layer(params, static, cfg: ModelConfig, x, positions, cache,
                 cache_pos, cache_len, prefill: bool, memory=None,
                 kernels: bool = True):
    tp = tensor.current()
    if tp is not None:
        return _apply_layer_tp(tp, params, static, cfg, x, positions, cache,
                               memory, kernels)
    norm = rmsnorm if cfg.norm == "rmsnorm" else layernorm
    mixer = static["mixer"]
    h = norm(params["norm1"], x)
    if mixer == "mla":
        out, new_cache = mla_apply(
            params["attn"], static["mla_cfg"], h, positions,
            cache=cache, cache_pos=cache_pos, cache_len=cache_len,
        )
    elif mixer == "ssm":  # its route follows S == 1 alone, not ``prefill``
        out, new_cache = ssm_apply(params["attn"], static["ssm_cfg"], h,
                                   cache)
    elif mixer == "xattn":
        out, _ = attention_apply(
            params["attn"], static["attn_cfg"], h, positions,
            cache=cache["self"] if cache is not None else None,
            cache_pos=cache_pos, cache_len=cache_len, prefill=prefill,
        )
        x = x + out
        h = norm(params["xnorm"], x)
        out, _ = attention_apply(params["xattn"], static["xattn_cfg"], h,
                                 positions, memory=memory, prefill=False)
        new_cache = cache
    else:
        out, new_cache = attention_apply(
            params["attn"], static["attn_cfg"], h, positions,
            cache=cache, cache_pos=cache_pos, cache_len=cache_len,
            prefill=prefill,
        )
    x = x + out
    if static["ffn"] != "none":
        h = norm(params["norm2"], x)
        if static["ffn"] == "mlp":
            x = x + mlp_apply(params["mlp"], static["mlp"], h, kernels)
        else:
            x = x + moe_apply(params["moe"], static["moe"], cfg.moe, h,
                              kernels)
    x = shard_activation(x, ("batch", "seq_shard", None))
    return x, new_cache


def _apply_layer_tp(tp, params, static, cfg: ModelConfig, x, positions,
                    cache, memory, kernels: bool):
    """One layer inside the sharded train step's
    ``parallel.tensor.tensor_parallel_ctx``: the blocks of
    ``tensor.layer_splits`` on this rank's slabs of ``tp``'s ``model``
    group, the rest (MLA, the SSM, norms) whole, and MoE's capacity the
    whole batch's (``moe.moe_apply_tp``).  Training keeps no cache."""
    if cache is not None:
        raise ValueError("tensor-parallel compute is the train step's: it "
                         "keeps no cache")
    split = tensor.layer_splits(cfg, static, tp.size)
    norm = rmsnorm if cfg.norm == "rmsnorm" else layernorm
    mixer = static["mixer"]

    def attend(name, key, h, mem=None):
        if name in split:
            return attention_apply_tp(tp, params[name], static[key], h,
                                      positions, memory=mem)
        return attention_apply(params[name], static[key], h, positions,
                               memory=mem, prefill=False)[0]

    h = norm(params["norm1"], x)
    if mixer == "mla":
        out, _ = mla_apply(params["attn"], static["mla_cfg"], h, positions)
    elif mixer == "ssm":
        out, _ = ssm_apply(params["attn"], static["ssm_cfg"], h, None)
    else:
        out = attend("attn", "attn_cfg", h)
    if mixer == "xattn":
        x = x + out
        out = attend("xattn", "xattn_cfg", norm(params["xnorm"], x), memory)
    x = x + out
    if static["ffn"] == "none":
        return x, None
    h = norm(params["norm2"], x)
    if static["ffn"] == "moe":
        return x + moe_apply_tp(tp, params["moe"], static["moe"], cfg.moe, h,
                                "moe" in split, kernels), None
    if "mlp" in split:
        return x + mlp_apply_tp(tp, params["mlp"], static["mlp"], h,
                                kernels), None
    return x + mlp_apply(params["mlp"], static["mlp"], h, kernels), None


def _encode(params, statics, cfg: ModelConfig, frames: torch.Tensor,
            kernels: bool = True):
    """Whisper encoder over stub frame embeddings [B, enc_seq, d]: every
    layer bidirectional at positions ``arange(enc_seq)`` without a cache,
    so its attention is a prefill in the kernel route's sense (the plain
    routes with ``kernels=False``)."""
    norm = rmsnorm if cfg.norm == "rmsnorm" else layernorm
    x = frames.to(cfg.cdtype()) + params["enc_pos"].to(cfg.cdtype())
    pos = torch.arange(frames.shape[1], device=frames.device)
    for i in range(cfg.encoder_layers):
        x, _ = _apply_layer(_index(params["encoder"], i), statics["encoder"],
                            cfg, x, pos, None, None, None, kernels,
                            kernels=kernels)
    return norm(params["enc_norm"], x)


def apply_model(
    params,
    statics,
    tokens: torch.Tensor,  # [B, S] integer
    positions: torch.Tensor | None = None,  # [S] (shared) or [B, S] (per-row)
    cache=None,
    cache_pos=None,  # scalar or [B] (per-slot decode)
    cache_len=None,  # scalar or [B]
    prefix_embeds: torch.Tensor | None = None,
    frames: torch.Tensor | None = None,
    prefill: bool | None = None,
    kernels: bool = True,
):
    """Forward pass.  Returns (logits [B, S(+P), vocab_padded], cache,
    aux); the cache, when given, is written in place and returned.  With
    ``cfg.mtp`` and no cache, ``aux["mtp_logits"]`` [B, S, vocab_padded]
    are the next-next-token head's.

    A VLM's stub patch embeddings ``prefix_embeds`` [B, P, d] go in front
    of the embedded tokens (after the tokens' ``sqrt(d_model)`` scale,
    which they do not get), in the compute dtype, as the reference puts
    them: the sequence is then P + S long, ``positions`` default to
    ``arange(P + S)``, every layer attends over the prefix causally, and
    the logits cover all P + S positions.

    An encoder-decoder encodes ``frames`` [B, enc_seq, d] when given and
    stores the encoder's output as the cache's ``memory`` (replacing the
    entry, in the compute dtype, as the reference's new cache holds it);
    without ``frames`` it reads ``cache["memory"]``.

    ``prefill`` picks the attention route for every layer at once: the
    flash kernel where it is true (a prefill at positions ``arange(S)``
    from cache position 0, see ``models.attention``), the plain routes
    where it is false; ``None`` decides it here from ``positions`` and
    ``cache_pos``, with one read of the device.

    ``kernels=False`` sends every layer to its plain version, whatever
    ``prefill`` says: the decoder's and the encoder's attention to the
    full or chunked route, and an ungrouped sparse linear to
    ``core.sparse.pattern_spmm_torch``.  Autograd differentiates those,
    and the kernel wrappers refuse inputs that require grad, so a
    training step passes it (``runtime.train``).  Serving keeps the
    default."""
    cfg: ModelConfig = statics["cfg"]
    cdt = cfg.cdtype()
    _, s = tokens.shape

    x = params["embed"]["w"][tokens].to(cdt)
    if cfg.tie_embeddings:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=cdt)  # gemma convention
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cdt), x], dim=1)
        s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    if not kernels:
        prefill = False
    elif prefill is None:
        prefill = is_prefill(s, positions, cache=cache, cache_pos=cache_pos)
    if "dec_pos" in params:
        dp = params["dec_pos"][positions].to(cdt)
        x = x + (dp if positions.dim() == 2 else dp[None])
    x = shard_activation(x, ("batch", "seq_shard", None))

    memory = None
    if cfg.encoder_layers:
        if frames is not None:
            memory = _encode(params, statics, cfg, frames, kernels)
            if cache is not None:
                cache["memory"] = memory
        elif cache is not None:
            memory = cache["memory"]

    for i, (p, st) in enumerate(zip(params["prefix_layers"],
                                    statics["prefix_layers"])):
        c = cache["prefix_layers"][i] if cache is not None else None
        x, _ = _apply_layer(p, st, cfg, x, positions, c, cache_pos, cache_len,
                            prefill, memory, kernels)

    for rep in range(statics["n_periods"]):
        for j, st in enumerate(statics["body"]):
            c = _index(cache["body"][j], rep) if cache is not None else None
            x, _ = _apply_layer(_index(params["body"][j], rep), st, cfg, x,
                                positions, c, cache_pos, cache_len, prefill,
                                memory, kernels)

    norm = rmsnorm if cfg.norm == "rmsnorm" else layernorm
    hidden = norm(params["final_norm"], x)
    logits = _head(params, cfg, hidden)

    aux = {}
    if cfg.mtp and cache is None:
        # next-next-token head: combine hidden_t with embed(token_{t+1})
        nxt = torch.roll(tokens, -1, dims=1)
        e_next = params["embed"]["w"][nxt].to(cdt)
        h_mtp = linear(params["mtp_proj"], torch.cat([hidden, e_next], -1))
        h_mtp, _ = _apply_layer(params["mtp_layer"], statics["mtp_layer"],
                                cfg, h_mtp, positions, None, None, None,
                                prefill, kernels=kernels)
        aux["mtp_logits"] = _head(params, cfg,
                                  norm(params["mtp_norm"], h_mtp))
    return logits, cache, aux


def _head(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return hidden @ params["embed"]["w"].to(cfg.cdtype()).T
    return linear(params["lm_head"], hidden)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_params(params) -> int:
    return sum(int(x.numel()) for x in _leaves(params))
