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
in front of the tokens; DeepSeek-V3 adds its MTP head.  With
``cfg.remat`` (the default, as the reference's), a forward that autograd
records keeps only each period's and each encoder layer's input and
recomputes the rest in the backward (:func:`_remat`), the reference's
``jax.checkpoint(..., nothing_saveable)``.

Params are a plain dict of tensors; the statics (layer kinds, attention
and MLA configs, sparse layouts with their device index tables) come
from :func:`init_statics`, so params converted from the reference
(``models.convert``) and params drawn here share them.  Caches are
updated in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    AttnConfig,
    PlacedCache,
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
    mla_apply_tp,
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
    ssm_apply_tp,
    ssm_init,
    ssm_specs,
)
from repro_torch.parallel import tensor
from repro_torch.parallel.activations import shard_activation
from repro_torch.parallel.sharding import pad_to_multiple

__all__ = ["ModelConfig", "find_structure", "init_statics", "init_params",
           "init_specs", "init_cache", "cache_specs", "apply_model",
           "count_params", "model_flops_per_token"]

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
    remat: bool = True  # recompute each period / encoder layer (_remat)
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


def cache_specs(statics):
    """The reference's ``cache_specs``: ``None``, since a cache leaf's
    placement follows its name and rank (``launch.steps.cache_pspec``),
    not a logical spec."""
    return None


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _apply_layer(params, static, cfg: ModelConfig, x, positions, cache,
                 cache_pos, cache_len, prefill: bool, memory=None,
                 kernels: bool = True, seq: bool = False,
                 mem_seq: bool = False):
    tp = tensor.current()
    if tp is not None:
        return _apply_layer_tp(tp, params, static, cfg, x, positions, cache,
                               memory, kernels, seq, mem_seq, cache_pos,
                               cache_len, prefill)
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


def _on_slab(tp, params: dict) -> dict:
    """A whole leaf's tree (a norm's, a projection's) for compute on this
    rank's slab of the sequence: each leaf in float32 by
    ``tensor.copy_to_model``, so its gradient, the rank's tokens' share,
    sums over the group before its one rounding."""
    return {k: tensor.copy_to_model(v.float(), tp) for k, v in params.items()}


def _apply_layer_tp(tp, params, static, cfg: ModelConfig, x, positions,
                    cache, memory, kernels: bool, seq: bool = False,
                    mem_seq: bool = False, cache_pos=None, cache_len=None,
                    prefill: bool = False):
    """One layer inside ``parallel.tensor.tensor_parallel_ctx`` (the
    sharded train step's, or a placed serving step's): the blocks of
    ``tensor.layer_splits`` on this rank's slabs of ``tp``'s ``model``
    group, the rest (norms, and a block whose heads do not divide) whole,
    and MoE's capacity each data block's, where the reference's mesh
    counts it so (``moe.moe_apply_tp``).

    With ``seq`` the layer takes and returns this rank's slab of the
    sequence (``[B, S / n, d]``): the norms and residual adds run on it
    (the norms' leaves by :func:`_on_slab`), a split block gathers its
    normed input and reduce-scatters its output
    (``tensor.gather_sequence``, ``tensor.scatter_sequence``), and a
    block that stays whole gathers it with its gradient's slice going
    back and splits its whole output (``tensor.split_sequence``).  Each
    block computes on the whole sequence, so the positions are the whole
    sequence's.  ``mem_seq``: ``memory`` is this rank's slab of the
    encoder's stream, gathered by the cross-attention the same way.

    ``cache`` (a placed serving step's ``models.attention.PlacedCache``;
    training keeps none): a split block reads and writes the cache's
    slabs itself (``attention_apply_tp``, ``mla_apply_tp``,
    ``ssm_apply_tp``); a whole block computes on the cache gathered over
    ``model`` for the rank's rows (``tensor.gather_cache``) and writes its
    part back (``tensor.write_own``)."""
    if cache is not None and not isinstance(cache, PlacedCache):
        raise ValueError("tensor-parallel compute keeps a cache as the "
                         "rank's slabs (models.attention.PlacedCache)")
    split = tensor.layer_splits(cfg, static, tp.size)
    norm_fn = rmsnorm if cfg.norm == "rmsnorm" else layernorm
    mixer = static["mixer"]

    def norm(p, h):
        return norm_fn(_on_slab(tp, p) if seq else p, h)

    def whole(fn, h, c=None):
        """``fn`` of the whole normed input on every rank (and of the
        layer's cache ``c`` whole over ``model``); on a split stream its
        input gathered and its output split."""
        run = None if c is None else {
            k: tensor.gather_cache(t, c.placements[k], tp)
            for k, t in c.items()}
        if seq:
            h = tensor.gather_sequence(h, tp, whole=True)
        out = fn(h) if c is None else fn(h, run)
        if c is not None:
            for k, t in c.items():
                new = (run[k][:, c.pos:c.pos + c.s] if k in tensor.SEQ_LEAVES
                       else run[k])
                tensor.write_own(t, c.placements[k], new,
                                 c.pos if k in tensor.SEQ_LEAVES else None)
        return tensor.split_sequence(out, tp) if seq else out

    def attend(name, key, h, mem=None, c=None):
        if name in split:
            return attention_apply_tp(tp, params[name], static[key], h,
                                      positions, memory=mem, seq=seq,
                                      mem_seq=mem_seq, cache=c,
                                      cache_len=cache_len, prefill=prefill)
        if mem is not None and mem_seq:
            mem = tensor.gather_sequence(mem, tp, whole=True)
        if c is None:
            return whole(lambda a: attention_apply(
                params[name], static[key], a, positions, memory=mem,
                prefill=False)[0], h)
        return whole(lambda a, run: attention_apply(
            params[name], static[key], a, positions, cache=run,
            cache_pos=cache_pos, cache_len=cache_len,
            prefill=prefill)[0], h, c)

    h = norm(params["norm1"], x)
    if mixer == "mla" and "mla" in split:
        out = mla_apply_tp(tp, params["attn"], static["mla_cfg"], h,
                           positions, seq, cache, cache_len)
    elif mixer == "mla":
        out = whole(lambda a, run=None: mla_apply(
            params["attn"], static["mla_cfg"], a, positions, cache=run,
            cache_pos=cache_pos, cache_len=cache_len)[0], h, cache)
    elif mixer == "ssm" and "ssm" in split:
        out = ssm_apply_tp(tp, params["attn"], static["ssm_cfg"], h, seq,
                           cache)
    elif mixer == "ssm":
        out = whole(lambda a, run=None: ssm_apply(
            params["attn"], static["ssm_cfg"], a, run)[0], h, cache)
    else:
        out = attend("attn", "attn_cfg", h, c=(
            cache.sub("self") if mixer == "xattn" and cache is not None
            else cache))
    if mixer == "xattn":
        x = x + out
        out = attend("xattn", "xattn_cfg", norm(params["xnorm"], x), memory)
    x = x + out
    if static["ffn"] == "none":
        return x, cache
    h = norm(params["norm2"], x)
    if static["ffn"] == "moe":
        return x + moe_apply_tp(tp, params["moe"], static["moe"], cfg.moe, h,
                                "moe" in split, kernels,
                                "moe_shared" in split, seq), cache
    if "mlp" in split:
        return x + mlp_apply_tp(tp, params["mlp"], static["mlp"], h,
                                kernels, seq), cache
    return x + whole(lambda a: mlp_apply(params["mlp"], static["mlp"], a,
                                         kernels), h), cache


def _remat(fn, *args):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint``
    that keeps nothing of ``fn``'s but its inputs: the backward runs
    ``fn`` again for what it needs, as ``jax.checkpoint`` with the
    ``nothing_saveable`` policy does.

    The recompute stops early, at the last op that saved a tensor for
    the backward (torch's default, set here whatever the caller's): the
    ops after it would only allocate outputs nobody reads while the
    backward's buffers are live.  In a training step's period those are
    the last layer's residual add and, where its last block computes on
    its ``model`` slab and ends in a row product, that product's
    all-reduce (on a stream split along the sequence, its
    reduce-scatter), which then runs once: ``parallel.tensor.model_bytes``
    reckons exactly that, the same on every rank (where early stop stops
    was checked on torch 2.11 and 2.13; ``tests/test_torch_remat.py``
    counts it against ``parallel.tensor._trailing``).  On a split stream
    the checkpointed input is this rank's slab.  The
    recompute runs inside the forward's ``parallel.tensor`` context,
    which the autograd engine's device threads would not see otherwise.
    No random state is kept: the model draws none."""
    tp = tensor.current()

    def contexts():
        return contextlib.nullcontext(), tensor.entered(tp)

    with _checkpoint.set_checkpoint_early_stop(True):
        return _checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                      preserve_rng_state=False,
                                      context_fn=contexts)


def _encode(params, statics, cfg: ModelConfig, frames: torch.Tensor,
            kernels: bool = True, placed=None, remat: bool = False):
    """Whisper encoder over stub frame embeddings [B, enc_seq, d]: every
    layer bidirectional at positions ``arange(enc_seq)`` without a cache,
    so its attention is a prefill in the kernel route's sense (the plain
    routes with ``kernels=False``).  ``placed``: each layer computes on
    the rank's param slabs (``runtime.serve``).  ``remat``: each layer
    under :func:`_remat`, the reference's ``enc_fn``.  Returns the
    output and whether it is this rank's slab of the frames (inside the
    sharded train step, where ``model`` divides them,
    ``parallel.activations.shard_activation``)."""
    norm = rmsnorm if cfg.norm == "rmsnorm" else layernorm
    top = _take(params, placed, "enc_pos", "enc_norm")
    x = frames.to(cfg.cdtype()) + top["enc_pos"].to(cfg.cdtype())
    pos = torch.arange(frames.shape[1], device=frames.device)
    tp = tensor.current()
    seq = tp is not None and tensor.seq_splits(tp.size, frames.shape[1])
    x = shard_activation(x, ("batch", "seq_shard", None))

    def enc_layer(x, i):
        p = _index(params["encoder"], i)
        if placed is not None:
            p = placed.layer_params(p, ("encoder", None))
        return _apply_layer(p, statics["encoder"], cfg, x, pos, None, None,
                            None, kernels, kernels=kernels, seq=seq)[0]

    for i in range(cfg.encoder_layers):
        x = _remat(enc_layer, x, i) if remat else enc_layer(x, i)
    out_norm = _on_slab(tp, top["enc_norm"]) if seq else top["enc_norm"]
    return norm(out_norm, x), seq


def _take(params, placed, *keys) -> dict:
    """The entries ``keys`` of ``params`` that it has: with ``placed``,
    this rank's slabs where they compute on them (the vocabulary's), the
    rest gathered whole (``runtime.serve``)."""
    sub = {k: params[k] for k in keys if k in params}
    if placed is None:
        return sub
    return placed.take(sub)


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
    placed=None,
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
    default.

    Inside the sharded train step's ``parallel.tensor.
    tensor_parallel_ctx``, where the vocabulary splits over ``model``
    (``tensor.vocab_splits``), the lookups read this rank's rows of the
    table and the logits (the MTP head's too) are this rank's slab of
    the padded vocabulary's columns, ``[B, S(+P), vocab_padded / n]``,
    which ``runtime.train.cross_entropy`` reduces over the group.  Where
    ``model`` divides the stream's length (``tensor.seq_splits``, the
    reference's ``seq_shard``), the stream between layers is this rank's
    slab of positions: the split lookup's partial rows (the prefix on
    rank 0 alone) are reduce-scattered onto it, a whole one is split,
    whisper's learned positions and the final norm run on it, and the
    head gathers it (the encoder's stream likewise, by its own length).

    With ``cfg.remat``, where autograd records the forward
    (``torch.is_grad_enabled()``), there is no cache and ``placed`` is
    None (a training step), each period of the body and each encoder
    layer runs under :func:`_remat`; the prefix layers and the MTP layer
    run as they are, as the reference runs them.  Serving, the pipeline
    and every forward without grad run unchanged.

    ``placed`` (``runtime.serve``'s placed serving steps, which pass it
    and run it inside ``parallel.tensor.tensor_parallel_ctx``): ``params``
    and ``cache`` are this rank's slabs and ``tokens`` (and ``frames``,
    ``prefix_embeds``) its batch rows.  Every layer computes on the
    rank's ``model`` slabs as in the sharded train step, its cache on
    the cache's slabs (:func:`_apply_layer_tp`); the only params
    gathered are leaves no block computes on the slabs of
    (``tensor.slab_leaves``).  Where ``pod`` splits the rows of a cache
    slab, each layer reads and writes its rows of the slab and then
    takes the other pods' rows of what it wrote (``placed.share``).  An
    encoder's output is gathered along its frames once and kept in
    ``memory`` (beside the other pods' rows).  The logits
    are the rank's rows' at the last position alone, ``[B, 1,
    vocab_padded]``, the vocabulary's slabs gathered over ``model``."""
    cfg: ModelConfig = statics["cfg"]
    if placed is not None and cache is None:
        raise ValueError("placed serving steps keep a cache")
    if placed is not None and tensor.current() is None:
        raise ValueError("a placed step runs inside "
                         "parallel.tensor.tensor_parallel_ctx")
    cdt = cfg.cdtype()
    _, s = tokens.shape
    remat = (cfg.remat and torch.is_grad_enabled() and cache is None
             and placed is None)
    tp = tensor.current()
    vocab_tp = (tp if tp is not None and tensor.vocab_splits(cfg, tp.size)
                else None)
    full = s + (prefix_embeds.shape[1] if prefix_embeds is not None else 0)
    seq = tp is not None and tensor.seq_splits(tp.size, full)

    x = _embed(_take(params, placed, "embed"), cfg, tokens, vocab_tp,
               reduce=not seq)
    if cfg.tie_embeddings:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=cdt)  # gemma convention
    if prefix_embeds is not None:
        pre = prefix_embeds.to(cdt)
        if seq and vocab_tp is not None and tp.rank != 0:
            pre = torch.zeros_like(pre)  # the sum below adds it once
        x = torch.cat([pre, x], dim=1)
        s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    if not kernels:
        prefill = False
    elif prefill is None:
        prefill = is_prefill(s, positions, cache=cache, cache_pos=cache_pos)
    x = _stream(x, tp, seq, vocab_tp is not None)
    if "dec_pos" in params:
        table = _take(params, placed, "dec_pos")["dec_pos"]
        if seq:
            table = tensor.copy_to_model(table, tp)
        dp = table[positions].to(cdt)
        dp = dp if positions.dim() == 2 else dp[None]
        if seq:
            w = s // tp.size
            dp = dp[:, tp.rank * w:(tp.rank + 1) * w]
        x = x + dp

    memory, mem_seq = None, False
    if cfg.encoder_layers:
        if frames is not None:
            memory, mem_seq = _encode(params, statics, cfg, frames, kernels,
                                      placed, remat)
            if placed is not None and mem_seq:  # kept whole: gather once
                memory, mem_seq = tensor.gather_sequence(memory, tp), False
            if cache is not None:
                cache["memory"] = (memory if placed is None
                                   else placed.memory(memory))
        elif cache is not None:
            memory = cache["memory"]
            if placed is not None:
                memory = placed.rows(memory)

    def layer(x, p, st, c, where):
        if placed is None:
            return _apply_layer(p, st, cfg, x, positions, c, cache_pos,
                                cache_len, prefill, memory, kernels, seq,
                                mem_seq)[0]
        x = _apply_layer(placed.layer_params(p, where), st, cfg, x,
                         positions, placed.layer_cache(c, where), cache_pos,
                         cache_len, prefill, memory, kernels, seq,
                         mem_seq)[0]
        placed.share(c, where)
        return x

    for i, (p, st) in enumerate(zip(params["prefix_layers"],
                                    statics["prefix_layers"])):
        c = cache["prefix_layers"][i] if cache is not None else None
        x = layer(x, p, st, c, ("prefix_layers", i))

    def period(x, rep):  # the reference's period_fn
        for j, st in enumerate(statics["body"]):
            c = _index(cache["body"][j], rep) if cache is not None else None
            x = layer(x, _index(params["body"][j], rep), st, c, ("body", j))
        return x

    for rep in range(statics["n_periods"]):
        x = _remat(period, x, rep) if remat else period(x, rep)

    norm = rmsnorm if cfg.norm == "rmsnorm" else layernorm

    def final(p, h, split):
        return norm(_on_slab(tp, p) if split else p, h)

    hidden = final(_take(params, placed, "final_norm")["final_norm"], x, seq)
    head = _take(params, placed, "embed" if cfg.tie_embeddings else "lm_head")
    if placed is None:
        logits = _head(head, cfg, hidden, vocab_tp, tp, seq)
    else:  # the sampled position alone, its vocabulary gathered
        last = (tp.gather_seq(hidden[:, -1:]) if seq else hidden)[:, -1:]
        logits = _head(head, cfg, last, vocab_tp, tp)
        if vocab_tp is not None:
            logits = tp.all_gather(logits)

    aux = {}
    if cfg.mtp and cache is None:
        # next-next-token head: combine hidden_t with embed(token_{t+1})
        nxt = torch.roll(tokens, -1, dims=1)
        e_next = _stream(_embed(params, cfg, nxt, vocab_tp, reduce=not seq),
                         tp, seq, vocab_tp is not None)
        proj = _on_slab(tp, params["mtp_proj"]) if seq else params["mtp_proj"]
        h_mtp = linear(proj, torch.cat([hidden, e_next], -1))
        h_mtp, _ = _apply_layer(params["mtp_layer"], statics["mtp_layer"],
                                cfg, h_mtp, positions, None, None, None,
                                prefill, kernels=kernels, seq=seq)
        aux["mtp_logits"] = _head(params, cfg,
                                  final(params["mtp_norm"], h_mtp, seq),
                                  vocab_tp, tp, seq)
    return logits, cache, aux


def _stream(x: torch.Tensor, tp, seq: bool, partial: bool) -> torch.Tensor:
    """The embedded tokens ``x`` as the stream enters the layers: where
    ``seq``, this rank's slab of the sequence (``partial``: ``x`` holds
    this rank's share of the vocabulary-split lookup, summed over the
    group by a reduce-scatter, exact as one term of each sum is
    nonzero); else ``x``."""
    if seq and partial:
        return tensor.scatter_sequence(x, tp)
    return shard_activation(x, ("batch", "seq_shard", None))


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           tp=None, reduce: bool = True) -> torch.Tensor:
    """The tokens' rows of the table, in the compute dtype.  With ``tp``
    (``tensor.vocab_splits``) the table is this rank's slab of rows: the
    tokens outside it look up row 0 and are zeroed, and the ranks' rows
    sum over the group (one of them nonzero, so the sum is exact); with
    ``reduce=False`` they are returned unsummed (the caller
    reduce-scatters them, :func:`_stream`)."""
    w = params["embed"]["w"]
    if tp is None:
        return w[tokens].to(cfg.cdtype())
    rows = w.shape[0]
    local = tokens - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    x = w[torch.where(inside, local, 0)].to(cfg.cdtype())
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return tensor.reduce_from_model(x, tp) if reduce else x


def _head(params, cfg: ModelConfig, hidden: torch.Tensor,
          vocab_tp=None, tp=None, seq: bool = False) -> torch.Tensor:
    """The logits; with ``vocab_tp`` (``tensor.vocab_splits``) this rank's
    slab of the vocabulary's columns, a column product
    (``tensor.column_product``).  ``seq``: ``hidden`` is this rank's slab
    of the sequence, gathered (by the column product's entry, or whole
    for a whole head)."""
    if vocab_tp is not None:
        head = ({"w": params["embed"]["w"].T} if cfg.tie_embeddings
                else params["lm_head"])
        return tensor.column_product(hidden, head, vocab_tp, cfg.cdtype(),
                                     seq=seq)
    if seq:
        hidden = tensor.gather_sequence(hidden, tp, whole=True)
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


def model_flops_per_token(cfg: ModelConfig, active_only: bool = True) -> float:
    """6 * N(active): a training step's FLOPs per token by the matmul
    params (MODEL_FLOPS of the roofline table), the reference's
    arithmetic."""
    d = cfg.d_model
    n = 0
    for mixer, ffn in cfg.layer_types:
        if mixer in ("attn", "swa"):
            n += d * cfg.n_heads * cfg.d_head * 2  # q + o
            n += d * cfg.n_kv_heads * cfg.d_head * 2  # k + v
        elif mixer == "xattn":
            n += (d * cfg.n_heads * cfg.d_head * 2
                  + d * cfg.n_kv_heads * cfg.d_head * 2) * 2
        elif mixer == "mla":
            m = cfg.mla
            n += d * m.q_lora + m.q_lora * m.n_heads * (m.d_nope + m.d_rope)
            n += d * (m.kv_lora + m.d_rope)
            n += m.kv_lora * m.n_heads * (m.d_nope + m.d_v)
            n += m.n_heads * m.d_v * d
        elif mixer == "ssm":
            sc = cfg.ssm
            n += d * (2 * sc.d_inner + 2 * sc.n_groups * sc.d_state
                      + sc.n_heads)
            n += sc.d_inner * d
        if ffn == "mlp":
            mult = 3 if cfg.act == "swiglu" else 2
            n += mult * d * cfg.d_ff
        elif ffn == "moe":
            mo = cfg.moe
            active = mo.top_k if active_only else mo.n_experts
            mult = 3 if mo.act == "swiglu" else 2
            n += mult * d * mo.d_ff_expert * active
            if mo.n_shared:
                f_sh = mo.d_ff_shared or mo.n_shared * mo.d_ff_expert
                n += mult * d * f_sh
    n += cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return 6.0 * n
