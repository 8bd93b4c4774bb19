"""Multi-head Latent Attention (DeepSeek-V2/V3).

Port of ``src/repro/models/mla.py``.  KV state is compressed to a
``kv_lora``-dim latent (plus a shared RoPE key of ``d_rope`` dims): the
cache per token is kv_lora + d_rope values (576 for DeepSeek),
independent of head count.

Two compute paths, as in the reference:
  * prefill — decompress K/V per head in float32 and run the plain
    ``_full_attention`` / ``_chunked_attention`` of ``models.attention``
    (the reference's XLA routes; never the flash kernel, which takes one
    head width for q, k and v while MLA's values are narrower than its
    keys);
  * decode  — the *absorbed* form in float32: W_uk is folded into the
    query and W_uv into the output projection, so attention runs in the
    latent space (per-token cost O(h * kv_lora), no per-head KV).

The cache ``{c_kv [B, T, kv_lora], k_rope [B, T, d_rope]}`` is written in
place (the reference returns a new one) at a scalar offset, clamped so
the update fits as ``dynamic_update_slice`` clamps it, or at per-row
offsets ``[B]``; neither reads the device from the host.

:func:`mla_apply_tp` runs either route on one rank's heads of a
``model`` group (``parallel.tensor``): the sharded train step's, and the
placed serving steps' with the cache's position slabs.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.attention import (
    _chunked_attention,
    _expand_mask,
    _full_attention,
    _mask,
    _write_cache,
)
from repro_torch.models.layers import (
    apply_rope,
    linear,
    linear_init,
    linear_specs,
    rmsnorm,
    rmsnorm_init,
    rmsnorm_specs,
    rope_frequencies,
)
from repro_torch.parallel.tensor import (
    column_product,
    copy_to_model,
    gather_cache,
    gather_sequence,
    row_product,
    write_own,
)

__all__ = ["MLAConfig", "mla_init", "mla_specs", "mla_apply",
           "mla_apply_tp", "init_mla_cache"]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora: int = 512
    q_lora: int = 1536
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    rope_theta: float = 10000.0
    model_shards: int = 16
    chunk: int = 1024
    full_attn_max_seq: int = 8192


def mla_init(generator, cfg: MLAConfig, param_dtype=torch.float32,
             device=None):
    d, h = cfg.d_model, cfg.n_heads
    kw = dict(param_dtype=param_dtype, device=device)
    return {
        "wq_a": linear_init(generator, d, cfg.q_lora, **kw),
        "q_norm": rmsnorm_init(cfg.q_lora, param_dtype, device),
        "wq_b": linear_init(generator, cfg.q_lora,
                            h * (cfg.d_nope + cfg.d_rope), **kw),
        "wkv_a": linear_init(generator, d, cfg.kv_lora + cfg.d_rope, **kw),
        "kv_norm": rmsnorm_init(cfg.kv_lora, param_dtype, device),
        "wkv_b": linear_init(generator, cfg.kv_lora,
                             h * (cfg.d_nope + cfg.d_v), **kw),
        "wo": linear_init(generator, h * cfg.d_v, d, **kw),
    }


def mla_specs(cfg: MLAConfig) -> dict:
    """The specs of :func:`mla_init`'s params: the low-rank widths
    replicated, the heads over ``model``."""
    return {"wq_a": linear_specs("embed", "q_lora"),
            "q_norm": rmsnorm_specs(),
            "wq_b": linear_specs("q_lora", "heads"),
            "wkv_a": linear_specs("embed", "kv_lora"),
            "kv_norm": rmsnorm_specs(),
            "wkv_b": linear_specs("kv_lora", "heads"),
            "wo": linear_specs("heads", "embed")}


def init_mla_cache(cfg: MLAConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16, device=None):
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.d_rope), dtype=dtype,
                              device=device),
    }


def _batched(positions: torch.Tensor) -> torch.Tensor:
    return positions if positions.dim() == 2 else positions[None, :]


def _latent_q(params, x):
    return rmsnorm(params["q_norm"], linear(params["wq_a"], x))


def _project_q(params, cfg: MLAConfig, c_q, positions, tp=None):
    """The heads' queries from the latent ``c_q``: as many heads as
    ``wq_b`` has columns for (with ``tp``, a column product over its
    ranks)."""
    b, s, _ = c_q.shape
    q = (linear(params["wq_b"], c_q) if tp is None
         else column_product(c_q, params["wq_b"], tp, c_q.dtype))
    q = q.reshape(b, s, q.shape[-1] // (cfg.d_nope + cfg.d_rope),
                  cfg.d_nope + cfg.d_rope)
    q_nope, q_rope = q[..., : cfg.d_nope], q[..., cfg.d_nope:]
    freqs = rope_frequencies(cfg.d_rope, cfg.rope_theta, device=c_q.device)
    return q_nope, apply_rope(q_rope, _batched(positions), freqs)


def _compress_kv(params, cfg: MLAConfig, x, positions):
    kv = linear(params["wkv_a"], x)  # [B, S, kv_lora + d_rope]
    c_kv = rmsnorm(params["kv_norm"], kv[..., : cfg.kv_lora])
    freqs = rope_frequencies(cfg.d_rope, cfg.rope_theta, device=x.device)
    k_rope = apply_rope(kv[..., cfg.kv_lora:], _batched(positions), freqs)
    return c_kv, k_rope


def mla_apply(
    params,
    cfg: MLAConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [S] (shared) or [B, S] (per-row)
    cache: dict | None = None,
    cache_pos=None,  # scalar or [B]
    cache_len=None,  # scalar or [B]
    absorbed: bool | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Returns (output [B, S, D], cache written in place)."""
    b, s, _ = x.shape
    h = cfg.n_heads

    q_nope, q_rope = _project_q(params, cfg, _latent_q(params, x),
                                positions)
    c_kv_new, k_rope_new = _compress_kv(params, cfg, x, positions)

    if cache is not None:
        _write_cache(cache, {"c_kv": c_kv_new, "k_rope": k_rope_new},
                     cache_pos, s)
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        t = c_kv.shape[1]
        kpos = torch.arange(t, device=x.device)
    else:
        c_kv, k_rope = c_kv_new, k_rope_new
        t = s
        kpos = positions

    if absorbed is None:
        absorbed = s == 1  # decode default

    wkv_b = params["wkv_b"]["w"].reshape(cfg.kv_lora, h,
                                         cfg.d_nope + cfg.d_v)
    w_uk = wkv_b[..., : cfg.d_nope].float()  # [kv_lora, h, d_nope]
    w_uv = wkv_b[..., cfg.d_nope:].float()  # [kv_lora, h, d_v]
    c32 = c_kv.float()

    route = _absorbed if absorbed else _expanded
    out = route(cfg, h, w_uk, w_uv, q_nope, q_rope, c32, k_rope, positions,
                kpos, cache_len)
    out = out.reshape(b, s, h * cfg.d_v).to(x.dtype)
    return linear(params["wo"], out), cache


def _absorbed(cfg: MLAConfig, h: int, w_uk, w_uv, q_nope, q_rope, c32,
              k_rope, positions, kpos, cache_len):
    """The absorbed route: W_uk folded into the queries and W_uv into the
    output, attention in the latent space in float32.  Returns [B, S, h,
    d_v]."""
    scale = (cfg.d_nope + cfg.d_rope) ** -0.5
    # fold W_uk into q: q_abs [B, S, h, kv_lora]
    q_abs = torch.einsum("bshd,lhd->bshl", q_nope.float(), w_uk)
    s_lat = torch.einsum("bshl,btl->bhst", q_abs, c32)
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())
    scores = (s_lat + s_rope) * scale
    # [S, T] shared or [B, S, T] per-row -> [1|B, 1, S, T]
    mask = _mask(positions, kpos, True, None, cache_len)
    scores = torch.where(_expand_mask(mask), scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btl->bshl", p, c32)
    return torch.einsum("bshl,lhv->bshv", o_lat, w_uv)


def _expanded(cfg: MLAConfig, h: int, w_uk, w_uv, q_nope, q_rope, c32,
              k_rope, positions, kpos, cache_len):
    """The expanded route: K/V decompressed per head in float32, then
    the plain attention routes.  Returns [B, S, h, d_v]."""
    b, t = c32.shape[:2]
    s = q_nope.shape[1]
    k_nope = torch.einsum("btl,lhd->bthd", c32, w_uk)
    v = torch.einsum("btl,lhv->bthv", c32, w_uv)
    k_rope_h = k_rope[:, :, None, :].float().expand(b, t, h, cfg.d_rope)
    k_full = torch.cat([k_nope, k_rope_h], dim=-1)
    q_full = torch.cat([q_nope.float(), q_rope.float()], dim=-1)
    qh = q_full.transpose(1, 2)
    kh = k_full.transpose(1, 2)
    vh = v.transpose(1, 2)
    if max(s, t) <= cfg.full_attn_max_seq:
        out = _full_attention(qh, kh, vh, positions, kpos, True, None,
                              cache_len)
    else:
        out = _chunked_attention(qh, kh, vh, positions, kpos, True, None,
                                 cache_len, cfg.chunk)
    return out.transpose(1, 2)  # [B, S, h, d_v]


def mla_apply_tp(tp, params, cfg: MLAConfig, x: torch.Tensor,
                 positions: torch.Tensor, seq: bool = False,
                 cache: dict | None = None, cache_len=None) -> torch.Tensor:
    """:func:`mla_apply` on this rank's ``n_heads / n`` heads over
    ``tp``'s ``model`` group (``parallel.tensor.mla_splits`` holds for
    ``cfg``): ``wq_b`` and ``wkv_b`` are the rank's column slabs, ``wo``
    its row slab.  The latents (``wq_a`` and ``q_norm``, ``wkv_a`` and
    ``kv_norm``, and the shared RoPE key) compute whole on every rank;
    ``wq_b`` is a column product and ``wo`` a row product
    (``parallel.tensor``).  ``seq``: ``x`` is this rank's slab of the
    sequence, gathered whole for the latents (their gradients are whole
    on every rank, so the slice goes back), and the output is
    reduce-scattered back to the slab.

    Without a cache (the sharded train step) it is the expanded route,
    the latents entering the heads' products by ``copy_to_model`` (in
    float32, as the expanded route reads them), so their gradients sum
    the ranks' heads.  ``cache`` (a placed serving step's
    ``models.attention.PlacedCache``, positions over ``model``): every
    rank computed the latents, so each writes the written positions its
    own slab holds, then the rows' latents at every position are
    all-gathered over ``model`` (``tensor.gather_cache``) and read as
    :func:`mla_apply` reads its cache: the expanded route for a prefill,
    the absorbed one for a decode.  Returns the output [B, S, D]
    (``seq``: [B, S / n, D])."""
    if seq:
        x = gather_sequence(x, tp, whole=True)
    b, s, _ = x.shape
    h = cfg.n_heads // tp.size
    q_nope, q_rope = _project_q(params, cfg, _latent_q(params, x),
                                positions, tp)
    c_kv, k_rope = _compress_kv(params, cfg, x, positions)
    route = _expanded
    if cache is None:
        latent = copy_to_model(torch.cat([c_kv, k_rope], -1).float(), tp)
        c_kv, k_rope = latent[..., :cfg.kv_lora], latent[..., cfg.kv_lora:]
        kpos = positions
    else:
        for name, new in (("c_kv", c_kv), ("k_rope", k_rope)):
            write_own(cache[name], cache.placements[name], new, cache.pos)
        c_kv = gather_cache(cache["c_kv"], cache.placements["c_kv"], tp)
        k_rope = gather_cache(cache["k_rope"], cache.placements["k_rope"],
                              tp)
        kpos = torch.arange(c_kv.shape[1], device=x.device)
        route = _absorbed if s == 1 else _expanded
    wkv_b = params["wkv_b"]["w"].reshape(cfg.kv_lora, h,
                                         cfg.d_nope + cfg.d_v)
    out = route(cfg, h, wkv_b[..., :cfg.d_nope].float(),
                wkv_b[..., cfg.d_nope:].float(), q_nope, q_rope,
                c_kv.float(), k_rope, positions, kpos, cache_len)
    out = out.reshape(b, s, h * cfg.d_v).to(x.dtype)
    return row_product(out, params["wo"], tp, x.dtype, seq)

