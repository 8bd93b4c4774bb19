"""GQA / MQA / full / sliding-window attention with KV caches.

Port of ``src/repro/models/attention.py``.  Four execution routes:

  * kernel  — a prefill goes through the hand-written Hopper
              flash-attention kernel, ``kernels.ops.flash_attention`` (on
              the CPU, its plain version).  A prefill is self-attention
              (no ``memory``) over ``s > 1`` queries at the shared
              positions ``arange(s)`` — no cache, or a scalar
              ``cache_pos == 0`` — with ``cfg.grouped``.  The keys are
              read back from the cache (through a transposed view, no
              copy) as the reference reads them; the kernel's query
              positions start at 0, ``kv_len = cache_len`` and causal
              order hides every later slot, and no row is fully masked,
              so the kernel computes what ``_full_attention`` and
              ``_chunked_attention`` compute there.  This is the drop-in
              the reference names for its pure-XLA path.  The positions
              test (:func:`is_prefill`) is the caller's: ``apply_model``
              makes it once per forward and passes ``prefill`` to every
              layer, and ``prefill=False`` keeps a call on the plain
              routes;
  * full    — einsum attention (every other call up to
              ``full_attn_max_seq``);
  * chunked — a loop over KV chunks with online softmax beyond it:
              O(S * chunk) score memory;
  * decode  — a single-token query against the cache, with the
              sliding-window slice when every row shares one position, so
              SWA decode reads O(window) keys, not O(S).  Decode steps at
              per-row positions (continuous batching) take the full or
              chunked route, on the card too, as the reference's XLA
              decode does.

``decode_strategy="flash"``: a decode step at one shared position,
without a window, inside ``parallel.activations.activation_sharding_ctx
(mesh)`` whose model dim divides the cache length, takes the sequence-
sharded flash-decode (:func:`flash_decode_sharded`): each model rank
scores its chunk of the cache and the partial softmaxes merge through
all-reduces.  Anywhere else (no mesh, a cache length the model dim does
not divide) it falls through to the routes above, as the reference's
does.

In a placed serving step (``runtime.serve`` with ``shardings=``) each
rank holds only its position slab of the cache (:class:`PlacedCache`)
and computes on its query heads (:func:`attention_apply_tp`): the new
keys and values go to the slabs that hold their positions, a prefill
attends on the flash-attention kernel over what the rank computed, and a
decode reads its key heads from every slab or, with
``decode_strategy="flash"`` and no window, scores its own slab for every
head (:func:`flash_decode_placed`).

Head padding: q heads are padded to a multiple of the TP degree
(``parallel.sharding.padded_heads``); padded heads have zero in/out
projection weights, so they are numerically inert.  GQA grouping uses the
kernel's head fold when padded_q % kv == 0, otherwise a kv-repeat
fallback on the plain routes (phi3's 10 kv heads).

Caches are updated in place (the reference returns a new cache): the
returned cache is the one passed in, written at the new positions.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_rope,
    linear,
    linear_init,
    linear_specs,
    rope_frequencies,
)
from repro_torch.parallel.activations import current_mesh
from repro_torch.parallel.sharding import mesh_axis_sizes, padded_heads
from repro_torch.parallel.tensor import (
    attention_kv_heads,
    attention_splits,
    column_product,
    copy_to_model,
    kv_split,
    read_positions,
    relayout_columns,
    row_product,
    write_positions,
)

__all__ = ["AttnConfig", "attention_init", "attention_specs",
           "attention_apply", "attention_apply_tp", "init_kv_cache",
           "is_prefill", "flash_decode_sharded", "PlacedCache",
           "flash_decode_placed"]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    causal: bool = True
    window: int | None = None  # sliding window (h2o-danube)
    rope_theta: float | None = 10000.0  # None -> no RoPE (whisper)
    model_shards: int = 16
    chunk: int = 1024  # kv chunk for the online-softmax path
    full_attn_max_seq: int = 8192  # einsum path below this
    # decode against a sequence-sharded KV cache:
    #  'gather' — every rank reads the whole cache (the plain route).
    #  'flash'  — under a mesh: each 'model' rank scores its cache chunk,
    #             log-sum-exp combine by all-reduce (flash_decode_sharded)
    decode_strategy: str = "gather"

    @property
    def hq_pad(self) -> int:
        return padded_heads(self.n_heads, self.model_shards)

    @property
    def grouped(self) -> bool:
        return self.hq_pad % self.n_kv_heads == 0


def attention_init(generator, cfg: AttnConfig, param_dtype=torch.float32,
                   device=None):
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv = cfg.hq_pad, cfg.n_kv_heads
    kw = dict(bias=cfg.qkv_bias, param_dtype=param_dtype, device=device)
    params = {
        "wq": linear_init(generator, d, hq * dh, **kw),
        "wk": linear_init(generator, d, hkv * dh, **kw),
        "wv": linear_init(generator, d, hkv * dh, **kw),
        "wo": linear_init(generator, hq * dh, d, param_dtype=param_dtype,
                          scale=(hq * dh) ** -0.5, device=device),
    }
    if cfg.hq_pad != cfg.n_heads:  # zero the padded heads' columns and rows
        real = cfg.n_heads * dh
        params["wq"]["w"][:, real:] = 0.0
        params["wo"]["w"][real:] = 0.0
    return params


def attention_specs(cfg: AttnConfig) -> dict:
    """The specs of :func:`attention_init`'s params: heads over ``model``;
    the key/value projections only where their width divides
    ``model_shards``."""
    hkv_width = cfg.n_kv_heads * cfg.d_head
    kv_axis = "kv_heads" if hkv_width % cfg.model_shards == 0 else None
    return {"wq": linear_specs("embed", "heads", bias=cfg.qkv_bias),
            "wk": linear_specs("embed", kv_axis, bias=cfg.qkv_bias),
            "wv": linear_specs("embed", kv_axis, bias=cfg.qkv_bias),
            "wo": linear_specs("heads", "embed")}


def init_kv_cache(
    cfg: AttnConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
    device=None,
):
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _expand_kv(cfg: AttnConfig, q, k, v, index=None):
    """Align kv head count with q heads.  q: [B,S,Hq,D]; k/v: [B,T,Hkv,D].
    Returns q,k,v as [B,H,S,D] with H = hq_pad; ``index``: the key head
    each query head reads (one rank's heads, ``attention_apply_tp``)."""
    hq = q.shape[2]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if index is not None:
        at = torch.tensor(index, device=k.device)
        return qt, kt.index_select(1, at), vt.index_select(1, at)
    if cfg.grouped:
        rep = hq // cfg.n_kv_heads
    else:  # phi3-style: repeat kv to match q heads
        rep = -(-hq // cfg.n_kv_heads)
    kt = kt.repeat_interleave(rep, dim=1)[:, :hq]
    vt = vt.repeat_interleave(rep, dim=1)[:, :hq]
    return qt, kt, vt


def _is_tensor_vector(a) -> bool:
    return isinstance(a, torch.Tensor) and a.dim() > 0


def _write_cache(cache: dict, new: dict, cache_pos, s: int) -> None:
    """Write ``new`` ([B, S, ...] per key) into ``cache`` in place at
    ``cache_pos``: per-row offsets [B], or one offset (an int or a 0-d
    tensor) clamped to ``[0, T - S]`` as ``dynamic_update_slice`` clamps
    it.  A tensor offset stays on the device."""
    key0 = next(iter(new))
    b = new[key0].shape[0]
    dev = new[key0].device
    pos0 = cache_pos if cache_pos is not None else 0
    t = cache[key0].shape[1]
    steps = torch.arange(s, device=dev)
    if _is_tensor_vector(pos0):
        rows = torch.arange(b, device=dev)[:, None]
        cols = pos0[:, None] + steps[None, :]
        for key, v in new.items():
            cache[key][rows, cols] = v.to(cache[key].dtype)
    elif isinstance(pos0, torch.Tensor):
        cols = pos0.clamp(0, t - s) + steps
        for key, v in new.items():
            cache[key][:, cols] = v.to(cache[key].dtype)
    else:
        p0 = min(max(int(pos0), 0), t - s)
        for key, v in new.items():
            cache[key][:, p0:p0 + s] = v.to(cache[key].dtype)


def _mask(qpos, kpos, causal: bool, window: int | None, kv_len):
    qq = qpos[..., :, None]
    kk = kpos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qq.shape, kk.shape),
                   dtype=torch.bool, device=kk.device)
    if causal:
        m &= qq >= kk
    if window is not None:
        m &= kk > qq - window
    if kv_len is not None:
        kv = kv_len[..., None, None] if _is_tensor_vector(kv_len) else kv_len
        m &= kk < kv
    return m


def _expand_mask(m: torch.Tensor) -> torch.Tensor:
    """Broadcast a mask to score rank 4: [S,T] -> [1,1,S,T] (shared across
    batch) or [B,S,T] -> [B,1,S,T] (per-row positions / cache lengths)."""
    return m[None, None] if m.dim() == 2 else m[:, None]


def _full_attention(q, k, v, qpos, kpos, causal, window, kv_len):
    """q,k,v: [B,H,S,D] / [B,H,T,D]."""
    dh = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (dh ** -0.5)
    m = _mask(qpos, kpos, causal, window, kv_len)  # [Sq, Tk] / [B, Sq, Tk]
    s = torch.where(_expand_mask(m), s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _chunked_attention(q, k, v, qpos, kpos, causal, window, kv_len,
                       chunk: int):
    """Online-softmax loop over KV chunks.  q/k: [B,H,S,D], v: [B,H,T,Dv]."""
    b, h, sq, dh = q.shape
    t = k.shape[2]
    dv = v.shape[-1]
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        kpos = torch.nn.functional.pad(kpos, (0, pad), value=2**30)
    qf = q.float()
    m_prev = torch.full((b, h, sq, 1), _NEG, dtype=torch.float32,
                        device=q.device)
    l_prev = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k[:, :, sl].float()) * (
            dh ** -0.5
        )
        msk = _mask(qpos, kpos[sl], causal, window, kv_len)
        s = torch.where(_expand_mask(msk), s, _NEG)
        m_cur = s.amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m_prev, m_cur)
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(s - m_new)
        l_prev = alpha * l_prev + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                         v[:, :, sl].float())
        m_prev = m_new
    return (acc / torch.clamp(l_prev, min=1e-30)).to(q.dtype)


def flash_decode_sharded(cfg: AttnConfig, q, k, v, kv_len, mesh):
    """Flash-decode over a sequence-sharded cache, SPMD over ``mesh``.

    q: [B, Hq, 1, D]; k, v: [B, T, Hkv, D], the whole cache on every rank
    (T divisible by the mesh's ``model`` dim, of size n); ``kv_len`` the
    shared valid length.  Model rank j scores every head against its
    chunk ``[j*T/n, (j+1)*T/n)`` in float32, keys at and past ``kv_len``
    masked; the partial softmaxes merge with an all-reduce (max) of the
    running max, then one all-reduce (sum) of the rescaled denominators
    and weighted values together.  Batch rows split over the data dims
    (``pod``, ``data``) when they divide and are all-gathered back.
    Returns [B, Hq, 1, D] in q's dtype on every rank.  Plain torch ops,
    as the reference's ``_flash_decode_sharded`` is einsums; only the
    combine moves data: O(B*H*D), not the cache.
    ``flash_decode_sharded.calls`` counts the calls."""
    flash_decode_sharded.calls += 1
    b, hq, _, dh = q.shape
    t = k.shape[1]
    sizes = mesh_axis_sizes(mesh)
    n_shards = sizes.get("model", 1)
    t_loc = t // n_shards
    j = mesh.get_local_rank("model") if n_shards > 1 else 0
    dp = [a for a in ("pod", "data") if sizes.get(a, 1) > 1]
    n_dp = math.prod(sizes[a] for a in dp)
    split = bool(dp) and b % n_dp == 0
    rows = slice(None)
    if split:
        r = 0
        for a in dp:  # row block index, pod-major as the reference's spec
            r = r * sizes[a] + mesh.get_local_rank(a)
        b_loc = b // n_dp
        rows = slice(r * b_loc, (r + 1) * b_loc)
    qb = q[rows].float()
    kh = k[rows, j * t_loc:(j + 1) * t_loc].transpose(1, 2)
    vh = v[rows, j * t_loc:(j + 1) * t_loc].transpose(1, 2)
    rep = (hq // cfg.n_kv_heads) if cfg.grouped else -(-hq // cfg.n_kv_heads)
    kh = kh.repeat_interleave(rep, dim=1)[:, :hq]
    vh = vh.repeat_interleave(rep, dim=1)[:, :hq]
    kpos = j * t_loc + torch.arange(t_loc, device=q.device)
    s = torch.einsum("bhqd,bhtd->bhqt", qb, kh.float()) * (dh ** -0.5)
    s = torch.where(kpos[None, None, None, :] < kv_len, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    group = mesh.get_group("model") if n_shards > 1 else None
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m)
    o = torch.einsum("bhqt,bhtd->bhqd", p, vh.float())
    lo = torch.cat([p.sum(-1, keepdim=True), o], dim=-1)
    if group is not None:
        dist.all_reduce(lo, group=group)
    out = (lo[..., 1:] / torch.clamp(lo[..., :1], min=1e-30)).to(q.dtype)
    for a in reversed(dp if split else []):
        parts = [torch.empty_like(out) for _ in range(sizes[a])]
        dist.all_gather(parts, out.contiguous(), group=mesh.get_group(a))
        out = torch.cat(parts)
    return out


flash_decode_sharded.calls = 0


class PlacedCache(dict):
    """One layer's cache in a placed serving step (``runtime.serve``):
    this rank's slabs of its leaves (batch rows over ``data``, positions
    over ``model``, an SSM's conv over ``ff`` and its state over
    ``heads``, ``launch.steps.cache_pspec``), their ``placements``
    (``parallel.sharding.Placement``s of one layer, the stacked lead
    dropped) and the step's write position ``pos`` (clamped as the cache
    write clamps it) and length ``s``.  The ``*_apply_tp`` blocks read
    and write it on the rank's slabs."""

    def __init__(self, slabs: dict, placements: dict, pos: int, s: int):
        super().__init__(slabs)
        self.placements, self.pos, self.s = placements, pos, s

    def sub(self, key: str) -> "PlacedCache":
        return PlacedCache(self[key], self.placements[key], self.pos, self.s)


def flash_decode_placed(tp, cfg: AttnConfig, q, cache: PlacedCache,
                        kv_len) -> torch.Tensor:
    """Flash-decode on a placed cache: the reference's
    ``_flash_decode_sharded`` over a cache each rank holds only its
    position slab of, every key head, for the rank's rows.

    q: [b, Hq / n, 1, D], this rank's query heads over ``tp``'s ``model``
    group; the step's key and value are in the cache already.  The
    queries are gathered over ``model`` (every head scores every slab),
    the slab's positions are scored in float32 (keys at and past
    ``kv_len`` masked), and the partial softmaxes merge over the ranks:
    an all-reduce (max) of the running max, then one all-reduce (sum) of
    the rescaled denominators and weighted values, O(b * Hq * D).  Returns
    the rank's heads' output, [b, Hq / n, 1, D] in q's dtype.
    ``flash_decode_placed.calls`` counts the calls."""
    flash_decode_placed.calls += 1
    b, hq_r, _, dh = q.shape
    hq = hq_r * tp.size
    pl = cache.placements["k"]
    qa = tp.all_gather(q.reshape(b, 1, hq_r * dh)).reshape(b, hq, 1, dh)
    rep = (hq // cfg.n_kv_heads) if cfg.grouped else -(-hq // cfg.n_kv_heads)
    kh = cache["k"].transpose(1, 2).repeat_interleave(rep, dim=1)[:, :hq]
    vh = cache["v"].transpose(1, 2).repeat_interleave(rep, dim=1)[:, :hq]
    seq = pl.slices[1]
    kpos = seq.start + torch.arange(seq.stop - seq.start, device=q.device)
    s = torch.einsum("bhqd,bhtd->bhqt", qa.float(), kh.float()) * (dh ** -0.5)
    s = torch.where(kpos[None, None, None, :] < kv_len, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    split = pl.blocks[1] > 1
    if split:
        m = tp.all_reduce(m, op=dist.ReduceOp.MAX)
    p = torch.exp(s - m)
    o = torch.einsum("bhqt,bhtd->bhqd", p, vh.float())
    lo = torch.cat([p.sum(-1, keepdim=True), o], dim=-1)
    if split:
        lo = tp.all_reduce(lo)
    out = (lo[..., 1:] / torch.clamp(lo[..., :1], min=1e-30)).to(q.dtype)
    return out[:, tp.rank * hq_r:(tp.rank + 1) * hq_r]


flash_decode_placed.calls = 0


def is_prefill(s: int, positions, memory=None, cache=None,
               cache_pos=None) -> bool:
    """Whether a call is a prefill in the kernel route's sense (module
    docstring), apart from ``cfg.grouped``, which is the layer's own.  The
    cheap tests come first; the last reads the device once, so a model
    decides this once per forward, not once per layer."""
    if not (memory is None and s > 1 and positions.dim() == 1
            and positions.shape[0] == s):
        return False
    if cache is not None and cache_pos is not None:
        if _is_tensor_vector(cache_pos) or int(cache_pos) != 0:
            return False
    return torch.equal(positions, torch.arange(s, dtype=positions.dtype,
                                               device=positions.device))


def attention_apply(
    params,
    cfg: AttnConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [S] (shared) or [B, S] (per-row) positions
    memory: torch.Tensor | None = None,  # cross-attention source [B, T, D]
    cache: dict | None = None,  # kv cache to read/update (in place)
    cache_pos=None,  # scalar or [B] write offset
    cache_len=None,  # scalar or [B] valid length
    prefill: bool | None = None,  # the caller's is_prefill(); None: test here
) -> tuple[torch.Tensor, dict | None]:
    """Returns (output [B,S,D], cache).

    ``positions`` / ``cache_pos`` / ``cache_len`` accept either the shared
    (scalar / [S]) form — every batch row at the same decode position — or
    the per-row ([B,S] / [B]) form used by continuous batching, where each
    slot advances independently.  Per-row mode keeps the mask-based paths
    (the SWA slice and the sharded flash-decode need a shared scalar
    position and are skipped)."""
    b, s, _ = x.shape
    dh, hq = cfg.d_head, cfg.hq_pad
    per_row = _is_tensor_vector(cache_pos) or _is_tensor_vector(cache_len)

    q = linear(params["wq"], x).reshape(b, s, hq, dh)
    src = memory if memory is not None else x
    t_src = src.shape[1]
    k = linear(params["wk"], src).reshape(b, t_src, cfg.n_kv_heads, dh)
    v = linear(params["wv"], src).reshape(b, t_src, cfg.n_kv_heads, dh)

    if cfg.rope_theta is not None and memory is None:
        freqs = rope_frequencies(dh, cfg.rope_theta, device=x.device)
        pos_b = positions if positions.dim() == 2 else positions[None, :]
        q = apply_rope(q, pos_b, freqs)
        k = apply_rope(k, pos_b, freqs)

    if prefill is None:
        prefill = is_prefill(s, positions, memory, cache, cache_pos)
    kernel = prefill and memory is None and s > 1 and cfg.grouped
    if cache is not None and memory is None:
        _write_cache(cache, {"k": k, "v": v}, cache_pos, s)
        t = cache["k"].shape[1]
        k_all, v_all = cache["k"], cache["v"]
        kpos = torch.arange(t, device=x.device)
        kv_len = cache_len
        # SWA decode: only the last `window` positions can score — slice
        # them out so decode work is O(window), not O(max_seq)
        if cfg.window is not None and s == 1 and t > cfg.window and not per_row:
            w = cfg.window
            end = int(cache_len) if cache_len is not None else t
            start = min(max(end - w, 0), t - w)
            k_all = k_all[:, start:start + w]
            v_all = v_all[:, start:start + w]
            kpos = start + torch.arange(w, device=x.device)
        k, v = k_all, v_all
    else:
        kpos = (torch.arange(t_src, device=x.device) if memory is not None
                else positions)
        kv_len = None

    # flash-decode: sequence-sharded cache, all-reduce combine
    if (cfg.decode_strategy == "flash" and s == 1 and cache is not None
            and memory is None and cfg.window is None and not per_row):
        mesh = current_mesh()
        if (mesh is not None
                and k.shape[1] % mesh_axis_sizes(mesh).get("model", 1) == 0):
            kv = kv_len if kv_len is not None else k.shape[1]
            out = flash_decode_sharded(cfg, q.transpose(1, 2), k, v, kv, mesh)
            out = out.transpose(1, 2).reshape(b, s, hq * dh)
            return linear(params["wo"], out.to(x.dtype)), cache

    if kernel:
        kv = int(kv_len) if kv_len is not None else k.shape[1]
        dt = torch.promote_types(q.dtype, k.dtype)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        if kh.dtype != dt:  # a cache in another type: the keys it reads
            kh, vh = kh[:, :, :kv].to(dt), vh[:, :, :kv].to(dt)
        out = ops.flash_attention(q.transpose(1, 2).to(dt), kh, vh,
                                  causal=cfg.causal, window=cfg.window,
                                  kv_len=kv)
    else:
        out = _plain_attention(cfg, q, k, v, positions, kpos,
                               cfg.causal and memory is None, kv_len)
    out = out.transpose(1, 2).reshape(b, s, hq * dh)
    return linear(params["wo"], out.to(x.dtype)), cache


def _plain_attention(cfg: AttnConfig, q, k, v, positions, kpos,
                     causal: bool, kv_len, index=None) -> torch.Tensor:
    """The plain routes (full, or chunked past ``full_attn_max_seq``)
    over q [B, S, Hq, D] and k, v [B, T, Hkv, D]: [B, Hq, S, D]
    (``index``: :func:`_expand_kv`'s)."""
    qh, kh, vh = _expand_kv(cfg, q, k, v, index)
    if max(q.shape[1], kh.shape[2]) <= cfg.full_attn_max_seq:
        return _full_attention(qh, kh, vh, positions, kpos, causal,
                               cfg.window, kv_len)
    return _chunked_attention(qh, kh, vh, positions, kpos, causal,
                              cfg.window, kv_len, cfg.chunk)


def attention_apply_tp(tp, params, cfg: AttnConfig, x: torch.Tensor,
                       positions: torch.Tensor,
                       memory: torch.Tensor | None = None,
                       seq: bool = False,
                       mem_seq: bool = False,
                       cache: PlacedCache | None = None,
                       cache_len=None,
                       prefill: bool = False) -> torch.Tensor:
    """:func:`attention_apply` on this rank's query heads over ``tp``'s
    ``model`` group (``parallel.tensor``; ``model`` divides ``cfg.hq_pad``):
    ``params`` are the rank's slabs, columns of ``wq`` (and its bias) and
    rows of ``wo`` for query heads ``[r * Hq / n, (r + 1) * Hq / n)``, so
    the routes run on the rank's heads as on all of them: the projections
    are column products and ``wo`` a row product (``column_product``,
    ``row_product``).

    The key heads: where ``tensor.attention_splits`` holds, ``wk``/``wv``
    are the slabs of the key heads the rank's query heads group over.
    Elsewhere (fewer key heads than ranks, or heads that do not group
    over the ranks, padded query heads included) the rank computes the
    key heads its query heads read under ``_expand_kv``'s map
    (``tensor.attention_kv_heads``), their ``wk``/``wv`` columns (biases
    too) re-laid out from the ranks' storage slabs (``relayout_columns``:
    each column's gradient sums over the ranks that read it) or, where
    those leaves are whole (``tensor.kv_split``), taken from them, their
    gradients summed over the group (``copy_to_model``).

    ``seq``: ``x`` is this rank's slab of the sequence, gathered into the
    column products, and the output is reduce-scattered back to the slab;
    ``mem_seq``: ``memory`` likewise.  The positions are the whole
    sequence's.

    ``cache`` (a placed serving step's, :class:`PlacedCache`: every key
    head of the rank's position slab): the new keys and values of the
    rank's key heads go, in the cache's dtype, to the ranks whose slabs
    hold the written positions (``tensor.write_positions``, all-to-all).
    A prefill (from position 0) attends over what the rank computed,
    rounded to the cache's dtype as the cache holds it, on the
    flash-attention kernel where ``prefill`` holds and ``cfg`` groups its
    heads (the rank's key heads expanded to its query heads where they
    do not group locally), else on the plain routes.  A decode reads its
    key heads at every position (or the window's) from the ranks' slabs
    (``tensor.read_positions``), or, with ``decode_strategy="flash"`` and
    no window, scores the rank's own slab for every query head
    (:func:`flash_decode_placed`).  Returns the output [B, S, D]
    (``seq``: [B, S / n, D])."""
    dh, dt = cfg.d_head, x.dtype
    params = dict(params)
    index = None
    if attention_splits(cfg, tp.size):
        per_kv = cfg.n_kv_heads // tp.size
        heads = [list(range(r * per_kv, (r + 1) * per_kv))
                 for r in range(tp.size)]
    else:
        heads = attention_kv_heads(cfg, tp.size)
        cols = [[k * dh + c for k in hs for c in range(dh)] for hs in heads]
        for name in ("wk", "wv"):
            if kv_split(cfg, tp.size):
                params[name] = {k: relayout_columns(t, cols, tp)
                                for k, t in params[name].items()}
            else:
                params[name] = {k: copy_to_model(t, tp)[..., cols[tp.rank]]
                                for k, t in params[name].items()}
        mine = heads[tp.rank]
        rep = (cfg.hq_pad // cfg.n_kv_heads if cfg.grouped
               else -(-cfg.hq_pad // cfg.n_kv_heads))
        per = cfg.hq_pad // tp.size
        index = [mine.index((tp.rank * per + i) // rep) for i in range(per)]
    if memory is None:
        q, k, v = column_product(x, [params["wq"], params["wk"],
                                     params["wv"]], tp, dt, seq)
    else:
        q = column_product(x, params["wq"], tp, dt, seq)
        k, v = column_product(memory, [params["wk"], params["wv"]], tp, dt,
                              mem_seq)
    b, s, t = q.shape[0], q.shape[1], k.shape[1]
    q = q.reshape(b, s, -1, dh)
    k, v = k.reshape(b, t, -1, dh), v.reshape(b, t, -1, dh)
    if cfg.rope_theta is not None and memory is None:
        freqs = rope_frequencies(dh, cfg.rope_theta, device=x.device)
        pos_b = positions if positions.dim() == 2 else positions[None, :]
        q, k = apply_rope(q, pos_b, freqs), apply_rope(k, pos_b, freqs)
    local = dataclasses.replace(cfg, n_heads=q.shape[2],
                                n_kv_heads=k.shape[2], model_shards=1)
    if cache is not None:
        out = _attend_placed(tp, cfg, local, q, k, v, positions, cache,
                             cache_len, prefill, heads, index)
    elif memory is None:
        out = _attend_local(cfg, local, q, k, v, positions, prefill, index)
    else:
        out = _plain_attention(local, q, k, v, positions,
                               torch.arange(t, device=x.device), False, None,
                               index)
    out = out.transpose(1, 2).reshape(b, s, -1).to(dt)
    return row_product(out, params["wo"], tp, dt, seq)


def _attend_placed(tp, cfg: AttnConfig, local: AttnConfig, q, k, v,
                   positions, cache: PlacedCache, cache_len, prefill: bool,
                   heads: list, index) -> torch.Tensor:
    """:func:`attention_apply_tp`'s attention with a placed cache (its
    docstring): q [B, S, Hq / n, D] and the rank's key heads' k, v [B, S,
    H_r, D] (``heads``: every rank's; ``index``: the key head each query
    head reads, None where they group locally).  Returns [B, Hq / n, S,
    D]."""
    pl = cache.placements["k"]
    for name, new in (("k", k), ("v", v)):
        write_positions(cache[name], pl, new, cache.pos, heads, tp)
    cdt = cache["k"].dtype
    if q.shape[1] > 1:  # a prefill from position 0: the keys the rank
        # computed, as the cache holds them
        return _attend_local(cfg, local, q, k.to(cdt), v.to(cdt), positions,
                             prefill, index)
    if cfg.decode_strategy == "flash" and cfg.window is None:
        return flash_decode_placed(tp, cfg, q.transpose(1, 2), cache,
                                   cache_len)
    lo, hi = 0, pl.shape[1]
    if cfg.window is not None and hi > cfg.window:  # the decode's window
        end = int(cache_len) if cache_len is not None else hi
        lo = min(max(end - cfg.window, 0), hi - cfg.window)
        hi = lo + cfg.window
    kc = read_positions(cache["k"], pl, lo, hi, heads, tp)
    vc = read_positions(cache["v"], pl, lo, hi, heads, tp)
    kpos = lo + torch.arange(hi - lo, device=q.device)
    return _plain_attention(local, q, kc, vc, positions, kpos, cfg.causal,
                            cache_len, index)


def _attend_local(cfg: AttnConfig, local: AttnConfig, q, k, v, positions,
                  prefill: bool, index) -> torch.Tensor:
    """Self-attention of one rank's query heads q [B, S, Hq / n, D] over
    its key heads k, v [B, S, H_r, D] at the same positions: on the
    flash-attention kernel where ``prefill`` holds (positions ``arange(S)``)
    and ``cfg`` groups its heads, as :func:`attention_apply` takes it, the
    key heads expanded to the query heads where they do not group on the
    rank (``index``); else on the plain routes.  Returns [B, Hq / n, S,
    D]."""
    if not (prefill and cfg.grouped and q.shape[1] > 1):
        return _plain_attention(local, q, k, v, positions, positions,
                                cfg.causal, None, index)
    dt = torch.promote_types(q.dtype, k.dtype)
    kh, vh = k.transpose(1, 2).to(dt), v.transpose(1, 2).to(dt)
    per, n_kv = q.shape[2], kh.shape[1]
    if index is not None and index != [i // (per // n_kv)
                                       for i in range(per)]:
        at = torch.tensor(index, device=q.device)
        kh, vh = kh.index_select(1, at), vh.index_select(1, at)
    return ops.flash_attention(q.transpose(1, 2).to(dt), kh, vh,
                               causal=cfg.causal, window=cfg.window,
                               kv_len=kh.shape[2])
