"""Mamba-2 SSD (state-space duality) block.

Port of ``src/repro/models/ssm.py``.  Chunked matmul-form SSD (Dao & Gu
2024): the sequence is split into chunks; within a chunk the output is a
masked quadratic form, across chunks a compact state ``[H, P, N]`` is
carried by a linear recurrence (the reference's ``lax.scan``, a Python
loop over the chunks here).  Decode is the single-step recurrence on the
cached state.  The reference computes all of it in XLA einsums, outside
any Pallas kernel, and so does the port, in plain tensor ops.

The two routes are chosen by ``S == 1`` alone, as in the reference: a
one-token prompt takes the recurrence at prefill too.  Everything from
the convolution's output on is float32 whatever the compute dtype, as in
the reference, and the casts back sit where the reference's do.  The
intra-chunk term is ``(C B^T) * L`` followed by a batched matmul over the
key index, so no ``[.., q, k, H, P]`` tensor is ever formed.  Nothing
here reads the device from the host.

The cache ``{conv [B, d_conv - 1, conv_dim], state [B, H, P, N]}`` is
written in place (the reference returns a new one).

:func:`ssm_apply_tp` is the sharded train step's twin
(``parallel.tensor``): each rank of the ``model`` group computes its
heads, the columns of ``in_proj`` and the conv re-laid out from their
storage slabs (:func:`ssm_columns`), the gated RMSNorm's sum of squares
all-reduced over the inner width, ``out_proj`` row-parallel.

Technique note (DESIGN §4): the paper's pattern sparsity applies to
in_proj / out_proj (plain matmuls); the SSD recurrence itself has no
weight matrix to prune.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    _normal,
    linear,
    linear_init,
    linear_specs,
    rmsnorm,
    rmsnorm_init,
    rmsnorm_specs,
    silu,
)
from repro_torch.parallel.tensor import (
    column_product,
    columns_to_slabs,
    copy_to_model,
    reduce_from_model,
    relayout_columns,
    row_product,
)

__all__ = ["SSMConfig", "ssm_init", "ssm_specs", "ssm_apply",
           "ssm_apply_tp", "ssm_columns", "init_ssm_cache"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    model_shards: int = 16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def ssm_init(generator, cfg: SSMConfig, param_dtype=torch.float32,
             device=None):
    """The layer's params on ``device`` (``None``: ``cuda``, raising
    without one), drawn from ``generator`` (on ``device``)."""
    device = resolve_device(device)
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    kw = dict(param_dtype=param_dtype, device=device)
    # in_proj -> [z, xBC, dt]
    d_in_proj = 2 * di + 2 * cfg.n_groups * cfg.d_state + h
    return {
        "in_proj": linear_init(generator, d, d_in_proj, **kw),
        "conv_w": _normal(generator, (cfg.d_conv, cfg.conv_dim),
                          cfg.d_conv ** -0.5, param_dtype, device),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=param_dtype,
                              device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=device)).to(param_dtype),
        "D": torch.ones((h,), dtype=param_dtype, device=device),
        "dt_bias": torch.zeros((h,), dtype=param_dtype, device=device),
        "norm": rmsnorm_init(di, param_dtype, device),
        "out_proj": linear_init(generator, di, d, **kw),
    }


def ssm_specs(cfg: SSMConfig) -> dict:
    """The specs of :func:`ssm_init`'s params: the inner width and the
    heads over ``model``."""
    return {"in_proj": linear_specs("embed", "ff"),
            "conv_w": ("conv", "ff"), "conv_b": ("ff",),
            "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
            "norm": rmsnorm_specs(),
            "out_proj": linear_specs("ff", "embed")}


def init_ssm_cache(cfg: SSMConfig, batch: int, dtype=torch.float32,
                   device=None):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                             dtype=dtype, device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (torch's
    ``softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(cfg: SSMConfig, xbc: torch.Tensor, w, b, conv_state=None):
    """Depthwise causal conv1d.  xbc: [B, S, C].  The taps sum in float32
    in tap order, then the bias and SiLU, then the cast back."""
    k = cfg.d_conv
    if conv_state is not None:
        xin = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    else:
        xin = F.pad(xbc, (0, 0, k - 1, 0))
    s_out = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + xin[:, i: i + s_out].float() * w[i].float()
    out = out + b.float()
    new_state = xin[:, -(k - 1):] if k > 1 else None
    return silu(out).to(xbc.dtype), new_state


def _ssd_chunked(cfg: SSMConfig, xh, dt, a, B, C, init_state):
    """Chunked SSD scan.

    xh: [Bt, S, H, P]; dt: [Bt, S, H]; a = -exp(A_log): [H];
    B, C: [Bt, S, G, N]; init_state: [Bt, H, P, N].
    Returns (y [Bt, S, H, P], final_state).
    """
    bsz, s, h, p = xh.shape
    g, n = B.shape[2], B.shape[3]
    q = cfg.chunk
    nc = s // q
    assert s % q == 0, "sequence must be a multiple of the SSD chunk"
    rep = h // g

    # per-head log-decay per step, chunked, heads before positions:
    # [Bt, nc, h, q]
    cum = torch.cumsum((dt * a[None, None, :]).reshape(bsz, nc, q, h),
                       dim=2).transpose(2, 3)
    total = cum[..., -1]  # [Bt, nc, h]
    # dt-weighted input: [Bt, nc, h, q, p]
    x_c = (xh * dt[..., None]).reshape(bsz, nc, q, h, p).permute(0, 1, 3, 2,
                                                                 4)
    # groups broadcast over their heads as jnp.repeat does: head i reads
    # group i // rep
    B_c = B.reshape(bsz, nc, q, g, n).permute(0, 1, 3, 2, 4)  # [Bt,nc,g,q,n]
    C_c = C.reshape(bsz, nc, q, g, n).permute(0, 1, 3, 2, 4)
    B_h = B_c.repeat_interleave(rep, dim=2)  # [Bt, nc, h, q, n]
    C_h = C_c.repeat_interleave(rep, dim=2)

    # intra-chunk (masked quadratic) term.  L[i, j] = exp(cum[i] - cum[j])
    # for i >= j; the exponent is masked BEFORE exp, since the upper
    # triangle's positive exponents overflow.
    diff = cum[..., :, None] - cum[..., None, :]  # [Bt, nc, h, qi, qj]
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    L = torch.exp(diff.masked_fill(~mask, float("-inf")))
    del diff
    cb = (C_c @ B_c.transpose(-1, -2)).repeat_interleave(rep, dim=2)
    y = (cb * L) @ x_c  # [Bt, nc, h, q, p]
    del cb, L

    # chunk-final states: S_c = sum_j exp(total - cum[j]) * x_j B_j^T
    decay_to_end = torch.exp(total[..., None] - cum)  # [Bt, nc, h, q]
    states = (x_c * decay_to_end[..., None]).transpose(-1, -2) @ B_h

    # inter-chunk recurrence over the chunk index
    st = init_state
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # [Bt, nc, h, p, n]

    # inter-chunk contribution: y_j += exp(cum_j) C_j state_prev
    y = y + (C_h @ prev_states.transpose(-1, -2)) * torch.exp(cum)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    return y, st


def ssm_apply(
    params,
    cfg: SSMConfig,
    x: torch.Tensor,  # [B, S, D]
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Returns (output [B, S, D], cache written in place)."""
    return _ssm(params, cfg, x, cache)


def _ssm(params, cfg: SSMConfig, x: torch.Tensor, cache: dict | None,
         tp=None, seq: bool = False):
    """:func:`ssm_apply` on the heads ``params`` carry: ``A_log`` gives
    their count H, ``in_proj``'s width (``2 H P + 2 G N + H``, packed
    z | x | B | C | dt) the groups G.  With ``tp`` these are one rank's
    (:func:`ssm_apply_tp`): ``in_proj`` a column product and ``out_proj``
    a row product over the ranks (``parallel.tensor``, each rounding once
    as one product does), and the gated RMSNorm's sum of squares sums
    over the ranks; ``seq``: ``x`` is the rank's slab of the sequence,
    the products gathering and reduce-scattering it."""
    p, n = cfg.head_dim, cfg.d_state
    h = params["A_log"].shape[-1]
    di = h * p
    g = (params["in_proj"]["w"].shape[-1] - 2 * di - h) // (2 * n)

    if tp is None:
        zxbcdt = linear(params["in_proj"], x)
    else:
        zxbcdt = column_product(x, params["in_proj"], tp, x.dtype, seq)
    b, s, _ = zxbcdt.shape
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]  # [.., h]
    dt = _softplus(dt.float() + params["dt_bias"].float())  # [B, S, H]
    a = -torch.exp(params["A_log"].float())  # [H]

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(cfg, xbc, params["conv_w"],
                                 params["conv_b"], conv_state)
    xh = xbc[..., :di].reshape(b, s, h, p).float()
    Bmat = xbc[..., di: di + g * n].reshape(b, s, g, n).float()
    Cmat = xbc[..., di + g * n:].reshape(b, s, g, n).float()

    init_state = (cache["state"].float() if cache is not None
                  else torch.zeros((b, h, p, n), dtype=torch.float32,
                                   device=x.device))

    if s == 1:  # decode: single recurrence step
        rep = h // g
        B_h = Bmat[:, 0].repeat_interleave(rep, dim=1)  # [B, h, n]
        C_h = Cmat[:, 0].repeat_interleave(rep, dim=1)
        da = torch.exp(dt[:, 0] * a[None, :])  # [B, h]
        dx = xh[:, 0] * dt[:, 0][..., None]  # [B, h, p]
        state = (init_state * da[:, :, None, None]
                 + dx[..., :, None] * B_h[..., None, :])
        y = (state @ C_h[..., None])[..., 0][:, None]  # [B, 1, h, p]
        final_state = state
    else:
        pad = (-s) % cfg.chunk
        xs, dts, Bs, Cs = xh, dt, Bmat, Cmat
        if pad:  # dt = 0 in the pad: the carried state passes it unchanged
            xs = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dts = F.pad(dt, (0, 0, 0, pad))
            Bs = F.pad(Bmat, (0, 0, 0, 0, 0, pad))
            Cs = F.pad(Cmat, (0, 0, 0, 0, 0, pad))
        y, final_state = _ssd_chunked(cfg, xs, dts, a, Bs, Cs, init_state)
        y = y[:, :s]

    y = y + xh * params["D"].float()[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = y * silu(z.float()).to(x.dtype)
    if tp is None:
        out = linear(params["out_proj"], rmsnorm(params["norm"], y))
    else:
        out = row_product(_gated_norm_tp(tp, params["norm"], y,
                                         cfg.d_inner),
                          params["out_proj"], tp, y.dtype, seq)

    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(final_state)
    return out, cache


def _gated_norm_tp(tp, params, y: torch.Tensor, width: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """``layers.rmsnorm`` over the whole inner width of which ``y`` is
    this rank's slice: the sum of squares summed over ``tp``'s ranks (its
    gradient too, as every rank's slice reads it), and ``params``'s whole
    ``scale`` entering by ``copy_to_model``, so its gradient sums the
    ranks' slices and stays whole."""
    yf = y.float()
    ss = copy_to_model(reduce_from_model(
        (yf * yf).sum(dim=-1, keepdim=True), tp), tp)
    w = y.shape[-1]
    scale = copy_to_model(params["scale"], tp)[tp.rank * w:(tp.rank + 1) * w]
    out = yf * torch.rsqrt(ss / width + eps)
    return (out * scale.float()).to(y.dtype)


def ssm_columns(cfg: SSMConfig, n: int) -> tuple[list, list]:
    """For each of ``n`` model ranks, the columns (global indices) it
    computes with, of ``in_proj`` (z | x | B | C | dt) and of the conv
    (x | B | C): its heads ``[r H / n, (r + 1) H / n)`` of z, x and dt
    and the groups they read of B and C, in the packed order, so one
    rank's columns pack as a model of its heads does."""
    h, p, g, ns = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    di, rep, hl = cfg.d_inner, h // g, h // n
    in_cols, conv_cols = [], []
    for r in range(n):
        ch = list(range(r * hl * p, (r + 1) * hl * p))
        g0, g1 = r * hl // rep, ((r + 1) * hl - 1) // rep + 1
        grp = list(range(g0 * ns, g1 * ns))
        xbc = ch + [di + c for c in grp] + [di + g * ns + c for c in grp]
        in_cols.append(ch + [di + c for c in xbc]
                       + [2 * di + 2 * g * ns + r * hl + i
                          for i in range(hl)])
        conv_cols.append(xbc)
    return in_cols, conv_cols


def ssm_apply_tp(tp, params, cfg: SSMConfig, x: torch.Tensor,
                 seq: bool = False, cache: dict | None = None
                 ) -> torch.Tensor:
    """:func:`ssm_apply` on this rank's heads over ``tp``'s ``model`` group
    (``parallel.tensor.ssm_splits`` holds for ``cfg``): ``params`` are
    the rank's storage slabs.  The columns of ``in_proj``, ``conv_w`` and
    ``conv_b`` this rank's heads compute with are re-laid out from the
    ranks' slabs (``relayout_columns``, the gradients sent back to the
    owners); ``A_log``, ``D``, ``dt_bias`` and ``out_proj``'s rows are
    the rank's heads already.  Returns the output [B, S, D], summed over
    the group.  ``seq``: ``x`` is this rank's slab of the sequence,
    gathered into ``in_proj`` (the scan runs over the whole sequence),
    and the output is reduce-scattered back to the slab.

    ``cache`` (a placed serving step's ``models.attention.PlacedCache``):
    ``conv`` is the rank's storage slab of the packed conv columns, re-laid
    out to its heads' columns as ``conv_w`` is and the new window laid
    back (``tensor.columns_to_slabs``); ``state`` is the slab of the
    rank's heads, read and written in place."""
    in_cols, conv_cols = ssm_columns(cfg, tp.size)
    local = {**params,
             "in_proj": {"w": relayout_columns(params["in_proj"]["w"],
                                               in_cols, tp)},
             "conv_w": relayout_columns(params["conv_w"], conv_cols, tp),
             "conv_b": relayout_columns(params["conv_b"], conv_cols, tp)}
    run = None
    if cache is not None:
        run = {"conv": relayout_columns(cache["conv"], conv_cols, tp),
               "state": cache["state"]}
    out = _ssm(local, cfg, x, run, tp, seq)[0]
    if cache is not None:
        cache["conv"].copy_(columns_to_slabs(run["conv"], conv_cols,
                                             cfg.conv_dim, tp))
    return out
