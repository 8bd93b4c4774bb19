"""Shared model building blocks: norms, embeddings, RoPE, MLPs, PatternLinear.

Port of ``src/repro/models/layers.py``.  Every ``*_init`` draws from an
explicit ``torch.Generator`` (on the device it creates its tensors on)
and returns a dict of parameter tensors — the MLP and the pattern-sparse
linear also return their static layout.  The reference's ``*_init``
also returns the params' logical-axis specs; here a ``*_specs`` beside
each ``*_init`` builds that tree (tuples of logical axis names, the
reference's, leaf for leaf) from the same arguments and draws nothing,
and ``parallel.sharding.tree_pspecs`` resolves it on a mesh.  All
``*_apply`` are functions of their arguments.  Compute dtype is the
caller's; params are created in ``param_dtype``.

The pattern-sparse layouts (``_fake_block_ids``, ``_fake_pattern_groups``)
are the reference's numpy, copied, so a layout here is bit-equal to the
reference's for the same arguments.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sparse import pattern_spmm_torch
from repro_torch.kernels.ops import pattern_spmm_raw
from repro_torch.parallel.tensor import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
)

__all__ = [
    "PatternSparseConfig",
    "rmsnorm_init", "rmsnorm",
    "layernorm_init", "layernorm",
    "embed_init",
    "linear_init", "linear",
    "sparse_linear_static", "sparse_linear_init", "sparse_linear",
    "sparse_tables", "sparse_tiles", "sparse_columns",
    "mlp_static", "mlp_init", "mlp_apply", "mlp_apply_tp", "silu", "gelu",
    "rmsnorm_specs", "layernorm_specs", "embed_specs", "linear_specs",
    "sparse_linear_specs", "mlp_specs",
    "rope_frequencies", "apply_rope",
]


# ---------------------------------------------------------------------------
# pattern-sparse linear (the paper's technique, block-granular)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PatternSparseConfig:
    """Config for block-pattern sparse linears (the paper's technique).

    density:      fraction of 128-row blocks kept per output column.
    num_patterns: dictionary size (pattern pruning).
    kmax_slack:   static head-room over ceil(density * n_blocks) for tile
                  unions after reordering (mixed tiles).
    """

    density: float = 0.25
    num_patterns: int = 8
    block: int = 128
    tile: int = 128
    kmax_slack: float = 1.5

    def k_max(self, k_in: int) -> int:
        nb = k_in // self.block
        return max(1, min(nb, int(np.ceil(self.density * nb * self.kmax_slack))))

    def applicable(self, k_in: int, n_out: int, model_shards: int) -> bool:
        # the tile table pads itself to a multiple of model_shards, so only
        # block/tile alignment of the true dims is required
        return k_in % self.block == 0 and n_out % self.tile == 0


def _fake_block_ids(
    n_tiles: int, k_max: int, n_blocks: int, seed: int
) -> np.ndarray:
    """Statistically-plausible block index table for init/dry-run.

    Sorted unique ids per tile (what a real layout produces); padding slots
    repeat the last id (their weight bricks are zero).
    """
    rng = np.random.default_rng(seed)
    ids = np.zeros((n_tiles, k_max), np.int32)
    for t in range(n_tiles):
        pick = np.sort(rng.choice(n_blocks, size=min(k_max, n_blocks), replace=False))
        ids[t, : pick.size] = pick
        ids[t, pick.size :] = pick[-1] if pick.size else 0
    return ids


def _fake_pattern_groups(
    n_tiles: int, k_max: int, n_blocks: int, num_patterns: int, seed: int,
    model_shards: int = 1,
) -> list[dict]:
    """Dictionary-level layout: tiles grouped by shared pattern.

    This is the paper's kernel-reordering invariant at tile granularity —
    after reordering, tiles with the same pattern are contiguous, so the
    plain path can run ONE gather + ONE dense matmul per dictionary pattern
    (pattern blocks), instead of per-brick gathers.  Group boundaries are
    rounded to shard-chunk multiples so slices of the tiles-sharded weight
    stay local.  Returns [{'tiles': (start, stop), 'blocks': ids}].
    """
    rng = np.random.default_rng(seed)
    chunk = max(1, n_tiles // max(model_shards, 1))
    n_groups = min(num_patterns, max(1, n_tiles // chunk))
    bounds = np.linspace(0, n_tiles, n_groups + 1)
    bounds = np.round(bounds / chunk).astype(int) * chunk
    bounds[0], bounds[-1] = 0, n_tiles
    groups = []
    for g in range(n_groups):
        if bounds[g + 1] <= bounds[g]:
            continue
        pick = np.sort(rng.choice(n_blocks, size=min(k_max, n_blocks),
                                  replace=False))
        groups.append({
            "tiles": (int(bounds[g]), int(bounds[g + 1])),
            "blocks": pick.astype(np.int32),
        })
    return groups


def sparse_tables(static: dict, device) -> dict:
    """Device copies of a sparse layout's index tables, made once: the
    groups' block ids, the brick table with its ``nnz`` (every slot of
    the init layouts is real), and the inverse permutation (None when it
    is the identity)."""
    inv = static["inv_order"]
    n_out = static["n_out"]
    ids = static["block_ids"]
    return {
        "groups": [torch.as_tensor(g["blocks"], dtype=torch.long,
                                   device=device)
                   for g in static["groups"]],
        "block_ids": torch.as_tensor(ids, dtype=torch.int32, device=device),
        "nnz": torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32,
                          device=device),
        "inv_order": (None if np.array_equal(inv, np.arange(n_out))
                      else torch.as_tensor(inv, dtype=torch.long,
                                           device=device)),
    }


def sparse_linear_static(
    k_in: int,
    n_out: int,
    cfg: PatternSparseConfig,
    seed: int = 0,
    model_shards: int = 16,
    device=None,
) -> dict:
    """The static layout of a block-pattern compressed linear: the
    reference's keys (``block_ids``, ``groups``, ``inv_order``, ``block``,
    ``tile``, ``n_out``) as numpy, plus ``"tables"``, their device copies
    (:func:`sparse_tables`).

    The tile table is padded to a multiple of ``model_shards`` so the tiles
    dim shards evenly on any d_ff; padded tiles hold zero bricks and their
    output columns are sliced off.
    """
    nb = k_in // cfg.block
    n_tiles = n_out // cfg.tile
    n_tiles_pad = ((n_tiles + model_shards - 1) // model_shards) * model_shards
    k_max = cfg.k_max(k_in)
    static = {
        "block_ids": _fake_block_ids(n_tiles_pad, k_max, nb, seed),
        "groups": _fake_pattern_groups(
            n_tiles_pad, k_max, nb, cfg.num_patterns, seed,
            model_shards=model_shards,
        ),
        "inv_order": np.arange(n_out, dtype=np.int32),
        "block": cfg.block,
        "tile": cfg.tile,
        "n_out": n_out,
    }
    static["tables"] = sparse_tables(static, device)
    return static


def sparse_linear_init(
    generator: torch.Generator,
    k_in: int,
    n_out: int,
    cfg: PatternSparseConfig,
    param_dtype=torch.float32,
    seed: int = 0,
    model_shards: int = 16,
    device=None,
):
    """Block-pattern compressed linear: ``(params, static)``.  The layout
    (block_ids, inv_order) is a static constant (the paper's weight-index
    buffer); ``w_comp`` is the compressed weight."""
    static = sparse_linear_static(k_in, n_out, cfg, seed, model_shards, device)
    return _sparse_params(generator, static, k_in, cfg, param_dtype,
                          device), static


def sparse_linear_specs() -> dict:
    """The compressed weight's tile axis is the tensor-parallel dim."""
    return {"w_comp": ("tiles", None, None, None)}


def _sparse_params(generator, static, k_in: int, cfg: PatternSparseConfig,
                   param_dtype, device) -> dict:
    """``w_comp`` for a sparse layout: normal bricks scaled by
    1 / sqrt(k_in * density), zero in the tile-padding tiles."""
    n_tiles_pad, k_max = static["block_ids"].shape
    scale = 1.0 / np.sqrt(k_in * cfg.density)
    w = _normal(generator, (n_tiles_pad, k_max, cfg.block, cfg.tile),
                scale, param_dtype, device)
    w[static["n_out"] // cfg.tile:] = 0.0
    return {"w_comp": w}


def sparse_linear(params, static, x: torch.Tensor,
                  kernels: bool = True) -> torch.Tensor:
    """y = x @ W_compressed.

    When the layout carries dictionary groups (tiles sharing a pattern are
    contiguous — the paper's kernel reordering), compute runs as one gather
    + one dense matmul per *pattern* (pattern blocks), the paper's compute
    structure; the reference leaves those matmuls to XLA outside any Pallas
    kernel, and here they are ``torch.matmul``.  An arbitrary ``block_ids``
    table with no groups goes through ``kernels.ops.pattern_spmm_raw``
    (the Hopper spmm kernel on a CUDA tensor), or, with ``kernels=False``,
    through its plain version ``core.sparse.pattern_spmm_torch`` (the
    reference's ``pattern_spmm_xla``), which autograd differentiates.
    """
    return sparse_columns(sparse_tiles(params, static, x, 0, kernels),
                          static)


def sparse_tiles(params, static, x: torch.Tensor, t0: int,
                 kernels: bool = True) -> torch.Tensor:
    """x @ the tiles ``[t0, t0 + T)`` of a compressed weight whose
    ``params["w_comp"]`` holds those ``T`` tiles (all of them at ``t0 =
    0``, a tensor-parallel rank's slab otherwise): ``[..., T * tile]``
    columns in tile order, before :func:`sparse_columns`.  A dictionary
    group that the slab cuts computes its tiles inside the slab, on the
    group's own block gather."""
    groups = static.get("groups")
    tables = static["tables"]
    w_comp = params["w_comp"].to(x.dtype)
    t1 = t0 + w_comp.shape[0]
    block, tile = static["block"], static.get("tile", w_comp.shape[-1])
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    m = xm.shape[0]
    if groups:
        xb = xm.reshape(m, -1, block)
        outs = []
        for g, blocks in zip(groups, tables["groups"]):
            g0, g1 = max(g["tiles"][0], t0), min(g["tiles"][1], t1)
            if g0 >= g1:
                continue
            s_p = len(g["blocks"])
            # pattern block: gather once, one dense matmul (paper Fig 4)
            xg = xb.index_select(1, blocks).reshape(m, s_p * block)
            # bricks of this group in tile order -> [s_p*block, cols]
            wg = w_comp[g0 - t0:g1 - t0, :s_p].permute(1, 2, 0, 3).reshape(
                s_p * block, (g1 - g0) * tile
            )
            outs.append(xg @ wg)
        y = torch.cat(outs, dim=-1)
    elif kernels:
        y = pattern_spmm_raw(
            xm, w_comp.float(), tables["block_ids"][t0:t1], block,
            nnz=tables["nnz"][t0:t1],
        ).to(x.dtype)
    else:
        y = pattern_spmm_torch(xm, w_comp, tables["block_ids"][t0:t1], block,
                               out_dtype=torch.float32).to(x.dtype)
    return y.reshape(*lead, y.shape[-1])


def sparse_columns(y: torch.Tensor, static) -> torch.Tensor:
    """All tiles' columns (:func:`sparse_tiles` at ``t0 = 0``) as the
    layer's output: the tile-padding columns dropped, then the inverse
    permutation (the Output Indexing Unit)."""
    n_out = static["n_out"]
    if y.shape[-1] != n_out:  # drop tile-padding columns
        y = y[..., :n_out]
    if static["tables"]["inv_order"] is not None:
        y = y.index_select(-1, static["tables"]["inv_order"])
    return y


# ---------------------------------------------------------------------------
# dense primitives
# ---------------------------------------------------------------------------


def _normal(generator, shape, scale, dtype, device) -> torch.Tensor:
    """Standard normal draws from ``generator`` in float32, scaled in
    place (one float32 copy at a time: a jamba MoE layer's expert stack
    is 12.9 GB of it), then cast to ``dtype``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def rmsnorm_init(d: int, param_dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=param_dtype, device=device)}


def rmsnorm_specs() -> dict:
    return {"scale": ("embed",)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, param_dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=param_dtype, device=device),
            "bias": torch.zeros((d,), dtype=param_dtype, device=device)}


def layernorm_specs() -> dict:
    return {"scale": ("embed",), "bias": ("embed",)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def embed_init(generator, vocab: int, d: int, param_dtype=torch.float32,
               device=None):
    return {"w": _normal(generator, (vocab, d), d ** -0.5, param_dtype,
                         device)}


def embed_specs() -> dict:
    return {"w": ("vocab", "embed")}


def linear_init(
    generator,
    d_in: int,
    d_out: int,
    bias: bool = False,
    param_dtype=torch.float32,
    scale: float | None = None,
    device=None,
):
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": _normal(generator, (d_in, d_out), scale, param_dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=param_dtype, device=device)
    return p


def linear_specs(in_axis: str | None = "embed", out_axis: str | None = "ff",
                 bias: bool = False) -> dict:
    """``w`` is ``(in_axis, out_axis)``; the bias follows the output."""
    s = {"w": (in_axis, out_axis)}
    if bias:
        s["b"] = (out_axis,)
    return s


def linear(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU), optionally pattern-sparse
# ---------------------------------------------------------------------------


def _mlp_is_sparse(d_model: int, d_ff: int,
                   sparse: PatternSparseConfig | None,
                   model_shards: int) -> bool:
    """The sparse config applies to both projections' shapes."""
    return sparse is not None and sparse.applicable(
        d_model, d_ff, model_shards
    ) and sparse.applicable(d_ff, d_model, model_shards)


def mlp_static(
    d_model: int,
    d_ff: int,
    act: str = "swiglu",
    sparse: PatternSparseConfig | None = None,
    model_shards: int = 16,
    device=None,
) -> dict:
    """The MLP's static part: its activation and, when the sparse config
    applies to both projections' shapes, the three sparse layouts."""
    static = {"act": act, "sparse": None}
    if _mlp_is_sparse(d_model, d_ff, sparse, model_shards):
        static["sparse"] = sparse
        shapes = {"up": (d_model, d_ff, 2), "down": (d_ff, d_model, 3)}
        if act == "swiglu":
            shapes["gate"] = (d_model, d_ff, 1)
        for name, (k_in, n_out, seed) in shapes.items():
            static[name] = sparse_linear_static(
                k_in, n_out, sparse, seed=seed, model_shards=model_shards,
                device=device,
            )
    return static


def mlp_init(
    generator,
    d_model: int,
    d_ff: int,
    act: str = "swiglu",
    sparse: PatternSparseConfig | None = None,
    model_shards: int = 16,
    param_dtype=torch.float32,
    device=None,
):
    """Returns (params, static).  static carries sparse layouts."""
    static = mlp_static(d_model, d_ff, act, sparse, model_shards, device)
    params = {}
    if static["sparse"] is not None:
        for name in ("gate", "up", "down"):
            if name in static:
                k_in = d_ff if name == "down" else d_model
                params[name] = _sparse_params(generator, static[name], k_in,
                                              sparse, param_dtype, device)
    else:
        if act == "swiglu":
            params["gate"] = linear_init(generator, d_model, d_ff,
                                         param_dtype=param_dtype,
                                         device=device)
        params["up"] = linear_init(generator, d_model, d_ff,
                                   param_dtype=param_dtype, device=device)
        params["down"] = linear_init(generator, d_ff, d_model,
                                     param_dtype=param_dtype, device=device)
    return params, static


def mlp_specs(
    d_model: int,
    d_ff: int,
    act: str = "swiglu",
    sparse: PatternSparseConfig | None = None,
    model_shards: int = 16,
) -> dict:
    """The specs of :func:`mlp_init`'s params for the same arguments."""
    names = ("gate", "up", "down") if act == "swiglu" else ("up", "down")
    if _mlp_is_sparse(d_model, d_ff, sparse, model_shards):
        return {n: sparse_linear_specs() for n in names}
    return {n: linear_specs("ff", "embed") if n == "down"
            else linear_specs("embed", "ff") for n in names}


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: ``x * (1 / (1 +
    exp(-x)))``, each step rounded in x's dtype.  In bf16 it equals
    ``jax.nn.silu`` on the CPU bit for bit, where ``F.silu`` (one rounding)
    differs in the last bit of ~40 % of values; over jamba's 8 smoke
    layers that alone puts the logits 5.3e-2 of the largest off the
    reference's, against 1.3e-2 (``scripts/bf16_parity_check.py``)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (``approximate=True``, its default) as the reference
    computes it: ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 *
    x**3))))``, each step rounded in x's dtype, the two constants rounded
    to it first and the cube as ``(x * x) * x`` (``lax.integer_pow``'s
    order).  In bf16 it equals ``jax.nn.gelu`` on the CPU bit for bit,
    where ``F.gelu(approximate="tanh")`` (one rounding) differs in ~43 %
    of values; in float32 the two lie within a few ulps of ``x``
    (``tanh``'s last bit)."""
    c = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    k = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1 + torch.tanh(k * (x + c * (x * x * x)))))


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return gelu(x)
    if name == "relu":
        return F.relu(x)
    if name == "silu":
        return silu(x)
    raise ValueError(name)


def mlp_apply(params, static, x: torch.Tensor,
              kernels: bool = True) -> torch.Tensor:
    """The MLP; ``kernels`` goes to each sparse projection
    (:func:`sparse_linear`)."""
    sparse = static.get("sparse")
    if sparse is not None:
        up = sparse_linear(params["up"], static["up"], x, kernels)
        if static["act"] == "swiglu":
            gate = sparse_linear(params["gate"], static["gate"], x, kernels)
            h = silu(gate) * up
        else:
            h = _act(static["act"], up)
        return sparse_linear(params["down"], static["down"], h, kernels)
    up = linear(params["up"], x)
    if static["act"] == "swiglu":
        h = silu(linear(params["gate"], x)) * up
    else:
        h = _act(static["act"], up)
    return linear(params["down"], h)


def mlp_apply_tp(tp, params, static, x: torch.Tensor,
                 kernels: bool = True) -> torch.Tensor:
    """:func:`mlp_apply` on this rank's slab over ``tp``'s ``model``
    group (``parallel.tensor``): dense, column-parallel ``up``/``gate``
    and row-parallel ``down`` with one all-reduce; sparse, each rank its
    tiles of each projection, whose columns are gathered whole (the tile
    order and ``inv_order`` span all of ``ff``, and ``down``'s
    ``block_ids`` read all of it)."""
    x = copy_to_model(x, tp)
    if static.get("sparse") is None:
        up = linear(params["up"], x)
        if static["act"] == "swiglu":
            h = silu(linear(params["gate"], x)) * up
        else:
            h = _act(static["act"], up)
        down = params["down"]
        y = reduce_from_model(h @ down["w"].to(h.dtype), tp)
        return y + down["b"].to(h.dtype) if "b" in down else y

    def proj(name, inp):
        t0 = tp.rank * params[name]["w_comp"].shape[0]
        cols = sparse_tiles(params[name], static[name], inp, t0, kernels)
        return sparse_columns(gather_from_model(cols, tp), static[name])

    up = proj("up", x)
    if static["act"] == "swiglu":
        h = silu(proj("gate", x)) * up
    else:
        h = _act(static["act"], up)
    return proj("down", copy_to_model(h, tp))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                               device=device) / d_head)
    )


def apply_rope(
    x: torch.Tensor,  # [..., S, H, D] or [..., S, D]
    positions: torch.Tensor,  # [..., S]
    freqs: torch.Tensor,  # [D/2]
) -> torch.Tensor:
    angles = positions[..., None].float() * freqs  # [..., S, D/2]
    if x.dim() == angles.dim() + 1:  # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
