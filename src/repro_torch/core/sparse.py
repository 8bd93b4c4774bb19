"""Block-pattern sparse matmul layout and its plain PyTorch execution.

Port of ``repro/core/sparse.py``.  The paper's pipeline — pattern
dictionary -> kernel reordering -> zero compression -> dense compute on
the kept bricks -> index-driven select/reorder — at brick granularity:

  * the contraction dimension K is split into ``block``-row blocks;
  * every output column gets a block mask (which blocks are nonzero);
  * output columns are permuted so equal-mask columns are adjacent
    (kernel reordering) and grouped into ``tile``-column tiles;
  * weights are stored compressed: only the nonzero blocks of each tile,
    as dense ``[block, tile]`` bricks;
  * compute walks, per output tile, only its nonzero blocks via the
    ``block_ids`` table (the Input Preprocessing Unit);
  * results are un-permuted by the stored inverse permutation (the
    Output Indexing Unit).

The layout builders are host numpy, copied from the reference so the
arrays they produce are bit-equal.  ``pattern_spmm_torch`` and
``pattern_spmm_torch_quant`` are the plain PyTorch executions (the
reference's ``pattern_spmm_xla`` / ``pattern_spmm_xla_quant``); the CUDA
kernels in ``kernels/pattern_spmm.py`` are held against them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.obs.trace import NULL_TRACER

__all__ = [
    "REORDERS",
    "BlockPatternWeight",
    "build_block_pattern",
    "nonzero_block_masks",
    "reorder_columns",
    "predicted_tile_nnz",
    "pattern_spmm_torch",
    "pattern_spmm_torch_quant",
    "block_density",
]

# column-reorder strategies build_block_pattern understands
REORDERS = ("pattern", "similarity", "hybrid")


@dataclasses.dataclass
class BlockPatternWeight:
    """Compressed block-pattern weight for y = x @ W, W: [K, N].

    Attributes:
      w_comp:     [n_tiles, k_max, block, tile] tensor — dense bricks, zero
                  padded.  float32, or int8 when quantized.
      block_ids:  [n_tiles, k_max] int32 tensor — which K-block each brick
                  is; padded entries point at block 0 with zero weights.
      nnz:        [n_tiles] int32 numpy — valid bricks per tile.
      new_order:  [N] int32 numpy — column permutation (new -> original).
      inv_order:  [N] int32 numpy — inverse permutation (original -> new).
      k_in, n_out, block, tile: geometry.
      dict_masks: [P, n_blocks] bool numpy — the layer's pattern dictionary.
      w_scales:   [n_tiles, k_max] float32 tensor of per-brick dequant
                  scales, or None for fp32 weights.
    """

    w_comp: torch.Tensor
    block_ids: torch.Tensor
    nnz: np.ndarray
    new_order: np.ndarray
    inv_order: np.ndarray
    k_in: int
    n_out: int
    block: int
    tile: int
    dict_masks: np.ndarray
    w_scales: torch.Tensor | None = None

    @property
    def n_tiles(self) -> int:
        return self.w_comp.shape[0]

    @property
    def k_max(self) -> int:
        return self.w_comp.shape[1]

    @property
    def precision(self) -> str:
        """Stored weight precision: 'fp32', or 'int8' when quantized."""
        return "int8" if self.w_scales is not None else "fp32"

    @property
    def device(self) -> torch.device:
        return self.w_comp.device

    def to(self, device) -> "BlockPatternWeight":
        """This weight with its tensors on ``device`` (self when there)."""
        device = torch.device(device)
        if self.w_comp.device == device:
            return self
        return dataclasses.replace(
            self,
            w_comp=self.w_comp.to(device),
            block_ids=self.block_ids.to(device),
            w_scales=(None if self.w_scales is None
                      else self.w_scales.to(device)),
        )

    def dense(self) -> torch.Tensor:
        """Reconstruct the dense [K, N] float32 weight (testing oracle)."""
        nb = self.k_in // self.block
        w = np.zeros((nb, self.block, self.n_out), np.float64)
        wc = self.w_comp.cpu().numpy().astype(np.float64)
        if self.w_scales is not None:
            wc = wc * self.w_scales.cpu().numpy().astype(
                np.float64)[:, :, None, None]
        ids = self.block_ids.cpu().numpy()
        for t in range(self.n_tiles):
            for k in range(int(self.nnz[t])):
                cols = slice(t * self.tile, (t + 1) * self.tile)
                w[ids[t, k], :, cols] += wc[t, k]
        w = w.reshape(self.k_in, self.n_out)
        out = np.zeros_like(w)
        out[:, self.new_order] = w
        return torch.from_numpy(out.astype(np.float32)).to(self.device)


def block_density(bp: BlockPatternWeight) -> float:
    """Fraction of K-blocks kept (= FLOP / weight-byte ratio vs dense)."""
    n_blocks = bp.k_in // bp.block
    return float(np.sum(bp.nnz)) / (bp.n_tiles * n_blocks)


def _project_masks_to_dictionary(
    masks: np.ndarray, energies: np.ndarray, num_patterns: int
) -> np.ndarray:
    """Pattern pruning of block masks.

    masks: [N, nB] bool (desired per-column block masks),
    energies: [N, nB] block L2^2 (for energy-weighted projection).

    Returns projected masks [N, nB], each row one of <= num_patterns
    dictionary masks (plus the all-zero mask).
    """
    n, nb = masks.shape
    keys = [m.tobytes() for m in masks]
    uniq: dict[bytes, int] = {}
    for k in keys:
        uniq[k] = uniq.get(k, 0) + 1
    ranked = sorted(uniq.items(), key=lambda kv: -kv[1])[:num_patterns]
    cand = np.stack(
        [np.frombuffer(k, dtype=bool).copy() for k, _ in ranked]
    )  # [P, nB]
    # project every column to the candidate keeping the most energy,
    # breaking ties toward the smaller pattern
    kept = energies @ cand.T.astype(np.float64)  # [N, P]
    sizes = cand.sum(-1)  # [P]
    score = kept - 1e-12 * sizes[None, :]
    choice = np.argmax(score, axis=1)
    return cand[choice]


def _mask_similarity_rank(uniq: np.ndarray) -> np.ndarray:
    """Greedy nearest-neighbour chain over unique block masks.

    ``uniq``: [U, nB] bool, lexicographically sorted (``np.unique`` rows).
    Starts from the heaviest mask (ties: first in lexicographic order)
    and repeatedly appends the unvisited mask with the greatest overlap
    with the current one (ties: smaller symmetric difference, then
    lexicographic position).  Returns the chain rank per unique mask.
    """
    u = np.asarray(uniq, bool)
    n = u.shape[0]
    rank = np.zeros(n, np.int64)
    if n == 0:
        return rank
    remaining = list(range(n))
    cur = int(np.argmax(u.sum(1)))  # argmax -> first max: deterministic
    for step in range(n):
        rank[cur] = step
        remaining.remove(cur)
        if not remaining:
            break
        inter = (u[remaining] & u[cur]).sum(1)
        xor = (u[remaining] ^ u[cur]).sum(1)
        # lexicographically smallest (-overlap, distance, position)
        best = min(range(len(remaining)),
                   key=lambda j: (-int(inter[j]), int(xor[j]), remaining[j]))
        cur = remaining[best]
    return rank


def reorder_columns(masks: np.ndarray, strategy: str = "pattern") -> np.ndarray:
    """Column permutation grouping equal block masks (kernel reordering).

    Returns ``new_order`` (int32 [N], new position -> original column).
    Every strategy groups equal-mask columns adjacently; only the order
    of the groups differs:

      'pattern'    — groups in lexicographic mask order (the paper's
                     kernel reordering).
      'similarity' — groups along a greedy bit-overlap chain.
      'hybrid'     — mask weight descending first, similarity-chain rank
                     within equal weights.
    """
    masks = np.asarray(masks, bool)
    if masks.ndim != 2:
        raise ValueError(f"masks must be [N, n_blocks], got {masks.shape}")
    if strategy == "pattern":
        mask_keys = np.array([m.tobytes() for m in masks])
        return np.argsort(mask_keys, kind="stable").astype(np.int32)
    if strategy not in REORDERS:
        raise ValueError(f"unknown reorder strategy {strategy!r}")
    if masks.shape[0] == 0:
        return np.zeros(0, np.int32)
    uniq, inverse = np.unique(masks, axis=0, return_inverse=True)
    chain = _mask_similarity_rank(uniq)
    if strategy == "similarity":
        rank = chain
    else:  # hybrid
        order_u = np.lexsort((chain, -uniq.sum(1)))
        rank = np.empty(len(uniq), np.int64)
        rank[order_u] = np.arange(len(uniq))
    return np.argsort(rank[inverse.reshape(-1)], kind="stable").astype(
        np.int32
    )


def predicted_tile_nnz(
    masks: np.ndarray, new_order: np.ndarray, tile: int
) -> np.ndarray:
    """Per-tile stored-brick counts a reorder would realize, without
    building the operand: exactly the ``nnz`` ``build_block_pattern``
    computes for the same ``masks``/``new_order``."""
    ms = np.asarray(masks, bool)[np.asarray(new_order)]
    n, nb = ms.shape
    if n % tile:
        raise ValueError(f"N={n} not divisible by tile={tile}")
    return ms.reshape(n // tile, tile, nb).any(axis=1).sum(-1).astype(
        np.int32
    )


def nonzero_block_masks(w: np.ndarray, block: int) -> np.ndarray:
    """Exact per-column block masks from the nonzero structure of ``w``.

    w: [K, N] with K divisible by ``block``.  Returns bool [N, K//block];
    a block is kept iff it holds at least one nonzero weight, so
    compressing with these masks is lossless.
    """
    w = np.asarray(w)
    k_in, n_out = w.shape
    if k_in % block:
        raise ValueError(f"K={k_in} not divisible by block={block}")
    return (w.reshape(k_in // block, block, n_out) != 0).any(axis=1).T


def build_block_pattern(
    w: np.ndarray,
    num_patterns: int = 8,
    density: float = 0.25,
    block: int = 128,
    tile: int = 128,
    masks: np.ndarray | None = None,
    tracer=None,
    reorder: str = "pattern",
    device: str | torch.device = "cpu",
) -> BlockPatternWeight:
    """Pattern-prune + reorder + compress a dense [K, N] weight.

    Magnitude-driven block masks -> mask PDF -> top-P dictionary ->
    projection -> column reordering -> zero compression, all in host
    numpy.  With ``masks`` ([N, K//block] bool) the projection is skipped
    and the masks are used verbatim (``nonzero_block_masks(w, block)``
    makes the build an exact re-layout of an already-pruned weight).
    ``tracer`` records ``prune``/``reorder``/``pack`` compile spans;
    ``reorder`` picks the column-permutation strategy
    (:func:`reorder_columns`).  The kernel operands land on ``device``.
    """
    tracer = tracer or NULL_TRACER
    w = np.asarray(w, np.float32)
    k_in, n_out = w.shape
    if k_in % block or n_out % tile:
        raise ValueError(f"weight {w.shape} not divisible by ({block},{tile})")
    nb = k_in // block

    if masks is None:
        with tracer.span("prune", cat="compile", n_out=n_out, n_blocks=nb):
            keep = max(1, int(np.ceil(density * nb)))
            energies = (w.reshape(nb, block, n_out) ** 2).sum(1).T  # [N, nB]
            order = np.argsort(-energies, axis=1)
            masks = np.zeros((n_out, nb), bool)
            np.put_along_axis(masks, order[:, :keep], True, axis=1)
            masks = _project_masks_to_dictionary(masks, energies, num_patterns)
    else:
        masks = np.asarray(masks, bool)
        if masks.shape != (n_out, nb):
            raise ValueError(
                f"masks shape {masks.shape} != (N={n_out}, K/block={nb})"
            )

    with tracer.span("reorder", cat="compile", n_out=n_out,
                     strategy=reorder):
        new_order = reorder_columns(masks, reorder)
        inv_order = np.argsort(new_order).astype(np.int32)
        masks_sorted = masks[new_order]
        w_sorted = w[:, new_order]

    with tracer.span("pack", cat="compile", n_out=n_out) as pack_span:
        n_tiles = n_out // tile
        tile_masks = masks_sorted.reshape(n_tiles, tile, nb).any(axis=1)
        nnz = tile_masks.sum(-1).astype(np.int32)
        k_max = max(int(nnz.max()), 1)
        pack_span.args.update(n_tiles=n_tiles, k_max=k_max)

        w_blocks = w_sorted.reshape(nb, block, n_tiles, tile)
        w_comp = np.zeros((n_tiles, k_max, block, tile), np.float32)
        block_ids = np.zeros((n_tiles, k_max), np.int32)
        for t in range(n_tiles):
            ids = np.nonzero(tile_masks[t])[0]
            for j, bid in enumerate(ids):
                # zero out the entries this tile's columns masked off
                colmask = masks_sorted[t * tile : (t + 1) * tile, bid]
                w_comp[t, j] = w_blocks[bid, :, t, :] * colmask[None, :]
                block_ids[t, j] = bid

    dict_masks = np.unique(masks, axis=0)
    return BlockPatternWeight(
        w_comp=torch.from_numpy(w_comp).to(device),
        block_ids=torch.from_numpy(block_ids).to(device),
        nnz=nnz,
        new_order=new_order,
        inv_order=inv_order,
        k_in=k_in,
        n_out=n_out,
        block=block,
        tile=tile,
        dict_masks=dict_masks,
    )


def pattern_spmm_torch(
    x: torch.Tensor,
    w_comp: torch.Tensor,
    block_ids: torch.Tensor,
    block: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch execution of the compressed matmul: y = x @ W_comp.

    x: [..., K]; w_comp: [T, k_max, block, tile]; block_ids: [T, k_max].
    Walks the k_max brick slots; each step gathers the needed x-block per
    tile (the Input Preprocessing Unit) and adds a dense
    ``[M, block] @ [block, tile]`` per tile into a float32 accumulator.
    Padded slots hold zero weights.  Output in reordered column order.
    """
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k_in = x.shape[-1]
    m = int(np.prod(lead)) if lead else 1
    xb = x.reshape(m, k_in // block, block).float()
    t, k_max, _, tile = w_comp.shape
    ids = block_ids.long()
    acc = torch.zeros((m, t, tile), dtype=torch.float32, device=x.device)
    for k in range(k_max):
        xg = xb[:, ids[:, k]]  # [M, T, block]
        acc = acc + torch.einsum("mtb,tbn->mtn", xg, w_comp[:, k].float())
    return acc.reshape(*lead, t * tile).to(out_dtype)


def pattern_spmm_torch_quant(
    xq: torch.Tensor,
    x_scale: torch.Tensor | None,
    w_comp: torch.Tensor,
    block_ids: torch.Tensor,
    w_scales: torch.Tensor,
    block: int,
) -> torch.Tensor:
    """Plain PyTorch execution of the int8 compressed matmul.

    xq: int8 [M, K] per-row quantized activations with scales ``x_scale``
    [M]; w_comp: int8 [T, k_max, block, tile] with per-brick scales
    ``w_scales`` [T, k_max].  Each brick's partial ``xq_k @ wq_{t,k}`` is
    an exact integer (summed in float64, which holds every partial of
    int8 products over a brick exactly, on the CPU and the card alike);
    it folds into the float32 accumulator as ``acc + w_scale * partial``
    in k order, then the row scale multiplies once:

        y = x_scale[:, None] * sum_k w_scales[t, k] * (xq_k @ wq_{t,k})

    ``x_scale=None`` skips that epilogue (the kernel's contract).
    """
    m, k_in = xq.shape
    xb = xq.reshape(m, k_in // block, block).double()
    t, k_max, _, tile = w_comp.shape
    ids = block_ids.long()
    acc = torch.zeros((m, t, tile), dtype=torch.float32, device=xq.device)
    for k in range(k_max):
        xg = xb[:, ids[:, k]]  # [M, T, block]
        part = torch.einsum("mtb,tbn->mtn", xg, w_comp[:, k].double())
        acc = acc + w_scales[:, k].float()[None, :, None] * part.float()
    if x_scale is not None:
        acc = acc * x_scale[:, None, None]
    return acc.reshape(m, t * tile)
