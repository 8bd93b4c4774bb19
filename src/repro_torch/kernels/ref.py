"""Plain oracles for the port's kernels (tests assert allclose)."""

from __future__ import annotations

import torch

__all__ = ["pattern_spmm_ref", "flash_attention_ref", "ou_mvm_ref"]


def pattern_spmm_ref(
    x: torch.Tensor, w_comp: torch.Tensor, block_ids: torch.Tensor, block: int
) -> torch.Tensor:
    """y = x @ W_compressed, naive loops.  x: [M, K] -> y: [M, T*tile]."""
    m, k_in = x.shape
    t, k_max, _, tile = w_comp.shape
    xb = x.reshape(m, k_in // block, block)
    cols = []
    for ti in range(t):
        acc = torch.zeros((m, tile), dtype=torch.float32, device=x.device)
        for k in range(k_max):
            xs = xb[:, int(block_ids[ti, k])]
            acc = acc + xs.float() @ w_comp[ti, k].float()
        cols.append(acc)
    return torch.cat(cols, dim=1).to(x.dtype)


def flash_attention_ref(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BHkv, Sk, D], BH a multiple of BHkv
    v: torch.Tensor,  # [BHkv, Sk, D]
    scale: float | None = None,
    causal: bool = True,
    window: int | None = None,
    kv_len: int | None = None,
) -> torch.Tensor:
    """Masked softmax attention in float32; fully-masked rows are 0.

    Query row ``i`` of the folded heads reads key row ``i // group``
    (group = BH / BHkv), which is GQA for heads folded batch-major; with
    group 1 it is the reference oracle.  ``kv_len`` masks the keys at and
    after it."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    scale = scale if scale is not None else d ** -0.5
    qg = q.float().reshape(bhk, bh // bhk, sq, d)
    s = torch.einsum("bgqd,bkd->bgqk", qg, k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows
    o = torch.einsum("bgqk,bkd->bgqd", p, v.float())
    return o.reshape(bh, sq, d).to(q.dtype)


def ou_mvm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain dense MVM — the OU walk and the all-zero skip are exact."""
    return x.float() @ w.float()
