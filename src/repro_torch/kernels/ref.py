"""Plain oracles for the port's kernels (tests assert allclose)."""

from __future__ import annotations

import torch

__all__ = ["pattern_spmm_ref", "ou_mvm_ref"]


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


def ou_mvm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain dense MVM — the OU walk and the all-zero skip are exact."""
    return x.float() @ w.float()
