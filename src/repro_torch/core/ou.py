"""Operation-Unit (OU) scheduling (paper §II-A, §IV-C).

Copied from ``repro/core/ou.py``: host numpy, so every number it
produces is bit-equal to the reference's.

Only ``ou_rows x ou_cols`` cells can be activated per cycle (ADC resolution
and cell-deviation limits), and in the pattern-pruned mapping every OU must
lie *inside* one pattern block: rows of different patterns correspond to
different selected inputs and cannot share a wordline activation.

The schedules below are vectorised: one numpy row per OU, not per-object —
VGG-scale layers produce 1e5+ OUs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.mapping import CrossbarConfig, LayerMapping, NaiveMapping

__all__ = ["OUSchedule", "pattern_ou_schedule", "naive_ou_schedule"]


@dataclasses.dataclass
class OUSchedule:
    """Per-OU arrays (all the same length).

    crossbar:   crossbar id the OU lives on
    wordlines:  active wordline count (== pattern size for pattern blocks)
    bitlines:   active bitline (cell) count, <= ou_cols
    channel:    input channel whose activations feed the OU (-1 if several)
    pattern:    pattern bitmask selecting the fed input positions
                (for the naive schedule: the full kernel mask)
    """

    crossbar: np.ndarray
    wordlines: np.ndarray
    bitlines: np.ndarray
    channel: np.ndarray
    pattern: np.ndarray

    def __len__(self) -> int:
        return int(self.crossbar.shape[0])

    @property
    def num_crossbars(self) -> int:
        return int(self.crossbar.max()) + 1 if len(self) else 0


def pattern_ou_schedule(mapping: LayerMapping) -> OUSchedule:
    """OUs of a pattern-pruned mapping: each placement tiles its columns
    into ou_cols-wide OUs; every OU stays inside its pattern block."""
    cfg = mapping.config
    xbars, wls, bls, chans, pats = [], [], [], [], []
    for p in mapping.placements:
        if p.height > cfg.ou_rows:
            # patterns are <= 9 nonzeros for 3x3 kernels; guard for generality
            raise ValueError("pattern block taller than an OU is unsupported")
        n_full, rem = divmod(p.width_cells, cfg.ou_cols)
        n = n_full + (1 if rem else 0)
        xbars.append(np.full(n, p.crossbar, dtype=np.int32))
        wls.append(np.full(n, p.height, dtype=np.int32))
        b = np.full(n, cfg.ou_cols, dtype=np.int32)
        if rem:
            b[-1] = rem
        bls.append(b)
        chans.append(np.full(n, p.block.channel, dtype=np.int32))
        pats.append(np.full(n, p.block.pattern, dtype=np.int64))
    if not xbars:
        z = np.zeros(0, dtype=np.int32)
        return OUSchedule(z, z, z, z, z.astype(np.int64))
    return OUSchedule(
        np.concatenate(xbars),
        np.concatenate(wls),
        np.concatenate(bls),
        np.concatenate(chans),
        np.concatenate(pats),
    )


def naive_ou_schedule(naive: NaiveMapping) -> OUSchedule:
    """OUs of the Fig-1 baseline.

    The dense (C_in*K) x (C_out*cells_per_weight) matrix is tiled over
    crossbars; inside each crossbar, OU row-bands are ``ou_rows`` tall.  For
    K == ou_rows (3x3 kernels, OU 9x8) bands align exactly with input
    channels, which is how we attribute the fed channel for the all-zero
    input skip check.  Bands that straddle a channel boundary get
    channel = -1 (never skippable — conservative, and rare).
    """
    cfg = naive.config
    k = naive.kernel_size
    full_mask = (1 << k) - 1

    rows_total, cols_total = naive.rows_total, naive.cols_total
    row_tiles = -(-rows_total // cfg.rows)
    col_tiles = -(-cols_total // cfg.cols)

    xbars, wls, bls, chans, pats = [], [], [], [], []
    xbar_id = 0
    for rt in range(row_tiles):
        r0 = rt * cfg.rows
        tile_rows = min(cfg.rows, rows_total - r0)
        # band boundaries inside this tile
        band_starts = np.arange(0, tile_rows, cfg.ou_rows)
        band_heights = np.minimum(cfg.ou_rows, tile_rows - band_starts)
        abs_starts = band_starts + r0
        # channel attribution: band fully inside channel c iff
        # floor(start/k) == floor((start+h-1)/k)
        c_lo = abs_starts // k
        c_hi = (abs_starts + band_heights - 1) // k
        band_chan = np.where(c_lo == c_hi, c_lo, -1).astype(np.int32)
        for ct in range(col_tiles):
            c0 = ct * cfg.cols
            tile_cols = min(cfg.cols, cols_total - c0)
            n_full, rem = divmod(tile_cols, cfg.ou_cols)
            ngroups = n_full + (1 if rem else 0)
            group_bl = np.full(ngroups, cfg.ou_cols, dtype=np.int32)
            if rem:
                group_bl[-1] = rem
            nb = band_heights.shape[0]
            xbars.append(np.full(nb * ngroups, xbar_id, dtype=np.int32))
            wls.append(np.repeat(band_heights.astype(np.int32), ngroups))
            bls.append(np.tile(group_bl, nb))
            chans.append(np.repeat(band_chan, ngroups))
            pats.append(np.full(nb * ngroups, full_mask, dtype=np.int64))
            xbar_id += 1
    return OUSchedule(
        np.concatenate(xbars),
        np.concatenate(wls),
        np.concatenate(bls),
        np.concatenate(chans),
        np.concatenate(pats),
    )
