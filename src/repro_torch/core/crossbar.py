"""RRAM crossbar area/energy model (paper Table I, §V-A).

Copied from ``repro/core/crossbar.py``: host numpy, so every number it
produces is bit-equal to the reference's.

Energy accounting follows the paper: RRAM-related components (crossbar
array, ADCs, DACs) dominate (>80% of chip energy per ISAAC), so only those
are priced.  Per OU activation:

  E_ou = E_array + n_active_bitlines * E_adc + n_active_wordlines * E_dac

with Table I constants: ADC 8b @ 1.67 pJ/op, DAC 4b @ 0.0182 pJ/op, array
4.8 pJ per OU op, OU size 9x8 (9 wordlines x 8 bitlines), 4-bit cells,
512x512 crossbars.  16-bit weights occupy 4 adjacent cells (bit slicing), so
8 bitlines cover 2 weight columns.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.mapping import CrossbarConfig

__all__ = ["EnergyModel", "ou_energy", "CrossbarConfig"]


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-op energies in pJ (paper Table I)."""

    adc_pj: float = 1.67  # per bitline conversion
    dac_pj: float = 0.0182  # per wordline drive
    array_pj_per_ou: float = 4.8  # per OU activation

    def ou_energy(
        self, wordlines: np.ndarray | int, bitlines: np.ndarray | int
    ) -> np.ndarray:
        """Energy (pJ) of OU activations with the given active line counts."""
        wl = np.asarray(wordlines, dtype=np.float64)
        bl = np.asarray(bitlines, dtype=np.float64)
        return self.array_pj_per_ou + bl * self.adc_pj + wl * self.dac_pj

    def breakdown(
        self,
        wordlines: np.ndarray,
        bitlines: np.ndarray,
        counts: np.ndarray | None = None,
    ) -> dict[str, float]:
        """Component-wise energy (pJ) summed over OU activations.

        ``counts`` weights each entry (e.g. windows per OU position, or the
        expected non-skipped activation count).
        """
        wl = np.asarray(wordlines, dtype=np.float64)
        bl = np.asarray(bitlines, dtype=np.float64)
        n = np.ones_like(wl) if counts is None else np.asarray(counts, np.float64)
        return {
            "array_pj": float((self.array_pj_per_ou * n).sum()),
            "adc_pj": float((bl * self.adc_pj * n).sum()),
            "dac_pj": float((wl * self.dac_pj * n).sum()),
        }


def ou_energy(
    wordlines: np.ndarray | int,
    bitlines: np.ndarray | int,
    model: EnergyModel = EnergyModel(),
) -> np.ndarray:
    return model.ou_energy(wordlines, bitlines)
