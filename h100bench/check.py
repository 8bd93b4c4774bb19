"""The comparison that decides ``correct``.

Every request due in the window is compared, once the window has closed:

  * ``failed``: requests due that never got logits, or got logits that
    are not finite (limit 0);
  * ``max_logit_err``: over every served request, the largest gap
    between a served logit and the float64 reference's logit of the same
    image, as a share of ``max(1, the largest |reference logit| of that
    image)`` (limit: the configuration's ``limits.max_logit_err``, set
    from the program's and the control's readings, ``PERF.md``).

The reference computes each distinct image of the pool once.
"""

from __future__ import annotations

import numpy as np

__all__ = ["logit_errors", "compare"]


def logit_errors(served: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per request: ``max_j |served_j - ref_j| / max(1, max_j |ref_j|)``.
    ``served`` and ``ref`` are ``[N, classes]``."""
    served = np.asarray(served, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.maximum(1.0, np.abs(ref).max(axis=1))
    return np.abs(served - ref).max(axis=1) / scale


def compare(served: np.ndarray, image_idx: np.ndarray, ref: np.ndarray,
            missing: int, limit: float) -> dict:
    """``{"correct", "failed", "checks"}`` for the served logits
    ``[N, classes]`` of requests whose images are ``ref``'s rows
    ``image_idx``; ``missing`` requests were due and never served."""
    served = np.asarray(served, np.float64)
    finite = np.isfinite(served).all(axis=1)
    failed = int(missing + (~finite).sum())
    errs = logit_errors(served[finite], ref[np.asarray(image_idx)[finite]])
    worst = float(errs.max()) if errs.size else None
    checks = {
        "failed": {"value": failed, "limit": 0},
        "max_logit_err": {"value": worst, "limit": float(limit)},
    }
    correct = failed == 0 and worst is not None and worst <= limit
    return {"correct": bool(correct), "failed": failed, "checks": checks}
