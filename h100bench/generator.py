"""The one traffic generator: every mix is a data file that it reads.

A mix (``traffic/<mix>.json``) holds:

  * ``arrivals``: ``"backlog"``, an offline job that keeps at least
    ``backlog_batches`` x ``batch_slots`` requests queued for the whole
    window, or ``"open"``, independent users arriving on a schedule at
    ``rate_per_s`` whatever the service does;
  * for ``"open"``: ``gap_cv``, the coefficient of variation of the gaps
    between arrivals (gamma-distributed; 1 is a Poisson process, above 1
    bursty), and ``gap_seed``;
  * ``image_pool_batches``: requests draw their images from a pool of
    that many batches of distinct seeded images.

A traced run profiles the last ``PROFILE_STEPS`` steps of the window.

Every run of a mix offers the same work: an open mix's arrival times are
one schedule drawn from ``gap_seed`` (``rate_per_s x seconds`` requests,
the same on every seed, as a recorded trace is replayed), and the run's
seed draws the images and the order in which requests take them.
"""

from __future__ import annotations

import numpy as np

PROFILE_STEPS = 50

__all__ = ["PROFILE_STEPS", "sub_seed", "pool_size", "image_pool",
           "image_indices", "arrival_offsets"]


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(tag)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def pool_size(traffic: dict, batch_slots: int) -> int:
    return int(traffic["image_pool_batches"]) * int(batch_slots)


def image_pool(n: int, shape: tuple[int, int, int], seed: int, device):
    """``n`` standard-normal float32 images ``[n, C, H, W]`` drawn on
    ``device`` in one call."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((n, *shape), generator=gen, device=device,
                       dtype=torch.float32)


def image_indices(pool: int, seed: int, chunk: int = 4096):
    """Endless pool indices, one a request, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    while True:
        yield from rng.integers(0, pool, size=chunk).tolist()


def arrival_offsets(traffic: dict, seconds: float) -> np.ndarray:
    """Due times in seconds after the window opens, ``round(rate *
    seconds)`` of them, the last at ``seconds``: gamma gaps (mean
    ``1/rate``, CV ``gap_cv``) drawn from the mix's ``gap_seed`` and
    scaled to fill the window exactly."""
    rate = float(traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    cv = float(traffic.get("gap_cv", 1.0))
    shape = 1.0 / (cv * cv)
    gaps = np.random.default_rng(int(traffic.get("gap_seed", 0))).gamma(
        shape, 1.0 / (rate * shape), size=n)
    t = np.cumsum(gaps)
    return t * (seconds / t[-1])
