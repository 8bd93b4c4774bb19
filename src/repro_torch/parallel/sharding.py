"""The padding helpers of the reference's ``parallel/sharding.py``.

The port runs on one device, so only the arithmetic that fixes the
models' shapes is copied: the padded vocabulary and the padded query
head count.  Sharding itself is Queue 1 item 10 of ``ROADMAP.md``.
"""

from __future__ import annotations

__all__ = ["pad_to_multiple", "padded_heads"]


def pad_to_multiple(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def padded_heads(n_heads: int, shards: int = 16) -> int:
    """Head count padded so the head axis shards (MaxText-style padding).

    Padded heads carry zero weights in the in/out projections, so they are
    numerically inert.
    """
    return pad_to_multiple(n_heads, shards)
