"""Token data pipeline: synthetic corpus, document packing, sharded batches.

Port of ``src/repro/data/pipeline.py``.  The sources and the packing are
host numpy, copied, so a batch here is the reference's bit for bit for
the same config and source:

  * SyntheticCorpus — a seeded random bigram LM.  Deterministic, infinite,
    and *learnable* (a model that trains should drive loss toward the
    bigram entropy), which is what convergence tests assert.
  * TokenFileDataset — memory-mapped ``.bin`` token files (uint16/uint32)
    with EOS-delimited documents, shuffled document order, and greedy
    packing into fixed-length sequences — the standard production layout.

``shard_batch`` keeps this rank's rows of a host batch over the
``('pod', 'data')`` dims of a ``DeviceMesh`` (SPMD, as
``parallel/sharding.shard_block_pattern`` keeps its tile slab), as
tensors on the rank's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np
import torch

from repro_torch.launch.mesh import mesh_device
from repro_torch.parallel.sharding import mesh_axis_sizes

__all__ = ["DataConfig", "SyntheticCorpus", "TokenFileDataset", "packed_batches",
           "shard_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0


class SyntheticCorpus:
    """Seeded bigram language model over ``vocab`` tokens.  The transition
    matrix is ``vocab``² float64: 8.2 GB at 32,000."""

    def __init__(self, vocab: int, seed: int = 0, concentration: float = 0.3):
        rng = np.random.default_rng(seed)
        logits = rng.gumbel(size=(vocab, vocab)) / concentration
        self.probs = np.exp(logits - logits.max(-1, keepdims=True))
        self.probs /= self.probs.sum(-1, keepdims=True)
        self.vocab = vocab

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        tok = int(rng.integers(self.vocab))
        for i in range(length):
            tok = int(rng.choice(self.vocab, p=self.probs[tok]))
            out[i] = tok
        return out

    def bigram_entropy(self) -> float:
        p = self.probs
        return float(-(p * np.log(p + 1e-12)).sum(-1).mean())


class TokenFileDataset:
    """Memmapped token file with EOS-delimited documents."""

    def __init__(self, path: str, dtype=np.uint16, eos_id: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.eos_id = eos_id

    def __len__(self) -> int:
        return len(self.tokens)

    def documents(self, seed: int = 0) -> Iterator[np.ndarray]:
        """Yield documents in shuffled boundary order."""
        bounds = np.flatnonzero(self.tokens == self.eos_id)
        starts = np.concatenate([[0], bounds + 1])
        ends = np.concatenate([bounds + 1, [len(self.tokens)]])
        order = np.random.default_rng(seed).permutation(len(starts))
        for i in order:
            doc = np.asarray(self.tokens[starts[i] : ends[i]], np.int32)
            if doc.size:
                yield doc


def packed_batches(
    cfg: DataConfig,
    source: SyntheticCorpus | TokenFileDataset | None = None,
) -> Iterator[dict]:
    """Yield {'tokens': [B, S+1]} batches (inputs=[:, :-1],
    labels=[:, 1:]).

    Documents are greedily packed back-to-back (separated by EOS) into
    S+1-length rows — no padding waste, the production default.
    """
    source = source or SyntheticCorpus(cfg.vocab, cfg.seed)
    rng = np.random.default_rng(cfg.seed + 1)
    row_len = cfg.seq_len + 1
    buf = np.empty(0, np.int32)

    if isinstance(source, SyntheticCorpus):
        def doc_iter():
            while True:
                yield source.sample(rng, int(rng.integers(64, 512)))
        docs = doc_iter()
    else:
        def doc_iter():
            epoch = 0
            while True:
                yield from source.documents(seed=cfg.seed + epoch)
                epoch += 1
        docs = doc_iter()

    while True:
        rows = []
        for _ in range(cfg.global_batch):
            while buf.size < row_len:
                doc = next(docs)
                buf = np.concatenate([buf, doc, [cfg.eos_id]])
            rows.append(buf[:row_len])
            buf = buf[row_len:]
        yield {"tokens": np.stack(rows)}


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of every array of ``batch``, as tensors on the
    rank's device (``launch.mesh.mesh_device``).

    The rows split evenly over the mesh's ``pod`` and ``data`` dims,
    pod-major (the reference's ``P(('pod', 'data'))``): the rank at row
    block ``r`` of ``n`` keeps rows ``[r * B / n, (r + 1) * B / n)``.  A
    batch whose rows do not divide raises, as placing it under the
    reference's sharding does."""
    sizes = mesh_axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    n = math.prod(sizes[a] for a in axes)
    r = 0
    for a in axes:
        r = r * sizes[a] + mesh.get_local_rank(a)
    dev = mesh_device(mesh)
    out = {}
    for k, v in batch.items():
        rows = np.shape(v)[0]
        if rows % n:
            raise ValueError(f"batch {k!r}: {rows} rows do not split over "
                             f"{n} data ranks")
        per = rows // n
        out[k] = torch.as_tensor(np.asarray(v[r * per:(r + 1) * per]),
                                 device=dev)
    return out
