"""Token data: synthetic corpus, token files, packing, sharded batches."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    SyntheticCorpus,
    TokenFileDataset,
    packed_batches,
    shard_batch,
)
