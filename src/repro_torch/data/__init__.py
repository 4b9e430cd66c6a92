from repro_torch.data.synthetic import DATASETS, DatasetSpec, make_blobs, make_dataset
from repro_torch.data.loader import ShardedLoader, lm_token_batches

__all__ = [
    "DATASETS",
    "DatasetSpec",
    "make_blobs",
    "make_dataset",
    "ShardedLoader",
    "lm_token_batches",
]
