from repro_torch.data.synthetic import DATASETS, DatasetSpec, make_blobs, make_dataset

__all__ = ["DATASETS", "DatasetSpec", "make_blobs", "make_dataset"]
