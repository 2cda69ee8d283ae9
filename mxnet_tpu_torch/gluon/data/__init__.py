"""``gluon.data`` (counterpart of ``mxnet_tpu/gluon/data``; ref:
python/mxnet/gluon/data): datasets, samplers, the DataLoader, the
device prefetcher, and ``vision`` (the vision datasets and transforms)."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,  # noqa: F401
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,  # noqa: F401
                      BatchSampler, FilterSampler)
from .dataloader import DataLoader  # noqa: F401
from .prefetcher import DevicePrefetcher  # noqa: F401
from . import vision  # noqa: F401
