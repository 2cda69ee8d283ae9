"""``gluon.data`` (counterpart of ``mxnet_tpu/gluon/data``; ref:
python/mxnet/gluon/data): datasets, samplers, the DataLoader and the
device prefetcher. The vision datasets and transforms are ``ROADMAP.md``
A.15's image half."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,  # noqa: F401
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,  # noqa: F401
                      BatchSampler, FilterSampler)
from .dataloader import DataLoader  # noqa: F401
from .prefetcher import DevicePrefetcher  # noqa: F401
