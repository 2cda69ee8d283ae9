"""``gluon.data.vision`` (counterpart of ``mxnet_tpu/gluon/data/vision``):
the vision datasets and the per-sample transforms."""
from . import transforms  # noqa: F401
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,  # noqa: F401
                       ImageFolderDataset, ImageListDataset,
                       ImageRecordDataset)
