from .datasets import (MNIST, FashionMNIST, CIFAR10,  # noqa: F401
                       SyntheticImageDataset, ImageFolderDataset,
                       ImageRecordDataset)
from . import transforms  # noqa: F401
