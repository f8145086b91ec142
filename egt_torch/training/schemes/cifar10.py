"""CIFAR10 superpixel graph-classification scheme
(`lib/training/schemes/cifar10/svd.py`).

Port of `egt_tpu/training/schemes/cifar10.py`: MNIST's scheme with 5-dim
node features and the `num_virtual_nodes` key (0 by default).
"""

from __future__ import annotations

from ...data import datasets as D
from .base import BaseSVDModelScheme
from .mnist import MnistSchemeMixin


class Cifar10SchemeMixin(MnistSchemeMixin):
    DATASET_SPEC = D.CIFAR10
    DATASET = "cifar10"


class Cifar10SVD(Cifar10SchemeMixin, BaseSVDModelScheme):
    pass


SCHEMES = {"svd": Cifar10SVD}
