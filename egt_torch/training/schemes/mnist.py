"""MNIST superpixel graph-classification scheme
(`lib/training/schemes/mnist/svd.py`).

Port of `egt_tpu/training/schemes/mnist.py`: dense node and edge inputs,
the sparse cross-entropy of the graph's class with the accuracy beside it
(`egt_torch/schemes.py::xent_loss`), val_xent monitored for save-best
/ RLR, and the evaluation lines of the JAX module.
"""

from __future__ import annotations

from ...data import datasets as D
from .base import BaseSVDModelScheme


class MnistSchemeMixin:
    DATASET_SPEC = D.MNIST
    DATASET = "mnist"

    def do_evaluations_on_split(self, split):
        res = self.evaluate_split(split)
        self.append_eval(split, [
            f"{split} accuracy = {res['acc']:0.5%}",
            f"{split} crossentropy = {res['xent']:0.6f}",
        ])


class MnistSVD(MnistSchemeMixin, BaseSVDModelScheme):
    pass


SCHEMES = {"svd": MnistSVD}
