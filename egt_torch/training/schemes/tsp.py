"""TSP edge-classification scheme (`lib/training/schemes/tsp/svd.py`).

Port of `egt_tpu/training/schemes/tsp.py`: dense node and edge inputs, the
unweighted sparse cross-entropy of the edge labels over the valid pairs
with the accuracy beside it (`egt_torch/schemes.py::xent_loss`), val_xent
monitored for save-best / RLR, length buckets 128 / 256 / 512, and the
evaluation of `tsp_eval.py`.
"""

from __future__ import annotations

from ...data import datasets as D
from . import tsp_eval
from .base import BaseSVDModelScheme


class TspSchemeMixin:
    DATASET_SPEC = D.TSP
    DATASET = "tsp"

    def do_evaluations_on_split(self, split):
        self.append_eval(split, tsp_eval.evaluate(self, split))


class TspSVD(TspSchemeMixin, BaseSVDModelScheme):
    pass


SCHEMES = {"svd": TspSVD}
