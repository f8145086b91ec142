"""SBM-PATTERN node-classification schemes
(`lib/training/schemes/pattern/{svd,eig}.py`).

Port of `egt_tpu/training/schemes/pattern.py`: class-size-weighted sparse
cross-entropy over the valid nodes (`egt_torch/schemes.py::xent_loss`),
val_xent monitored for save-best / RLR, length buckets 128 / 192, and the
SBM evaluation of `sbm_eval.py`.
"""

from __future__ import annotations

from ...data import datasets as D
from . import sbm_eval
from .base import BaseEigModelScheme, BaseSVDModelScheme


class PatternSchemeMixin:
    DATASET_SPEC = D.SBM_PATTERN
    DATASET = "pattern"

    def do_evaluations_on_split(self, split):
        lines = sbm_eval.evaluate_pattern(self, split, self.config.class_sizes)
        self.append_eval(split, lines)


class PatternSVD(PatternSchemeMixin, BaseSVDModelScheme):
    pass


class PatternEig(PatternSchemeMixin, BaseEigModelScheme):
    pass


SCHEMES = {"svd": PatternSVD, "eig": PatternEig}
