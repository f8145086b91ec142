"""ZINC-full schemes (`lib/training/schemes/zinc_full/{svd,eig}.py`).

Port of `egt_tpu/training/schemes/zinc_full.py`: ZINC's schemes bound to
the full dataset (`D.ZINC_FULL`, the `zinc_full` binding of
`egt_torch/schemes.py`); the MAE evaluation lines are ZINC's.
"""

from __future__ import annotations

from ...data import datasets as D
from .base import BaseEigModelScheme, BaseSVDModelScheme
from .zinc import ZincSchemeMixin


class ZincFullSchemeMixin(ZincSchemeMixin):
    DATASET_SPEC = D.ZINC_FULL
    DATASET = "zinc_full"


class ZincFullSVD(ZincFullSchemeMixin, BaseSVDModelScheme):
    pass


class ZincFullEig(ZincFullSchemeMixin, BaseEigModelScheme):
    pass


SCHEMES = {"svd": ZincFullSVD, "eig": ZincFullEig}
