"""ZINC molecular-regression schemes (`lib/training/schemes/zinc/{svd,eig}.py`).

Port of `egt_tpu/training/schemes/zinc.py`: MAE loss on the graph-level
target (`egt_torch/schemes.py::loss_and_metrics`), val_mae monitored for
save-best / RLR.
"""

from __future__ import annotations

from ... import schemes
from ...data import datasets as D
from ...utils.hparams import HParams
from .base import BaseEigModelScheme, BaseSVDModelScheme


class ZincEvalMixin:
    def do_evaluations_on_split(self, split):
        res = self.evaluate_split(split)
        mae = res.get("mae", res["loss"])
        self.append_eval(split, [f"{split} MAE = {mae:0.5f}"])


class ZincSchemeMixin(ZincEvalMixin):
    DATASET_SPEC = D.ZINC

    def get_default_config(self) -> HParams:
        c = super().get_default_config()
        c.update(schemes.ZINC_DEFAULTS)
        return c


class ZincSVD(ZincSchemeMixin, BaseSVDModelScheme):
    pass


class ZincEig(ZincSchemeMixin, BaseEigModelScheme):
    pass


SCHEMES = {"svd": ZincSVD, "eig": ZincEig}
