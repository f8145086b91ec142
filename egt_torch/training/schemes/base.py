"""Scheme base classes: the task-binding layer.

Port of `egt_tpu/training/schemes/base.py` (the reference's
`lib/training/schemes/scheme_base.py`): the model-hyperparameter config
surface of BaseDC -> BaseAdj (no PE) -> BaseSVD | BaseEig, and the dataset
with the positional-encoding preprocessing the config asks for. The default
tables are those of `egt_torch/schemes.py`, the one copy, with the dataset
binding a concrete scheme names in `DATASET`. The model and the loss of a run
come from the same binding, through `steps.Trainer`.
"""

from __future__ import annotations

from ... import schemes
from ...data.dataset import DatasetSpec, GraphDataset
from ...utils.hparams import HParams
from ..trainer import TrainingBase


class BaseDCModelScheme(TrainingBase):
    DATASET_SPEC: DatasetSpec = None  # set by concrete schemes
    DATASET: str = None               # key of `schemes.DATASETS`
    PE: str = None                    # "base" | "svd" | "eig"

    def get_default_config(self) -> HParams:
        return schemes.dataset_defaults(self.DATASET, self.PE)

    def dataset_kwargs(self) -> dict:
        c = self.config
        kw = dict(dataset_path=c.dataset_path, cache_dir=c.cache_dir)
        if self.PE == "svd" and c.use_svd:
            kw.update(pe="svd", num_features=c.num_svd_features)
        elif self.PE == "eig" and c.use_eig:
            kw.update(pe="eig", num_features=c.num_eig_features)
        return kw

    def get_dataset(self, splits):
        return GraphDataset(self.DATASET_SPEC, splits=splits,
                            **self.dataset_kwargs())


class BaseAdjModelScheme(BaseDCModelScheme):
    PE = "base"


class BaseSVDModelScheme(BaseDCModelScheme):
    PE = "svd"


class BaseEigModelScheme(BaseDCModelScheme):
    PE = "eig"
