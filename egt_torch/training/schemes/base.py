"""Scheme base classes: the task-binding layer.

Port of `egt_tpu/training/schemes/base.py` (the reference's
`lib/training/schemes/scheme_base.py`): the model-hyperparameter config
surface of BaseDC -> BaseAdj -> BaseSVD | BaseEig, and the dataset with the
positional-encoding preprocessing the config asks for. The default tables
are those of `egt_torch/schemes.py`, the one copy. The model and the loss of
a run come from the same module's ZINC binding, through `steps.Trainer`.
"""

from __future__ import annotations

from ... import schemes
from ...data.dataset import DatasetSpec, GraphDataset
from ...utils.hparams import HParams
from ..trainer import TrainingBase


class BaseDCModelScheme(TrainingBase):
    DATASET_SPEC: DatasetSpec = None  # set by concrete schemes
    PE: str = None                    # "svd" | "eig"

    def get_default_config(self) -> HParams:
        return schemes.scheme_defaults(self.PE)

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


class BaseSVDModelScheme(BaseDCModelScheme):
    PE = "svd"


class BaseEigModelScheme(BaseDCModelScheme):
    PE = "eig"
