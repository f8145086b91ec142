"""SBM-CLUSTER node-classification schemes
(`lib/training/schemes/cluster/{svd,eig}.py`).

Port of `egt_tpu/training/schemes/cluster.py`: the PATTERN loss over 6
classes with CLUSTER's class sizes, and the SBM evaluation without the log
loss.
"""

from __future__ import annotations

from ...data import datasets as D
from . import sbm_eval
from .base import BaseEigModelScheme, BaseSVDModelScheme


class ClusterSchemeMixin:
    DATASET_SPEC = D.SBM_CLUSTER
    DATASET = "cluster"

    def do_evaluations_on_split(self, split):
        self.append_eval(split, sbm_eval.evaluate_cluster(self, split))


class ClusterSVD(ClusterSchemeMixin, BaseSVDModelScheme):
    pass


class ClusterEig(ClusterSchemeMixin, BaseEigModelScheme):
    pass


SCHEMES = {"svd": ClusterSVD, "eig": ClusterEig}
