"""PCQM4Mv2 (OGB-LSC) HOMO-LUMO-gap regression schemes.

Port of `egt_tpu/training/schemes/pcqm4mv2.py`: the multi-column OGB atom
and bond tokens, the virtual-node readout and the degree scaler (the
`pcqm4mv2` binding of `egt_torch/schemes.py`: MAE loss, val_mae monitored),
on the BaseAdj chain with no PE (`.base`, the EGT-Large recipe) or the SVD
one (`.svd`); the MAE evaluation lines are ZINC's.
"""

from __future__ import annotations

from ...data import datasets as D
from .base import BaseAdjModelScheme, BaseSVDModelScheme
from .zinc import ZincEvalMixin


class Pcqm4mv2Mixin(ZincEvalMixin):
    DATASET_SPEC = D.PCQM4MV2
    DATASET = "pcqm4mv2"


class Pcqm4mv2Base(Pcqm4mv2Mixin, BaseAdjModelScheme):
    pass


class Pcqm4mv2SVD(Pcqm4mv2Mixin, BaseSVDModelScheme):
    pass


SCHEMES = {"base": Pcqm4mv2Base, "svd": Pcqm4mv2SVD}
