"""Losses and streaming metrics.

Port of `egt_tpu/training/metrics.py`: every loss takes an optional `mask`
(what Keras would feed invisibly) and an optional per-graph `sample_mask`
(the padded final batch) and returns a (weighted sum, weight total) pair,
so a caller can take the mean or accumulate it across batches.

Class-imbalance weighting matches the reference's `WeightedSparseXEntropyLoss`:
weight_c = (sum(sizes) - size_c) / sum(weights).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import all_reduce_


def class_weights_from_sizes(class_sizes) -> np.ndarray:
    sizes = np.asarray(class_sizes, dtype="float32")
    w = sizes.sum() - sizes
    return w / w.sum()


def _weights(values, mask, sample_mask):
    w = torch.ones_like(values)
    if sample_mask is not None:
        w = w * torch.as_tensor(sample_mask, device=values.device).to(
            values.dtype).reshape((-1,) + (1,) * (values.ndim - 1))
    if mask is not None:
        w = w * torch.as_tensor(mask, device=values.device).to(values.dtype)
    return w


def _weighted_mean(values, weights):
    """(weighted sum, weight total) for streaming aggregation."""
    return torch.sum(values * weights), torch.sum(weights)


def mae_loss(pred, target, mask=None, sample_mask=None):
    err = torch.abs(pred - target)
    return _weighted_mean(err, _weights(err, mask, sample_mask))


def sparse_xent_logits(pred, target):
    """Element-wise sparse categorical cross-entropy from logits; targets
    out of range are clamped to it (`mode="clip"` in JAX)."""
    logp = torch.log_softmax(pred, dim=-1)
    idx = torch.clamp(target.long(), 0, pred.shape[-1] - 1)
    return -torch.gather(logp, -1, idx[..., None])[..., 0]


def sparse_xent_loss(pred, target, mask=None, sample_mask=None,
                     class_weights=None):
    elem = sparse_xent_logits(pred, target)
    w = _weights(elem, mask, sample_mask)
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=elem.dtype,
                             device=elem.device)
        elem = elem * cw[target.long()]
    return _weighted_mean(elem, w)


def accuracy(pred, target, mask=None, sample_mask=None):
    correct = (torch.argmax(pred, dim=-1) == target).float()
    return _weighted_mean(correct, _weights(correct, mask, sample_mask))


class MetricAccumulator:
    """Host-side streaming (sum, count) accumulator for per-batch metric
    pairs."""

    def __init__(self):
        self._sums: dict[str, float] = {}
        self._counts: dict[str, float] = {}

    def update(self, pairs: dict):
        for name, (s, c) in pairs.items():
            self._sums[name] = self._sums.get(name, 0.0) + float(s)
            self._counts[name] = self._counts.get(name, 0.0) + float(c)

    def result(self) -> dict:
        return {
            k: (self._sums[k] / self._counts[k]) if self._counts[k] > 0 else 0.0
            for k in self._sums
        }

    def reset(self):
        self._sums.clear()
        self._counts.clear()


class DeviceAccumulator:
    """(sum, count) pairs of a run of steps, summed where they are computed
    and read once: the counterpart of the JAX engine's on-device accumulator
    (`egt_tpu/training/trainer.py:417-422`), so that a step reads no value
    back from the card. The sums are kept in f64. With a `group`
    (`parallel.collectives.Group`) of several ranks, each rank adds its
    shard's pairs and the read sums them over the group first."""

    def __init__(self, group=None):
        self.group = group
        self._names: tuple | None = None
        self._acc = None

    def add(self, pairs: dict) -> None:
        """pairs: {name: (sum, count)} of 0-d tensors on one device."""
        names = tuple(pairs)
        v = torch.stack([torch.stack((s.detach(), c.detach()))
                         for s, c in pairs.values()]).to(torch.float64)
        if self._acc is None:
            self._names, self._acc = names, v
        elif names != self._names:
            raise ValueError(f"metric names changed: {names} vs {self._names}")
        else:
            self._acc += v

    def result(self) -> dict:
        """{name: sum / count}; the one read of the device values."""
        if self._acc is None:
            return {}
        v = self._acc
        if self.group is not None and self.group.size > 1:
            v = all_reduce_(v.clone(), self.group)
        acc = MetricAccumulator()
        acc.update(dict(zip(self._names, v.cpu().tolist())))
        return acc.result()
