"""Carry JAX parameters into the port.

The flat names are those of `egt_tpu/training/checkpoint.py::_flatten_params`
(for example `stack/layers/0/dense_qkv/kernel`), which the JAX package's
`saved/*.npz` weight snapshots use. The port's parameters carry the same
names with `.` for `/`, and Dense kernels keep the JAX (in, out) layout, so
the transfer is a strict name-for-name copy. Raw arrays of the params tree
keep their top-level names (`virtual_node_embeddings` (k, w),
`virtual_edge_embeddings` (k, ew)), a multi-column token table its one
offset-concatenated array (`node_emb/table`: every column's rows end to
end after the mask row), and a BatchNorm its moving statistics beside
gamma and beta (`stack/layers/0/norm_mha/moving_mean`, `.../moving_var`:
parameters that no gradient reaches).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flat_names(model: nn.Module) -> dict[str, torch.nn.Parameter]:
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def flat_arrays(model: nn.Module) -> dict[str, np.ndarray]:
    """{JAX flat name: f32 array} of the model's current parameters."""
    return {k: p.detach().float().cpu().numpy()
            for k, p in flat_names(model).items()}


def load_flat_params(model: nn.Module, flat: dict) -> nn.Module:
    """Copy `flat` ({JAX flat name: array}) into `model`. Every name and
    shape must match, both ways."""
    params = flat_names(model)
    missing = sorted(set(params) - set(flat))
    unexpected = sorted(set(flat) - set(params))
    if missing or unexpected:
        raise KeyError(f"weight names differ: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    for name, p in params.items():
        arr = np.asarray(flat[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.asarray(flat[name], np.float32)))
    return model


def load_npz(model: nn.Module, path: str) -> nn.Module:
    """Load a flat-npz weight snapshot written by the JAX package's
    `checkpoint.save_weights`."""
    with np.load(path) as data:
        return load_flat_params(model, {k: data[k] for k in data.files})
