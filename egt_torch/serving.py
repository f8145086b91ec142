"""Serving: a run config and trained weights -> `fn(batch) -> predictions`.

Port of `egt_tpu/serving.py::load_serving` for the eager PyTorch model. The
batch is the JAX model's batch dict of numpy arrays at any pad length l:
`node_features` (b, l) int tokens or (b, l, f) f32 dense features (MNIST,
CIFAR10, TSP), `feature_matrix` (b, l, l) int or (b, l, l, f) f32 (edge
inputs: ZINC, MNIST, CIFAR10, TSP; the SBM schemes have none),
`graph_matrix` (b, l, l) (the adjacency may be a narrow integer type), and
with a positional encoding `singular_vectors` (b, l, k, 2) or
`eigen_vectors` (b, l, k); -1 pads the features, 0 the PEs. The
predictions are the readout's alone: the distance head, whose output is a
training and evaluation metric, does not run here. On a CUDA device the
layers run through the hand-written kernels (see `models/layers.py`). An
exported, self-contained artifact (the JAX StableHLO export) has no
counterpart yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.graph_model import EGTGraphModel
from .schemes import model_config_from_config
from .weights import load_flat_params, load_npz


def load_model(config, weights, device=None) -> EGTGraphModel:
    """The model of a run config (a dict or JSON path) with `weights` (a
    {JAX flat name: array} dict or a flat npz path) loaded, on `device`
    (CUDA unless the caller names a device; raises with no GPU)."""
    cfg = model_config_from_config(config)
    model = EGTGraphModel(cfg, device=device)
    if isinstance(weights, str):
        load_npz(model, weights)
    else:
        load_flat_params(model, weights)
    return model.eval()


def load_predictor(config, weights, device=None):
    """Returns `fn(batch) -> np.ndarray` of f32 predictions: (b,
    num_targets) for a graph readout (ZINC, MNIST, CIFAR10), (b, l,
    num_targets) for a node readout (PATTERN, CLUSTER), (b, l, l,
    num_targets) for an edge readout (TSP). Only the keys the model reads
    are taken from the batch."""
    model = load_model(config, weights, device)

    def predict(batch: dict) -> np.ndarray:
        with torch.inference_mode():
            out = model({k: batch[k] for k in model.input_keys})
        return out.cpu().numpy()

    return predict
