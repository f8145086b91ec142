"""Serving: a run config and trained weights -> `fn(batch) -> predictions`,
eagerly or from an exported, self-contained artifact.

Port of `egt_tpu/serving.py`. The batch is the JAX model's batch dict of
numpy arrays: `node_features` (b, l) int tokens or (b, l, f) f32 dense
features (MNIST, CIFAR10, TSP), `feature_matrix` (b, l, l) int or (b, l,
l, f) f32 (edge inputs: ZINC, MNIST, CIFAR10, TSP; the SBM schemes have
none), `graph_matrix` (b, l, l) (the adjacency may be a narrow integer
type), and with a positional encoding `singular_vectors` (b, l, k, 2) or
`eigen_vectors` (b, l, k); -1 pads the features, 0 the PEs. The
predictions are the readout's alone: the distance head, whose output is a
training and evaluation metric, does not run here. A BatchNorm normalises
with its moving statistics, which travel with the weights. On a CUDA
device the layers run through the hand-written kernels (see
`models/layers.py`).

- `load_predictor(config, weights, device=None, mesh=None)` serves the
  eager model at any pad length l; with a `parallel.mesh.Mesh`, on every
  rank of the mesh with the edge rows split over its model group (edge
  partitioning, `parallel/edge_partition.py`).
- `export_predict` / `save_serving` trace the model's inference forward
  with `torch.export` (under `torch.no_grad`) into a program that holds
  the weights; its forward kernels K3, K1 and K8 stay in the graph as the
  custom ops of `ops/custom_ops.py`. `save_serving` writes it with
  `torch.export.save`, the request spec beside it; `load_serving(path)`
  reads it back and returns `fn(batch) -> f32 numpy`. Shapes are static,
  as in JAX (`batch_spec`: the first cached batch of the first split, at
  the pad length and the prediction batch, every key but `target`, each
  in its wire dtype); a request of another shape or dtype raises.
  Loading imports torch, numpy and `egt_torch.ops.custom_ops` (the three
  kernel modules), and nothing of the model, the schemes, the training or
  the config code: the counterpart of "loading needs jax but NOT this
  framework". Unlike JAX's StableHLO artifact, which runs on any backend,
  this one runs on the device it was exported on (the card unless the
  caller asked for the CPU).

Usage: `python -m egt_torch.export_serving <config> [output_path]`, or
`TrainingBase.export_serving()` / `load_serving(path)`.
"""

from __future__ import annotations

import collections
import itertools
import json
import os

import numpy as np
import torch

from . import tracing

SPEC_FILE = "egt_serving.json"      # the request spec inside the artifact


def load_model(config, weights, device=None):
    """The model of a run config (a dict or JSON path) with `weights` (a
    {JAX flat name: array} dict or a flat npz path) loaded, on `device`
    (CUDA unless the caller names a device; raises with no GPU)."""
    from .models.graph_model import EGTGraphModel
    from .schemes import model_config_from_config
    from .weights import load_flat_params, load_npz

    cfg = model_config_from_config(config)
    model = EGTGraphModel(cfg, device=device)
    if isinstance(weights, str):
        load_npz(model, weights)
    else:
        load_flat_params(model, weights)
    return model.eval()


def load_predictor(config, weights, device=None, mesh=None):
    """Returns `fn(batch) -> np.ndarray` of f32 predictions: (b,
    num_targets) for a graph readout (ZINC, MNIST, CIFAR10), (b, l,
    num_targets) for a node readout (PATTERN, CLUSTER), (b, l, l,
    num_targets) for an edge readout (TSP). Only the keys the model reads
    are taken from the batch. With `mesh`, every rank calls `fn` on the
    same request, on the mesh's device; each holds the request's edge rows
    of its shard and returns the whole prediction."""
    if mesh is None:
        model = load_model(config, weights, device)
    else:
        from .parallel.edge_partition import forward_shard
        model = load_model(config, weights, mesh.device)

    requests = itertools.count()

    def predict(batch: dict) -> np.ndarray:
        with tracing.span("predict", group=next(requests)):
            with torch.inference_mode(), tracing.span("forward"):
                b = {k: batch[k] for k in model.input_keys}
                out = (model(b) if mesh is None
                       else forward_shard(model, b, mesh))
            with tracing.span("readback"):
                return out.cpu().numpy()

    return predict


# ------------------------------------------------------------- exported artifact


def batch_spec(dataset, pad_len: int, batch_size: int) -> dict:
    """{key: (shape, numpy dtype name)} of one inference batch, from a
    dataset's first cached batch, every key but `target`."""
    b = next(dataset.batches(dataset.splits[0], batch_size, shuffle=False,
                             pad_len=pad_len))
    return {k: (tuple(v.shape), v.dtype.name) for k, v in b.items()
            if k != "target"}


class _Predict(torch.nn.Module):
    """The traced function: the model's inference forward on the batch
    keys it reads, in f32."""

    def __init__(self, model, keys):
        super().__init__()
        self.model = model
        self.keys = tuple(keys)

    def forward(self, batch):
        return self.model({k: batch[k] for k in self.keys}).float()


def _inputs(model, spec: dict) -> dict:
    missing = [k for k in model.input_keys if k not in spec]
    if missing:
        raise KeyError(f"the batch spec lacks {missing}")
    return {k: spec[k] for k in model.input_keys}


def export_predict(model, spec: dict) -> torch.export.ExportedProgram:
    """`model`'s inference forward on the spec's shapes, traced with
    `torch.export` with the weights in the program, on the model's
    device, without the graph's no-op nodes (`_strip_no_ops`)."""
    inputs = _inputs(model, spec)
    example = {k: torch.zeros(shape, dtype=_torch_dtype(dtype),
                              device=model.device)
               for k, (shape, dtype) in inputs.items()}
    with torch.no_grad():
        program = torch.export.export(_Predict(model, inputs), (example,),
                                      strict=False)
    return _strip_no_ops(program)


def _strip_no_ops(program):
    """Drop the nodes that compute nothing: the metadata assertions that
    `torch.export` records beside each `.to()`, and each `.to(dtype)` of a
    tensor of that dtype already (a no-op in the eager model). They are
    about half the graph's nodes, and a request's host time goes by the
    node."""
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
              and not node.kwargs
              and node.args[0].meta["val"].dtype == node.args[1]
              and all(u.op != "output" for u in node.users)):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    program.graph_module.recompile()
    return program


def save_serving(model, spec: dict, path: str) -> str:
    """Export `model` (see `export_predict`) and write the program to
    `path` with its request spec and device."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    program = export_predict(model, spec)
    meta = {"inputs": {k: [list(s), d] for k, (s, d)
                       in _inputs(model, spec).items()},
            "device": str(model.device)}
    torch.export.save(program, path, extra_files={SPEC_FILE: json.dumps(meta)})
    return path


def kernel_ops(program) -> dict:
    """{kernel: nodes} of the custom kernel ops (K3, K1, K8) in an exported
    program's graph."""
    from .ops.custom_ops import OPS

    counts = collections.Counter(str(n.target) for n in program.graph.nodes
                                 if n.op == "call_function")
    return {k: counts[op] for k, op in OPS.items()}


def load_serving(path: str):
    """Load a serving artifact; returns `fn(batch) -> predictions` (f32
    numpy). `fn` takes the batch dict (extra keys such as `target` are
    ignored) and raises on a key, shape or dtype other than the
    artifact's. `fn.program` is the loaded `ExportedProgram`."""
    from .ops import custom_ops  # noqa: F401 - registers the kernel ops

    extra = {SPEC_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[SPEC_FILE])
    inputs = {k: (tuple(s), d) for k, (s, d) in meta["inputs"].items()}
    device = torch.device(meta["device"])
    module = program.module()

    def fn(batch: dict) -> np.ndarray:
        feed = {}
        for k, (shape, dtype) in inputs.items():
            if k not in batch:
                raise KeyError(f"the request lacks {k!r}")
            arr = np.asarray(batch[k])
            if arr.shape != shape or arr.dtype.name != dtype:
                raise ValueError(
                    f"{k}: the artifact takes {shape} {dtype}, the request "
                    f"has {arr.shape} {arr.dtype.name}")
            feed[k] = torch.from_numpy(arr).to(device)
        with torch.no_grad():
            out = module(feed)
        return out.float().cpu().numpy()

    fn.program = program
    return fn


def _torch_dtype(name: str) -> torch.dtype:
    return torch.from_numpy(np.zeros((), np.dtype(name))).dtype
