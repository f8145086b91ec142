"""Edge-partitioned (sequence-parallel) execution of the model.

Port of `egt_tpu/parallel/edge_partition.py`: the N x N attention grid and
the edge channel are split by query rows over the mesh's model group. Each
rank holds its rows of graph_matrix / feature_matrix and every other field
whole; the node stream is whole on every rank; the attention runs K1 / K2
on the rank's row block against every key (`models/layers.py`), the hop
stack and the diffusion gather rows hop by hop, and graph pooling psums
partial sums (`models/features.py`, `models/graph_model.py`). The memory of
the (b, l, l, *) tensors a rank holds falls by the shard count.

JAX's `shard_map` assembles the logical output from `output_spec`; here
`forward_shard` gathers a node or an edge readout along rows, and returns a
graph readout as it is (every rank computed it whole). With a data group of
more than one rank the batch is one of its graph shards (DP x SP).
"""

from __future__ import annotations

from ..models.layers import SPContext
from . import collectives as C
from .mesh import Mesh, batch_shard

# batch fields whose second axis is the (sharded) query-node row axis
ROW_SHARDED = ("graph_matrix", "feature_matrix")


def sp_context(mesh: Mesh, length: int, num_virtual_nodes: int = 0):
    """The `SPContext` of this rank for graphs of `length` nodes (None when
    the model group is one rank)."""
    size = mesh.model.size
    if size == 1:
        return None
    if length % size:
        raise ValueError(f"pad length {length} must divide by "
                         f"edge_partition={size}")
    return SPContext(group=mesh.model, size=size, index=mesh.model.index,
                     lq=length // size, vn=num_virtual_nodes,
                     stats=mesh.world)


def shard_rows(batch: dict, sp) -> dict:
    """The batch with graph_matrix / feature_matrix cut to this shard's
    rows (`batch_specs` in JAX)."""
    if sp is None:
        return batch
    return {k: (v[:, sp.index * sp.lq:(sp.index + 1) * sp.lq]
                if k in ROW_SHARDED else v) for k, v in batch.items()}


def gather_output(out, sp, readout_kind: str):
    """The logical output from a shard's: node and edge readouts gathered
    along rows, a graph readout as it is (`output_spec` in JAX)."""
    if sp is None or readout_kind == "graph":
        return out
    return C.all_gather_rows(out, sp.group, dim=1)


def forward_shard(model, batch: dict, mesh: Mesh, training: bool = False,
                  seeds=None, pe_seed=None, with_context: bool = False):
    """The model's forward on this rank's data shard `batch` with its edge
    rows: the output of the whole data shard (and the context with
    `with_context`). The BatchNorm statistics are the global batch's."""
    length = batch["graph_matrix"].shape[1]
    sp = sp_context(mesh, length, model.cfg.num_virtual_nodes)
    data = mesh.data if mesh.data.size > 1 else None
    res = model(shard_rows(batch, sp), training=training, seeds=seeds,
                pe_seed=pe_seed, with_context=with_context, sp=sp,
                data=data)
    out, ctx = res if with_context else (res, None)
    out = gather_output(out, sp, model.cfg.readout_kind)
    return (out, ctx) if with_context else out


def edge_partitioned_forward(model, batch: dict, mesh: Mesh,
                             training: bool = False, seeds=None,
                             pe_seed=None):
    """JAX's `edge_partitioned_forward`: `batch` is the global batch; each
    rank runs its data shard's graphs (DP x SP when the data group has more
    than one rank) on its edge rows, and gets back its data shard's
    logical output."""
    return forward_shard(model, batch_shard(batch, mesh), mesh,
                         training=training, seeds=seeds, pe_seed=pe_seed)
