"""EGTGraphModel: config + `nn.Module` with the forward pass.

Port of `egt_tpu/models/graph_model.py` (one device, or one shard of a
parallel run: `forward(..., sp=, data=, tp=)`, driven by
`egt_torch/parallel/`): token (one column,
or the multi-column OGB atom features) or dense (Keras-masked) node
embeddings, the SVD or eigenvector positional encoding added to them (with
its training-time sign flips) and the one-hot degree encoding; the edge
channel from token (one column or several) or dense edge embeddings plus
the adjacency-hop embedding (with `include_xpose` the transposed hops
beside the hops), the pairwise sum of the node2edge embedding and the
diffusion of the edge features (or, with `edge_input_kind="none"`, from
the hop embedding alone; built only when something reads it); the learned
virtual nodes (rows prepended to h, row / column / box blocks to e, the
node mask and a hard mask extended); the layer stack of any of the four
edge channels with LayerNorm or BatchNorm, FFN cross-talk and any `jax.nn`
activation (with the training draws and dropout when `training`), each
layer recomputed in the backward under `remat` (True: all of it; "dots":
all but the plain matrix products); the final norms, the distance
objective's head on the edge channel, and the graph readout (the masked
mean-pool, or the virtual nodes' rows, with `readout_edges` the mean of
the edge channel over the valid pairs beside it), the per-node readout or
the per-pair edge readout (on the edge channel, or in its pairwise-cat
form on the two nodes' features and the edge channel); the head and the
node and edge readouts leave the virtual nodes out. The residual and
constrained channels hand the head and the edge readouts the final-normed
e, the `bias` and `none` channels the raw e. `GraphModelConfig` is
redeclared with the JAX fields, defaults and checks (the JAX module
imports jax). Parameters carry the JAX params-tree names, so a state-dict
key such as `stack.layers.0.dense_qkv.kernel` is the flat npz key
`stack/layers/0/dense_qkv/kernel` (see `egt_torch.weights`); a BatchNorm's
`moving_mean` / `moving_var` are parameters that no gradient reaches.

The forward's side outputs, the JAX `ModelContext.losses` / `.metrics` /
`.stats_updates` / `.analysis`, come back in a `ModelContext` beside the
predictions when the caller asks (`with_context=True`): the distance
objective's weighted loss under `losses` and its unweighted value under
`metrics`; a training forward's BatchNorm moving-statistics updates under
`stats_updates` (the training step writes them, `training/steps.py`);
with `capture_analysis` each layer's attention tensors under `analysis`
(the plain path, no kernel, no `remat`: `models/layers.py`), and with
`combine_layer_repr` the lists `all_node_repr` / `all_edge_repr` there.
`analyze` is the JAX `analyze`: the forward re-run with capture on.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from . import features as F
from . import layers as L
from .. import tracing
from ..parallel import collectives as C
from ..ops.rng import fold_seed


@dataclass
class GraphModelConfig:
    # core transformer
    model_width: int = 128
    edge_width: int = 32
    num_heads: int = 8
    model_height: int = 4
    max_length: int | None = None
    gate_attention: bool = True
    node_normalization: str = "layer"
    edge_normalization: str = "layer"
    l2_reg: float = 0.0
    node_dropout: float = 0.0
    edge_dropout: float = 0.0
    add_n_norm: bool = False
    activation: str = "elu"
    mlp_layers: tuple = (0.5, 0.25)
    do_final_norm: bool = True
    clip_logits_value: tuple | None = (-5.0, 5.0)
    edge_activation: str | None = None
    edge_channel_type: str = "residual"   # residual|bias|constrained|none
    combine_layer_repr: bool = False
    ffn_multiplier: float = 2.0
    node2edge_xtalk: float = 0.0
    edge2node_xtalk: float = 0.0
    global_step_layer: bool = False
    scale_degree: bool = False
    scaler_type: str = "log"
    num_virtual_nodes: int = 0
    random_mask_prob: float = 0.0
    attn_dropout: float = 0.0
    # adjacency / structural
    use_adj: bool = True
    include_xpose: bool = False
    upto_hop: int = 1
    clip_hops: bool = True
    max_degree_enc: int = 0
    bidir_degree: bool = True
    distance_loss: float = 0.0
    distance_target: int = 8
    max_diffuse_t: int = 0
    # positional encodings
    use_svd: bool = False
    num_svd_features: int = 16
    sel_svd_features: int = 8
    transform_svd: bool = False
    use_eig: bool = False
    num_eig_features: int = 20
    sel_eig_features: int = 8
    transform_eig: bool = False
    random_neg: bool = False
    # inputs / task head
    node_input_kind: str = "tokens"       # tokens|dense
    edge_input_kind: str = "tokens"       # tokens|dense|none
    num_node_features: int = 28
    num_edge_features: int = 4
    node_feature_dim: int | None = None
    edge_feature_dim: int | None = None
    node_vocab_sizes: tuple | None = None
    edge_vocab_sizes: tuple | None = None
    num_targets: int = 1
    readout_kind: str = "graph"           # graph|node|edge
    readout_edges: bool = False
    node2edge_embed: bool = False
    use_node_embeddings: bool = False
    mask_value: float = -1.0
    # execution knobs (kept with the JAX names and values)
    attention_impl: str = "auto"          # einsum | vpu | auto: one path here
    attn_chain_f32: bool = True           # False: logits/softmax/gate chain in
    #   the compute dtype
    fused_attention: bool | str = False   # attention kernel; "auto" = on
    fused_edge_block: bool = False        # edge-block kernel
    fused_layer: bool | str = False       # whole-layer kernel; "auto" = on
    compute_dtype: str = "float32"        # float32 | bfloat16
    remat: bool | str = False             # training only

    def __post_init__(self):
        if self.scale_degree and not self.gate_attention:
            raise ValueError("scale_degree only works with gate_attention")
        if self.scale_degree and self.edge_channel_type == "none":
            raise ValueError("scale_degree requires an edge channel "
                             "(edge_channel_type != 'none')")
        if self.edge_channel_type not in ("residual", "bias", "constrained",
                                          "none"):
            raise ValueError(f"unknown edge_channel_type "
                             f"{self.edge_channel_type!r}")
        if self.scaler_type not in ("log", "linear"):
            raise ValueError("scaler_type must be log or linear")

    @property
    def needs_edge_embedding(self) -> bool:
        """The edge embedding is built when something reads it: an edge
        stream (every channel but `none`), the distance head or the edge
        readout; with `none` the stack passes it through unchanged."""
        return (self.edge_channel_type != "none" or self.distance_loss > 0
                or self.readout_kind == "edge" or self.readout_edges)

    @property
    def edge_residual(self) -> bool:
        return self.edge_channel_type in ("residual", "constrained")


def unsupported(cfg: GraphModelConfig) -> list[str]:
    """The configs the port refuses. Every option of JAX's
    `GraphModelConfig` runs on one device; what is left is the distance
    head feeding a readout of the edge channel, where JAX's readout reads
    the head's logits (of `distance_target + 1` features, not the edge
    width the readout takes) and fails."""
    if cfg.distance_loss > 0 and (cfg.readout_kind == "edge"
                                  or cfg.readout_edges):
        return ["the distance head with the edge readout (JAX's readout "
                "would read the distance head's logits)"]
    return []


@dataclass
class ModelContext:
    """Side outputs of one forward pass: auxiliary losses (added to the
    scheme's loss) and metric scalars (reported beside its metrics), each a
    0-d f32 tensor by name, the BatchNorm moving-statistics updates of a
    training forward ({JAX path under `stack`, e.g. `("layers", 0,
    "node_ffn", "norm")`: {"moving_mean", "moving_var"}}), and the analysis
    captures (JAX's keys, e.g. `mha_00/mat`; the `combine_layer_repr`
    lists)."""
    losses: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)
    stats_updates: dict = field(default_factory=dict)
    analysis: dict = field(default_factory=dict)


# the JAX fold tags of the positional encodings' seeds (`fold_rng(rng, 101)`
# for the SVD PE, 102 for the eigenvector PE)
PE_TAGS = {"svd": 101, "eig": 102}


def _vocab(vocab_sizes, num_features: int) -> int:
    """Rows of a token table: the multi-column table's columns end to end,
    or one column's `num_features`, plus the mask row."""
    return (num_features if vocab_sizes is None
            else int(sum(vocab_sizes))) + 1


def _token_embed(p, ids, vocab_sizes):
    if vocab_sizes is None:
        return F.token_embed(p, ids)
    return F.multi_token_embed(p, ids, vocab_sizes)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.
    With no GPU present and no device given, raise."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


class EGTGraphModel(nn.Module):
    """The EGT model: graph regression (ZINC), graph classification (MNIST,
    CIFAR10), node classification (SBM) or edge classification (TSP).

    Parameters are initialised from `generator` (a CPU `torch.Generator`;
    seeded 0 if None) and placed on `device` (see `resolve_device`)."""

    def __init__(self, cfg: GraphModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        refused = unsupported(cfg)
        if refused:
            raise NotImplementedError("refused: " + ", ".join(refused))
        if cfg.node_input_kind not in ("tokens", "dense"):
            raise ValueError(f"unknown node_input_kind "
                             f"{cfg.node_input_kind!r}")
        if cfg.edge_input_kind not in ("tokens", "dense", "none"):
            raise ValueError(f"unknown edge_input_kind "
                             f"{cfg.edge_input_kind!r}")
        if cfg.readout_kind not in ("graph", "node", "edge"):
            raise ValueError(f"unknown readout_kind {cfg.readout_kind!r}")
        self.cfg = cfg
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        w, ew = cfg.model_width, cfg.edge_width
        if cfg.node_input_kind == "tokens":
            self.node_emb = F.embedding_params(
                _vocab(cfg.node_vocab_sizes, cfg.num_node_features), w,
                generator)
        else:
            self.node_emb = F.dense_params(cfg.node_feature_dim, w, generator)
        if cfg.use_svd and cfg.transform_svd:
            self.svd_emb = F.dense_params(2 * cfg.sel_svd_features, w,
                                          generator)
        if cfg.use_eig and cfg.transform_eig:
            self.eig_emb = F.dense_params(cfg.sel_eig_features, w, generator)
        if cfg.max_degree_enc > 0:
            din = (cfg.max_degree_enc + 1) * (2 if cfg.bidir_degree else 1)
            self.degree_emb = F.dense_params_uniform(din, w, generator)
        if cfg.needs_edge_embedding:
            if cfg.edge_input_kind == "tokens":
                self.fm_emb = F.embedding_params(
                    _vocab(cfg.edge_vocab_sizes, cfg.num_edge_features), ew,
                    generator)
            elif cfg.edge_input_kind == "dense":
                self.fm_emb = F.dense_params(cfg.edge_feature_dim, ew,
                                             generator)
            if cfg.use_adj and cfg.upto_hop >= 1:
                self.adj_emb = F.dense_params(
                    cfg.upto_hop * (2 if cfg.include_xpose else 1), ew,
                    generator)
            if cfg.node2edge_embed:
                if cfg.node_input_kind == "tokens":
                    self.node2edge_emb = F.embedding_params(
                        cfg.num_node_features + 1, 2 * ew, generator)
                else:
                    self.node2edge_emb = F.dense_params(
                        cfg.node_feature_dim, 2 * ew, generator)
            if cfg.max_diffuse_t > 0:
                self.diffusion_emb = F.dense_params(
                    ew * cfg.max_diffuse_t, ew, generator)
        k = cfg.num_virtual_nodes
        if k > 0:
            # raw arrays under the JAX names, drawn as JAX draws them
            self.virtual_node_embeddings = nn.Parameter(
                F.uniform_05((k, w), generator))
            if cfg.needs_edge_embedding:
                self.virtual_edge_embeddings = nn.Parameter(
                    F.uniform_05((k, ew), generator))
        stack = {"layers": nn.ModuleList(
            [L.EGTLayer(cfg, generator) for _ in range(cfg.model_height)])}
        if (not cfg.add_n_norm) and cfg.do_final_norm:
            stack["node_norm_final"] = L.norm_params(
                w, kind=cfg.node_normalization)
            if cfg.edge_residual:
                stack["edge_norm_final"] = L.norm_params(
                    ew, kind=cfg.edge_normalization)
        self.stack = nn.ModuleDict(stack)
        if cfg.distance_loss > 0:
            mlp, din = self._mlp_params(ew, generator)
            self.distance_head = nn.ModuleDict({
                "mlp": nn.ModuleDict({"dense": mlp}),
                "distance_target": F.dense_params(
                    din, cfg.distance_target + 1, generator)})
        mlp, din = self._mlp_params(self._readout_in_dim(), generator)
        self.mlp_out = nn.ModuleDict({"dense": mlp})
        self.target = F.dense_params(din, cfg.num_targets, generator)
        self.to(dev)

    def _readout_in_dim(self) -> int:
        """The readout MLP's input width (`_readout_in_dim` in JAX): the
        graph readout reads the k virtual nodes' rows side by side (or the
        mean node), the edge readout the edge channel, in its pairwise-cat
        form the two nodes' features before it; `readout_edges` adds the
        mean pair's edge features to the graph's."""
        cfg = self.cfg
        if cfg.readout_kind == "graph":
            # with virtual nodes, the graph is read from their k rows
            return cfg.model_width * max(1, cfg.num_virtual_nodes) + (
                cfg.edge_width if cfg.readout_edges else 0)
        if cfg.readout_kind == "node":
            return cfg.model_width
        if cfg.use_node_embeddings:
            return 2 * cfg.model_width + cfg.edge_width
        return cfg.edge_width

    def _mlp_params(self, din: int, generator):
        """The Dense layers of `mlp_layers` (widths f x model_width) from
        `din` inputs, and their output width."""
        mlp = []
        for f in self.cfg.mlp_layers:
            dout = round(f * self.cfg.model_width)
            mlp.append(F.dense_params(din, dout, generator))
            din = dout
        return nn.ModuleList(mlp), din

    @property
    def device(self) -> torch.device:
        return self.target["kernel"].device

    @property
    def compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.cfg.compute_dtype == "bfloat16"
                else torch.float32)

    @property
    def input_keys(self) -> tuple:
        """The batch keys the forward reads."""
        cfg = self.cfg
        keys = ["node_features"]
        if cfg.needs_edge_embedding and cfg.edge_input_kind in ("tokens",
                                                                "dense"):
            keys.append("feature_matrix")
        keys.append("graph_matrix")
        if cfg.use_svd:
            keys.append("singular_vectors")
        if cfg.use_eig:
            keys.append("eigen_vectors")
        return tuple(keys)

    def node_valid(self, batch) -> torch.Tensor:
        """(b, l) bool: a token >= 0 (column 0's of multi-column tokens), or
        a dense row with a feature other than `mask_value`."""
        nf = torch.as_tensor(batch["node_features"], device=self.device)
        if self.cfg.node_input_kind == "tokens":
            return (nf if nf.dim() == 2 else nf[..., 0]) >= 0
        return torch.any(nf != self.cfg.mask_value, dim=-1)

    def edge_valid(self, batch) -> torch.Tensor:
        """(b, l, l) bool: an edge token >= 0 (column 0's of multi-column
        tokens), or a dense row with a feature other than `mask_value`."""
        fm = torch.as_tensor(batch["feature_matrix"], device=self.device)
        if self.cfg.edge_input_kind == "tokens":
            return (fm if fm.dim() == 3 else fm[..., 0]) >= 0
        return torch.any(fm != self.cfg.mask_value, dim=-1)

    def output_mask(self, batch):
        """The mask Keras would feed into compiled losses and metrics: none
        for a graph readout, node validity for a node readout, edge
        validity for an edge readout."""
        kind = self.cfg.readout_kind
        if kind == "graph":
            return None
        if kind == "node":
            return self.node_valid(batch)
        return self.edge_valid(batch)

    def embed_nodes(self, batch, training: bool = False, pe_seed=None,
                    sp=None):
        """The node embedding in f32 (virtual nodes not yet prepended):
        tokens (one column or several) or masked dense features, plus
        the SVD or eigenvector PE, plus the degree encoding. `pe_seed` (the
        step's seed) keys the PE's sign flips at training time, folded with
        the JAX tag of each PE. Under `sp` the adjacency holds a shard's
        rows, and the degrees come whole from the shards."""
        cfg = self.cfg
        dev = self.device
        nf = torch.as_tensor(batch["node_features"], device=dev)
        if cfg.node_input_kind == "tokens":
            h = _token_embed(self.node_emb, nf, cfg.node_vocab_sizes)
        else:
            h = F.masked_dense_embed(self.node_emb, nf.float(),
                                     cfg.mask_value)

        def seed(kind):
            return None if pe_seed is None else fold_seed(pe_seed,
                                                          PE_TAGS[kind])
        if cfg.use_svd:
            h = h + F.process_svd(
                getattr(self, "svd_emb", None),
                torch.as_tensor(batch["singular_vectors"], device=dev).float(),
                sel=cfg.sel_svd_features, model_width=cfg.model_width,
                transform=cfg.transform_svd, random_neg=cfg.random_neg,
                training=training, seed=seed("svd"))
        if cfg.use_eig:
            h = h + F.process_eig(
                getattr(self, "eig_emb", None),
                torch.as_tensor(batch["eigen_vectors"], device=dev).float(),
                sel=cfg.sel_eig_features, model_width=cfg.model_width,
                transform=cfg.transform_eig, random_neg=cfg.random_neg,
                training=training, seed=seed("eig"))
        if cfg.max_degree_enc > 0:
            adj = torch.as_tensor(batch["graph_matrix"], device=dev).float()
            if sp is not None:
                deg = F.degree_encoding_sp(adj, cfg.max_degree_enc,
                                           cfg.bidir_degree, sp.group)
            else:
                deg = F.degree_encoding(adj, cfg.max_degree_enc,
                                        cfg.bidir_degree)
            h = h + F.dense(self.degree_emb, deg)
        return h

    def _embed_edges(self, batch, adj, sp=None):
        """The edge channel in f32: the edge features' embedding, the hop
        embedding (with `include_xpose` the transposed hops beside the
        hops), the pairwise sum of the node2edge embedding and the
        diffusion of the edge features' embedding, summed in that order.
        Under `sp`, this shard's rows (the `_sp` twins of `features.py`)."""
        cfg = self.cfg
        dev = self.device
        parts = []
        fm_emb = None
        if cfg.edge_input_kind != "none":
            fm = torch.as_tensor(batch["feature_matrix"], device=dev)
            if cfg.edge_input_kind == "tokens":
                fm_emb = _token_embed(self.fm_emb, fm, cfg.edge_vocab_sizes)
            else:
                fm_emb = F.masked_dense_embed(self.fm_emb, fm.float(),
                                              cfg.mask_value)
            parts.append(fm_emb)
        if cfg.use_adj and cfg.upto_hop >= 1:
            if sp is not None:
                hops = F.stack_hops_sp(adj, cfg.upto_hop, sp.group,
                                       cfg.clip_hops, cfg.include_xpose,
                                       sp.index, sp.lq)
            else:
                hops = F.stack_hops(adj, cfg.upto_hop, cfg.clip_hops)
                if cfg.include_xpose:
                    hops = torch.cat([hops, hops.transpose(1, 2)], dim=-1)
            parts.append(F.dense(self.adj_emb, hops))
        if cfg.node2edge_embed:
            nf = torch.as_tensor(batch["node_features"], device=dev)
            if cfg.node_input_kind == "tokens":
                x = F.token_embed(self.node2edge_emb, nf)
            else:
                x = F.dense(self.node2edge_emb, nf.float())
            parts.append(F.pairwise_add(x) if sp is None
                         else F.pairwise_add_sp(x, sp.index, sp.lq))
        if cfg.max_diffuse_t > 0:
            if fm_emb is None:
                raise ValueError("max_diffuse_t diffuses the edge features, "
                                 "and edge_input_kind is 'none'")
            if sp is not None:
                diffused = F.edge_diffusion_sp(fm_emb, adj,
                                               self.edge_valid(batch),
                                               cfg.max_diffuse_t, sp.group)
            else:
                diffused = F.edge_diffusion(fm_emb, adj,
                                            self.edge_valid(batch),
                                            cfg.max_diffuse_t)
            parts.append(F.dense(self.diffusion_emb, diffused))
        if not parts:
            raise ValueError("edge stream requested but no edge inputs")
        e = parts[0]
        for x in parts[1:]:
            e = e + x
        return e

    def forward(self, batch: dict, training: bool = False, seeds=None,
                pe_seed=None, with_context: bool = False,
                capture_analysis: bool = False, sp=None, data=None,
                tp=None):
        """batch: node_features (b, l) int tokens, (b, l, c) int columns
        (`node_vocab_sizes`) or (b, l, f) f32 dense features (-1 /
        `mask_value` padding), feature_matrix (b, l, l) int, (b, l, l, c)
        int columns or (b, l, l, f) f32 (edge inputs only), graph_matrix
        (b, l, l) (any numeric dtype), and singular_vectors (b, l, k, 2) / eigen_vectors
        (b, l, k) with a PE, as tensors or numpy arrays. Returns the f32
        predictions: (b, num_targets) for a graph readout, (b, l,
        num_targets) for a node readout, (b, l, l, num_targets) for an edge
        readout; with `with_context`, the pair (predictions,
        `ModelContext`), and only then does the distance head run. `seeds`
        holds one seed per layer for this step (`fold_rng(rng, 1000 + i)`
        in JAX); training draws and dropout need it. `pe_seed` is the step's seed for the PE sign flips
        (`random_neg`). `capture_analysis` runs every layer on the plain
        path and fills the context's `analysis` (with virtual nodes the
        captures keep their k rows, as in JAX). With `cfg.remat` and
        autograd on, each layer runs under `torch.utils.checkpoint`, off
        under capture (as in JAX).

        Parallel runs (`parallel/edge_partition.py` drives them): with `sp`
        (a `layers.SPContext`), graph_matrix and feature_matrix hold the
        query rows of this rank's shard, every pair tensor is a row block,
        and a node or edge readout returns this shard's rows (the caller
        gathers them); the distance objective's sum and `readout_edges`
        are psums over the shards. `data` (a `collectives.Group`) makes the
        BatchNorm statistics the global batch's when the batch is a shard
        of it. `tp` (a `collectives.Group`) when the layers hold their
        tensor-parallel shards (`parallel/partitioning.py`)."""
        cfg = self.cfg
        dev = self.device
        if sp is not None:
            self._check_sp_supported(training)
        if seeds is not None and len(seeds) != cfg.model_height:
            raise ValueError(f"need {cfg.model_height} layer seeds, got "
                             f"{len(seeds)}")
        with tracing.span("embed"):
            # the dataset ships the adjacency in a narrow integer dtype
            adj = torch.as_tensor(batch["graph_matrix"], device=dev).float()
            node_mask = self.node_valid(batch)
            h = self.embed_nodes(batch, training, pe_seed, sp)
            e = (self._embed_edges(batch, adj, sp)
                 if cfg.needs_edge_embedding else None)
            edge_mask = (adj if cfg.edge_channel_type == "constrained"
                         else None)

            k = cfg.num_virtual_nodes
            if k > 0:
                h = F.prepend_virtual_nodes(h, self.virtual_node_embeddings)
                if e is not None:
                    e = (F.prepend_virtual_edges(
                        e, self.virtual_edge_embeddings) if sp is None
                        else F.prepend_virtual_edges_sp(
                            e, self.virtual_edge_embeddings))
                node_mask = torch.nn.functional.pad(node_mask, (k, 0),
                                                    value=True)
                if edge_mask is not None:
                    edge_mask = F.extend_edge_mask_for_vn(
                        edge_mask[..., None], k)[..., 0]

            dtype = self.compute_dtype
            h = h.to(dtype)
            if e is not None:
                e = e.to(dtype)
        ctx = ModelContext()
        analysis = ctx.analysis if capture_analysis else None
        all_reprs = [] if cfg.combine_layer_repr else None

        def run_layer(layer, h, e, seed, i):
            # the side outputs are returned, not written into the caller's
            # containers: under `remat` the backward runs this again
            updates = {}
            reprs = [] if cfg.combine_layer_repr else None
            with tracing.span("layer", index=i):
                h, e = layer(h, e, node_mask, edge_mask, training, seed,
                             analysis, i, reprs, updates, sp, data, tp)
            return h, e, updates, reprs

        remat = bool(cfg.remat) and not capture_analysis \
            and torch.is_grad_enabled()
        for i, layer in enumerate(self.stack["layers"]):
            seed = None if seeds is None else seeds[i]
            if remat:
                # the draws are keyed by explicit seeds (`ops/rng.py`,
                # `layers.dropout`), so the recompute draws the same bits
                # with no global RNG state to stash
                h, e, updates, reprs = checkpoint(
                    run_layer, layer, h, e, seed, i, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=remat_context(cfg.remat))
            else:
                h, e, updates, reprs = run_layer(layer, h, e, seed, i)
            for path, upd in updates.items():
                ctx.stats_updates[("layers", i) + path] = upd
            if all_reprs is not None:
                all_reprs += reprs
        if all_reprs is not None:
            ctx.analysis["all_node_repr"] = [n for n, _ in all_reprs]
            ctx.analysis["all_edge_repr"] = [x for _, x in all_reprs
                                             if x is not None]
        # the graph and node readouts read no edges: the final edge norm
        # of the residual / constrained channels runs for the edge readout,
        # `readout_edges`, and the distance head when the caller takes the
        # side outputs (and for a BatchNorm's statistics in training); the
        # `bias` and `none` channels hand them the raw e. They read the
        # graph's pairs alone: e loses its virtual rows and columns after
        # the norm, as in JAX (a BatchNorm's statistics count them)
        with tracing.span("readout"):
            distance = with_context and cfg.distance_loss > 0
            reads_e = (distance or cfg.readout_kind == "edge"
                       or cfg.readout_edges)
            if (not cfg.add_n_norm) and cfg.do_final_norm:
                st = self.stack
                h = L.norm(cfg.node_normalization, st["node_norm_final"], h,
                           training, ctx.stats_updates, ("node_norm_final",),
                           data)
                if cfg.edge_residual and (reads_e or (
                        training and cfg.edge_normalization == "batch")):
                    e = L.norm(cfg.edge_normalization, st["edge_norm_final"],
                               e, training, ctx.stats_updates,
                               ("edge_norm_final",),
                               data if sp is None else sp.stats)
            if k > 0 and reads_e:
                e = e[:, k:, k:]
            if distance:
                metric = self._distance_loss(e, adj, sp)
                ctx.metrics["distance_loss"] = metric
                ctx.losses["distance_loss"] = metric * cfg.distance_loss
            out = self._readout(h, e, node_mask, batch, sp).float()
        return (out, ctx) if with_context else out

    def analyze(self, batch: dict, training: bool = False, seeds=None,
                pe_seed=None) -> dict:
        """Per-layer attention logits, matrices, gates and edge biases: the
        forward re-run with capture on (JAX's `analyze`). Returns the
        context's `analysis` dict."""
        _, ctx = self(batch, training, seeds, pe_seed, with_context=True,
                      capture_analysis=True)
        return ctx.analysis

    def _distance_loss(self, e, adj, sp=None):
        """The distance objective in f32: the head's (b, l, l,
        distance_target + 1) logits on the edge channel, the
        cross-entropy to the k-hop reachability count on the pairs it is
        positive, summed a graph and averaged over the batch. (A count past
        the last class, which the data never gives, is clamped to it.)
        Under `sp` a graph's sum is a psum of its shards' rows."""
        cfg = self.cfg
        target = (F.distance_targets(adj, cfg.distance_target) if sp is None
                  else F.distance_targets_sp(adj, cfg.distance_target,
                                             sp.group))
        x = e.float()
        for dp in self.distance_head["mlp"]["dense"]:
            x = L.activation(cfg.activation, F.dense(dp, x))
        logits = F.dense(self.distance_head["distance_target"], x)
        logp = torch.log_softmax(logits, dim=-1)
        idx = torch.clamp(target, 0, cfg.distance_target)
        elem = -torch.gather(logp, -1, idx[..., None])[..., 0]
        elem = elem * (target > 0)
        per_graph = torch.sum(elem.reshape(elem.shape[0], -1), dim=-1)
        if sp is not None:
            per_graph = C.psum(per_graph, sp.group)
        return torch.mean(per_graph)

    def _mlp_out(self, x):
        x = x.float()
        for dp in self.mlp_out["dense"]:
            x = L.activation(self.cfg.activation, F.dense(dp, x))
        return F.dense(self.target, x)

    def _readout(self, h, e, node_mask, batch, sp=None):
        """Graph: masked mean-pool over valid nodes (with virtual nodes,
        their k rows side by side), with `readout_edges` the mean of the
        edge channel over the valid pairs beside it -> MLP -> target. Node:
        the MLP on every
        node; edge: on every pair of the edge channel (final-normed for the
        residual / constrained channels; padding included, the loss masks
        it), with `use_node_embeddings` preceded by the pair's two node
        features (pairwise cat). The node and edge readouts leave the
        virtual nodes out. In f32. Under `sp` the node and edge readouts
        give this shard's rows, and the edge means are psums."""
        k = self.cfg.num_virtual_nodes
        if self.cfg.readout_kind == "node":
            return self._mlp_out(h[:, k:] if sp is None
                                 else C.sp_row_slice(h, sp))
        if self.cfg.readout_kind == "edge":
            if self.cfg.use_node_embeddings:
                hf = h[:, k:].float()
                row = hf if sp is None else C.sp_row_slice(h, sp).float()
                e = torch.cat([F.pairwise_cat(row, hf), e.float()], dim=-1)
            return self._mlp_out(e)
        if k > 0:
            x = h[:, :k].reshape(h.shape[0], -1).float()
        else:
            m = node_mask.float()[..., None]
            x = torch.sum(h.float() * m, dim=1) / torch.clamp(
                torch.sum(m, dim=1), min=1.0)
        if self.cfg.readout_edges:
            em = self.edge_valid(batch).float()[..., None]
            es = torch.sum(e.float() * em, dim=(1, 2))
            ec = torch.sum(em, dim=(1, 2))
            if sp is not None:      # the shards' rows are disjoint: exact
                es, ec = C.psum(es, sp.group), C.psum(ec, sp.group)
            x = torch.cat([x, es / torch.clamp(ec, min=1.0)], dim=-1)
        return self._mlp_out(x)

    def _check_sp_supported(self, training: bool):
        """The combinations edge partitioning refuses, as JAX refuses them
        (`graph_model.py:690-704`)."""
        cfg = self.cfg
        refused = []
        if cfg.num_virtual_nodes > 0:
            if cfg.edge_normalization == "batch":
                # the replicated virtual rows would count once a shard in
                # the edge stream's statistics
                refused.append("BatchNorm edge normalization with virtual "
                               "nodes")
            if training and (cfg.random_mask_prob > 0
                             or cfg.attn_dropout > 0):
                refused.append("stochastic attention with virtual nodes "
                               "(replicated VN rows would diverge)")
        if refused:
            raise NotImplementedError(
                "edge partitioning does not support: " + ", ".join(refused))


def _dots_policy(ctx, op, *args, **kwargs):
    """`remat: "dots"`, the counterpart of JAX's
    `dots_with_no_batch_dims_saveable`: the outputs of the plain matrix
    products (`aten.mm`, `aten.addmm`: the Dense layers) are saved, and
    everything else is recomputed, the batched products (`aten.bmm`: the
    attention core's and the hops') included. The hand-written kernels
    launch inside `autograd.Function`s that no dispatch mode sees, so they
    are always recomputed, as JAX recomputes a `pallas_call`."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_context(mode):
    """The checkpoint's `context_fn` for `cfg.remat`: True recomputes the
    whole layer, "dots" saves the plain matrix products (`_dots_policy`)."""
    if mode == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    return noop_context_fn
