"""EGTGraphModel: config + `nn.Module` with the forward pass.

Port of `egt_tpu/models/graph_model.py` for the ZINC path: token node and
edge embeddings plus the adjacency-hop embedding, the layer stack (with the
training draws and dropout when `training`), the final norms and the masked
mean-pool graph readout. `GraphModelConfig` is
redeclared with the JAX fields, defaults and checks (the JAX module imports
jax). Parameters carry the JAX params-tree names, so a state-dict key such
as `stack.layers.0.dense_qkv.kernel` is the flat npz key
`stack/layers/0/dense_qkv/kernel` (see `egt_torch.weights`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from . import features as F
from . import layers as L


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
    fused_edge_block: bool = False        # edge-block kernel (not ported)
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
    def edge_residual(self) -> bool:
        return self.edge_channel_type in ("residual", "constrained")


def unsupported(cfg: GraphModelConfig) -> list[str]:
    """The model variants this slice of the port does not run yet."""
    out = []
    if not cfg.edge_residual:
        out.append(f"edge_channel_type {cfg.edge_channel_type!r}")
    if cfg.node2edge_xtalk > 0 or cfg.edge2node_xtalk > 0:
        out.append("FFN cross-talk")
    if cfg.node_normalization != "layer" or cfg.edge_normalization != "layer":
        out.append("BatchNorm")
    if cfg.num_virtual_nodes > 0:
        out.append("virtual nodes")
    if cfg.use_svd or cfg.use_eig:
        out.append("SVD / eigenvector positional encodings")
    if cfg.node_input_kind != "tokens" or cfg.edge_input_kind != "tokens" \
            or cfg.node_vocab_sizes is not None \
            or cfg.edge_vocab_sizes is not None:
        out.append("inputs other than single-column tokens")
    if cfg.readout_kind != "graph" or cfg.readout_edges:
        out.append(f"readout {cfg.readout_kind!r} (edges={cfg.readout_edges})")
    if cfg.distance_loss > 0:
        out.append("the distance head")
    if cfg.max_degree_enc > 0 or cfg.max_diffuse_t > 0 or cfg.node2edge_embed \
            or cfg.include_xpose:
        out.append("degree / diffusion / node2edge / transposed-hop encodings")
    if cfg.fused_edge_block:
        out.append("the edge-block kernel (fused_edge_block)")
    if cfg.activation not in ("elu", "relu") \
            and not str(cfg.activation).startswith("lrelu"):
        out.append(f"activation {cfg.activation!r}")
    return out


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
    """The EGT graph-regression model, inference forward.

    Parameters are initialised from `generator` (a CPU `torch.Generator`;
    seeded 0 if None) and placed on `device` (see `resolve_device`)."""

    def __init__(self, cfg: GraphModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        missing = unsupported(cfg)
        if missing:
            raise NotImplementedError("not ported yet: " + ", ".join(missing))
        self.cfg = cfg
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        w, ew = cfg.model_width, cfg.edge_width
        self.node_emb = F.embedding_params(cfg.num_node_features + 1, w,
                                           generator)
        self.fm_emb = F.embedding_params(cfg.num_edge_features + 1, ew,
                                         generator)
        if cfg.use_adj and cfg.upto_hop >= 1:
            self.adj_emb = F.dense_params(cfg.upto_hop, ew, generator)
        stack = {"layers": nn.ModuleList(
            [L.EGTLayer(cfg, generator) for _ in range(cfg.model_height)])}
        if (not cfg.add_n_norm) and cfg.do_final_norm:
            stack["node_norm_final"] = L.norm_params(w)
            stack["edge_norm_final"] = L.norm_params(ew)
        self.stack = nn.ModuleDict(stack)
        mlp, din = [], w
        for f in cfg.mlp_layers:
            dout = round(f * w)
            mlp.append(F.dense_params(din, dout, generator))
            din = dout
        self.mlp_out = nn.ModuleDict({"dense": nn.ModuleList(mlp)})
        self.target = F.dense_params(din, cfg.num_targets, generator)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.target["kernel"].device

    @property
    def compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.cfg.compute_dtype == "bfloat16"
                else torch.float32)

    def output_mask(self, batch):
        """The mask Keras would feed into compiled losses and metrics: none
        for a graph readout, token validity for a node or edge readout."""
        kind = self.cfg.readout_kind
        if kind == "graph":
            return None
        key = {"node": "node_features", "edge": "feature_matrix"}[kind]
        return torch.as_tensor(batch[key], device=self.device) >= 0

    def forward(self, batch: dict, training: bool = False,
                seeds=None) -> torch.Tensor:
        """batch: node_features (b, l) int, feature_matrix (b, l, l) int and
        graph_matrix (b, l, l) (any numeric dtype), as tensors or numpy
        arrays. Returns the (b, num_targets) f32 predictions. `seeds` holds
        one seed per layer for this step (`fold_rng(rng, 1000 + i)` in JAX);
        training draws and dropout need it."""
        cfg = self.cfg
        dev = self.device
        if seeds is not None and len(seeds) != cfg.model_height:
            raise ValueError(f"need {cfg.model_height} layer seeds, got "
                             f"{len(seeds)}")
        nf = torch.as_tensor(batch["node_features"], device=dev)
        fm = torch.as_tensor(batch["feature_matrix"], device=dev)
        # the dataset ships the adjacency in a narrow integer dtype
        adj = torch.as_tensor(batch["graph_matrix"], device=dev).float()

        node_mask = nf >= 0
        h = F.token_embed(self.node_emb, nf)
        e = F.token_embed(self.fm_emb, fm)
        if cfg.use_adj and cfg.upto_hop >= 1:
            hops = F.stack_hops(adj, cfg.upto_hop, cfg.clip_hops)
            e = e + F.dense(self.adj_emb, hops)
        edge_mask = adj if cfg.edge_channel_type == "constrained" else None

        dtype = self.compute_dtype
        h = h.to(dtype)
        e = e.to(dtype)
        for i, layer in enumerate(self.stack["layers"]):
            h, e = layer(h, e, node_mask, edge_mask, training,
                         None if seeds is None else seeds[i])
        if (not cfg.add_n_norm) and cfg.do_final_norm:
            # the graph readout reads no edges, so `edge_norm_final` (kept for
            # the weight names) is not applied
            h = L.layer_norm(self.stack["node_norm_final"], h)
        return self._readout(h, node_mask).float()

    def _mlp_out(self, x):
        x = x.float()
        for dp in self.mlp_out["dense"]:
            x = L.activation(self.cfg.activation, F.dense(dp, x))
        return F.dense(self.target, x)

    def _readout(self, h, node_mask):
        """Masked mean-pool over valid nodes -> MLP -> target, in f32."""
        m = node_mask.float()[..., None]
        s = torch.sum(h.float() * m, dim=1)
        c = torch.sum(m, dim=1)
        return self._mlp_out(s / torch.clamp(c, min=1.0))
