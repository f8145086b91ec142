"""Config resolution: a run config (the JSON files under `configs/`) ->
`GraphModelConfig`, and the loss of its scheme.

Port of the serving side of the JAX package's config chain: the trainer
defaults (`egt_tpu/training/trainer.py::TrainingBase.get_default_config`),
the scheme defaults and `model_config_kwargs` of `schemes/base.py`, the
dataset bindings of `schemes/zinc.py`, `zinc_full.py`, `pattern.py`,
`cluster.py`, `mnist.py`, `cifar10.py`, `tsp.py` and `pcqm4mv2.py`
(`DATASETS`: their defaults, model inputs and readout, and loss), and the
dispatch-knob copy of `TrainingBase.load_model`. The default tables carry the
whole key surface of the trainer and the scheme, so the strict unknown-key
check accepts every key a config of a ported scheme may hold, including those
serving ignores. They are the one copy: the engine's scheme classes
(`training/schemes/`) read them from here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .data import datasets as D
from .models.graph_model import GraphModelConfig
from .training import metrics as M
from .utils.hparams import Derived, HParams, join_path, read_config_from_file


def trainer_defaults() -> HParams:
    """`TrainingBase.get_default_config`."""
    return HParams(
        scheme=None,
        model_name="unnamed_model",
        distributed=False,
        batch_size=Derived(lambda c: 32 if c.distributed else 128),
        initial_lr=5e-4,
        gradient_clipval=None,
        num_epochs=1000,
        dataset_path="datasets/gnn_benchmark.h5",
        save_path=Derived(lambda c: join_path("models", c.model_name)),
        checkpoint_path=Derived(lambda c: join_path(c.save_path, "checkpoint")),
        log_path=Derived(lambda c: join_path(c.save_path, "logs")),
        config_path=Derived(lambda c: join_path(c.save_path, "config")),
        summary_path=Derived(lambda c: join_path(c.save_path, "summary")),
        saved_model_path=Derived(
            lambda c: join_path(c.save_path, "saved", c.model_name)),
        rlr_factor=0.5,
        rlr_patience=10,
        rlr_monitor=Derived(lambda c: c.save_best_monitor),
        min_lr_factor=0.01,
        stopping_lr=0.0,
        steps_per_epoch=None,
        validation_steps=None,
        save_best=True,
        save_when=Derived(
            lambda c: "" if not c.save_best else
            "epoch;" + c.save_best_monitor +
            "<=save_best_value;epoch{epoch:0>4d}"),
        save_best_monitor="val_loss",
        stopping_patience=0,
        predictions_path=Derived(
            lambda c: join_path(c.save_path, "predictions")),
        weight_file=":",
        prediction_bmult=2,
        optimizer="adam",
        seed=42,
        compute_dtype="bfloat16",
        use_pallas="auto",
        use_pallas_edge=False,
        use_pallas_layer="auto",
        attention_impl="auto",
        attn_chain_f32=True,
        num_devices=None,
        reload_on_nan=False,
        log_tensorboard=True,
        log_interval=60,
        length_buckets=None,
        remat=False,
        edge_partition=1,
        steps_per_dispatch=1,
        grad_accum_steps=1,
        profile_dir=None,
    )


def scheme_defaults(pe: str) -> HParams:
    """BaseDC -> BaseAdj (`pe` "base": no PE) -> BaseSVD ("svd") | BaseEig
    ("eig")."""
    c = trainer_defaults()
    c.update(
        model_name="dc",
        dataset_name="dataset",
        dataset_path=Derived(
            lambda c: f"datasets/{c.dataset_name.upper()}/"
                      f"{c.dataset_name.upper()}.h5"),
        cache_dir=Derived(
            lambda c: f"data_cache/{c.dataset_name.upper()}/data"),
        save_path=Derived(
            lambda c: f"models/{c.dataset_name.lower()}/{c.model_name}"),
        model_width=48,
        model_height=4,
        edge_width=48,
        num_heads=8,
        gate_attention=True,
        scale_degree=False,
        l2_reg=0,
        dropout=0,
        attn_dropout=0.0,
        edge_dropout=None,
        mlp_layers=[0.5, 0.25],
        edge_activation=None,
        edge_channel_type="residual",
        combine_layer_repr=False,
        max_shuffle_len=10000,
        ffn_multiplier=2.0,
        warmup_steps=0,
        total_steps=None,
        random_mask_prob=0.0,
    )
    c.update(
        model_name="dc_mat",
        cache_dir=Derived(lambda c: f"data_cache/{c.dataset_name.upper()}/mat"),
        upto_hop=1,
        distance_loss=0.0,
        distance_target=8,
    )
    if pe == "svd":
        c.update(
            model_name="dc_svd",
            cache_dir=Derived(
                lambda c: f"data_cache/{c.dataset_name.upper()}/"
                          f"svd_{c.num_svd_features}"),
            num_svd_features=16,
            sel_svd_features=8,
            use_svd=True,
            random_neg=True,
        )
    elif pe == "eig":
        c.update(
            model_name="dc_eig",
            cache_dir=Derived(
                lambda c: f"data_cache/{c.dataset_name.upper()}/"
                          f"eig_{c.num_eig_features}"),
            num_eig_features=20,
            sel_eig_features=8,
            use_eig=True,
        )
    return c


def loss_and_metrics(pred, target, mask, sample_mask):
    """The ZINC schemes' loss (`egt_tpu/training/schemes/zinc.py:46-49`):
    the MAE of the graph target, with its (sum, count) pair as `mae`."""
    s, c = M.mae_loss(pred, target, mask, sample_mask)
    return s / torch.clamp(c, min=1.0), {"mae": (s, c)}


def xent_loss(c: HParams) -> Callable:
    """The classification loss: the sparse cross-entropy as `xent`, and the
    accuracy as `acc`, over the valid nodes of a node readout or the valid
    pairs of an edge readout (TSP, `egt_tpu/training/schemes/tsp.py:55-59`,
    unweighted). PATTERN and
    CLUSTER weight each class by its weight from `class_sizes`
    (`egt_tpu/training/schemes/pattern.py:44-50`); MNIST and CIFAR10, whose
    schemes have no `class_sizes`, weigh every graph alike
    (`egt_tpu/training/schemes/mnist.py:36-40`)."""
    sizes = c.get("class_sizes")
    cw = None if sizes is None else M.class_weights_from_sizes(sizes)

    def loss_and_metrics(pred, target, mask, sample_mask):
        s, n = M.sparse_xent_loss(pred, target, mask, sample_mask,
                                  class_weights=cw)
        sa, na = M.accuracy(pred, target, mask, sample_mask)
        return s / torch.clamp(n, min=1.0), {"xent": (s, n), "acc": (sa, na)}
    return loss_and_metrics


@dataclass(frozen=True)
class DatasetBinding:
    """What a dataset's scheme mixin binds: its config defaults over the PE
    chain, the model's inputs and readout (`get_model_config`; a dict, or
    a function of the resolved config giving one), the pad
    length the model is built for (None: the batch's), its loss (a
    function of the resolved config giving `fn(pred, target, mask,
    sample_mask) -> (loss, {metric: (sum, count)})`), and the scheme
    variants JAX has for it (`pes`)."""
    defaults: dict
    model: dict | Callable[[HParams], dict]
    max_length: int | None
    loss: Callable[[HParams], Callable]
    pes: tuple = ("svd", "eig")     # the scheme variants JAX has


def _superpixel_model(node_feature_dim: int) -> dict:
    """The model inputs and readout of the superpixel schemes."""
    return dict(node_input_kind="dense", node_feature_dim=node_feature_dim,
                edge_input_kind="dense", edge_feature_dim=1, num_targets=10,
                readout_kind="graph")


def _tsp_model(c: HParams) -> dict:
    """The TSP mixin's model inputs and edge readout; the pairwise-cat
    readout (`use_node_embeddings`) for the channels without an edge
    residual (`egt_tpu/training/schemes/tsp.py:43-53`)."""
    return dict(node_input_kind="dense", node_feature_dim=2,
                edge_input_kind="dense", edge_feature_dim=1, num_targets=2,
                readout_kind="edge",
                use_node_embeddings=c.edge_channel_type not in
                ("residual", "constrained"))


# `egt_tpu/training/schemes/pattern.py:22-33` (SBM graphs have ~40-190
# nodes: two static bucket shapes instead of one pad to the global max)
_SBM_DEFAULTS = dict(length_buckets=[128, 192], rlr_monitor="val_xent",
                     save_best_monitor="val_xent")

def _zinc(dataset_name: str) -> DatasetBinding:
    """`schemes/zinc.py:26-41` under a dataset name: ZINC and ZINC-full
    share the tokens, the pad length of 40, the MAE loss and the monitors
    (`schemes/zinc_full.py` binds the ZINC mixin to the full dataset)."""
    return DatasetBinding(
        defaults=dict(dataset_name=dataset_name, num_virtual_nodes=0,
                      rlr_monitor="val_mae", save_best_monitor="val_mae"),
        model=dict(edge_input_kind="tokens", num_node_features=28,
                   num_edge_features=4, num_targets=1, readout_kind="graph"),
        max_length=40, loss=lambda c: loss_and_metrics)


DATASETS = {
    "zinc": _zinc("zinc"),
    "zinc_full": _zinc("zinc_full"),
    # `schemes/pattern.py:17-42`
    "pattern": DatasetBinding(
        defaults=dict(_SBM_DEFAULTS, dataset_name="sbm_pattern",
                      class_sizes=[979220, 209900]),
        model=dict(edge_input_kind="none", num_node_features=3,
                   num_targets=2, readout_kind="node"),
        max_length=None, loss=xent_loss),
    # `schemes/cluster.py:13-28`
    "cluster": DatasetBinding(
        defaults=dict(_SBM_DEFAULTS, dataset_name="sbm_cluster",
                      class_sizes=[19695, 19222, 19559, 19417, 19801, 20139]),
        model=dict(edge_input_kind="none", num_node_features=7,
                   num_targets=6, readout_kind="node"),
        max_length=None, loss=xent_loss),
    # `schemes/mnist.py:15-42`: superpixel graphs, dense node features
    # (intensity, x, y) and a dense edge feature, padded to 75; an SVD
    # scheme only
    "mnist": DatasetBinding(
        defaults=dict(dataset_name="mnist", save_best_monitor="val_xent"),
        model=_superpixel_model(3), max_length=75, loss=xent_loss,
        pes=("svd",)),
    # `schemes/cifar10.py:13-31`: (r, g, b, x, y) node features, padded to
    # 150, and the `num_virtual_nodes` key
    "cifar10": DatasetBinding(
        defaults=dict(dataset_name="cifar10", save_best_monitor="val_xent",
                      num_virtual_nodes=0),
        model=_superpixel_model(5), max_length=150, loss=xent_loss,
        pes=("svd",)),
    # `schemes/tsp.py:22-59`: 50-500 points in the unit square, the
    # k-nearest-neighbour edges labelled by the tour; `include_xpose` is a
    # key JAX accepts and does not forward to the model, as here
    "tsp": DatasetBinding(
        defaults=dict(dataset_name="tsp", batch_size=8, prediction_bmult=3,
                      include_xpose=True, save_best_monitor="val_xent",
                      rlr_monitor="val_xent", length_buckets=[128, 256, 512]),
        model=_tsp_model, max_length=None, loss=xent_loss, pes=("svd",)),
    # `schemes/pcqm4mv2.py:21-48`: the multi-column OGB atom and bond
    # tokens, virtual nodes and the degree scaler by default, the MAE of the
    # HOMO-LUMO gap; a pad that follows the data, and the BaseAdj chain
    # with no PE (`.base`) beside the SVD one
    "pcqm4mv2": DatasetBinding(
        defaults=dict(dataset_name="pcqm4mv2", num_virtual_nodes=1,
                      scale_degree=True, attn_dropout=0.0,
                      rlr_monitor="val_mae", save_best_monitor="val_mae"),
        model=dict(node_vocab_sizes=D.OGB_ATOM_DIMS, edge_input_kind="tokens",
                   edge_vocab_sizes=D.OGB_BOND_DIMS, num_targets=1,
                   readout_kind="graph"),
        max_length=None, loss=lambda c: loss_and_metrics,
        pes=("base", "svd")),
}
SCHEMES = tuple(f"{ds}.{pe}" for ds, b in DATASETS.items() for pe in b.pes)


def dataset_defaults(ds: str, pe: str) -> HParams:
    """The defaults of scheme `<ds>.<pe>`."""
    c = scheme_defaults(pe)
    c.update(DATASETS[ds].defaults)
    return c


def _model_config_kwargs(c: HParams, pe: str) -> dict:
    kw = dict(
        model_width=c.model_width,
        edge_width=c.edge_width,
        num_heads=c.num_heads,
        gate_attention=c.gate_attention,
        scale_degree=c.scale_degree,
        random_mask_prob=c.random_mask_prob,
        attn_dropout=c.attn_dropout,
        model_height=c.model_height,
        l2_reg=c.l2_reg,
        node_dropout=c.dropout,
        edge_dropout=c.dropout if c.edge_dropout is None else c.edge_dropout,
        mlp_layers=tuple(c.mlp_layers),
        edge_channel_type=c.edge_channel_type,
        edge_activation=c.edge_activation,
        ffn_multiplier=c.ffn_multiplier,
        combine_layer_repr=c.combine_layer_repr,
        upto_hop=c.upto_hop,
        distance_loss=c.distance_loss,
        distance_target=c.distance_target,
    )
    if pe == "svd":
        kw.update(use_svd=c.use_svd, transform_svd=True,
                  random_neg=c.random_neg,
                  num_svd_features=c.num_svd_features,
                  sel_svd_features=c.sel_svd_features)
    elif pe == "eig":
        kw.update(use_eig=c.use_eig, transform_eig=False, random_neg=True,
                  num_eig_features=c.num_eig_features,
                  sel_eig_features=c.sel_eig_features)
    return kw


def resolve_config(config: dict | str) -> HParams:
    """The run config merged over the scheme's defaults (unknown keys raise
    KeyError). `config` is a dict or the path of a JSON file."""
    if isinstance(config, str):
        config = read_config_from_file(config)
    scheme = config.get("scheme")
    if scheme not in SCHEMES:
        raise KeyError(f"unknown scheme {scheme!r}; known: "
                       f"{', '.join(SCHEMES)}")
    ds, _, pe = scheme.partition(".")
    return dataset_defaults(ds, pe).strict_update(config)


def model_config_from_config(config: dict | str) -> GraphModelConfig:
    """GraphModelConfig of a run config of a ported scheme, with the
    dispatch knobs copied in as the JAX trainer copies them."""
    c = resolve_config(config)
    ds, _, pe = c.scheme.partition(".")
    binding = DATASETS[ds]
    model = binding.model(c) if callable(binding.model) else binding.model
    cfg = GraphModelConfig(
        **_model_config_kwargs(c, pe),
        **{"node_input_kind": "tokens", **model},
        readout_edges=False,
        # a key of the ZINC, CIFAR10 and PCQM4Mv2 mixins only (the others
        # refuse it)
        num_virtual_nodes=c.get("num_virtual_nodes", 0),
    )
    cfg.max_length = binding.max_length
    up = c.use_pallas
    cfg.fused_attention = "auto" if up == "auto" else bool(up)
    cfg.fused_edge_block = bool(c.use_pallas_edge)
    upl = c.use_pallas_layer
    cfg.fused_layer = ("auto" if up == "auto" else False) \
        if upl == "auto" else bool(upl)
    cfg.attention_impl = str(c.attention_impl)
    cfg.attn_chain_f32 = bool(c.attn_chain_f32)
    cfg.compute_dtype = c.compute_dtype
    rm = c.remat
    cfg.remat = rm if rm == "dots" else bool(rm)
    return cfg


def loss_fn(config: dict | str | HParams) -> Callable:
    """`fn(pred, target, mask, sample_mask) -> (loss, {metric: (sum,
    count)})` of a run config's scheme."""
    c = config if isinstance(config, HParams) else resolve_config(config)
    return DATASETS[c.scheme.partition(".")[0]].loss(c)
