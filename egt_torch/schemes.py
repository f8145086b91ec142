"""Config resolution: a run config (the JSON files under `configs/`) ->
`GraphModelConfig`, and the ZINC loss binding.

Port of the serving side of the JAX package's config chain: the trainer
defaults (`egt_tpu/training/trainer.py::TrainingBase.get_default_config`),
the scheme defaults and `model_config_kwargs` of `schemes/base.py`, the ZINC
binding of `schemes/zinc.py`, and the dispatch-knob copy of
`TrainingBase.load_model`. The default tables carry the whole key surface of
the trainer and the scheme, so the strict unknown-key check accepts every key
a ZINC config may hold, including those serving ignores. They are the one
copy: the engine's scheme classes (`training/schemes/`) read them from here.
"""

from __future__ import annotations

import torch

from .models.graph_model import GraphModelConfig
from .training import metrics as M
from .utils.hparams import Derived, HParams, join_path, read_config_from_file

ZINC_MAX_LENGTH = 40     # the ZINC dataset's declared pad length
SCHEMES = ("zinc.svd", "zinc.eig")


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
    """BaseDC -> BaseAdj -> BaseSVD (`pe` "svd") | BaseEig ("eig")."""
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
    else:
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


# the ZINC mixin's defaults (`egt_tpu/training/schemes/zinc.py:26-34`)
ZINC_DEFAULTS = dict(
    dataset_name="zinc",
    num_virtual_nodes=0,
    rlr_monitor="val_mae",
    save_best_monitor="val_mae",
)


def zinc_defaults(pe: str) -> HParams:
    c = scheme_defaults(pe)
    c.update(ZINC_DEFAULTS)
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
    else:
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
        raise NotImplementedError(f"scheme {scheme!r} is not ported yet "
                                  f"(ported: {', '.join(SCHEMES)})")
    return zinc_defaults(scheme.partition(".")[2]).strict_update(config)


def model_config_from_config(config: dict | str) -> GraphModelConfig:
    """GraphModelConfig of a `zinc.svd` / `zinc.eig` run config, with the
    dispatch knobs copied in as the JAX trainer copies them."""
    c = resolve_config(config)
    pe = c.scheme.partition(".")[2]
    cfg = GraphModelConfig(
        **_model_config_kwargs(c, pe),
        node_input_kind="tokens", edge_input_kind="tokens",
        num_node_features=28, num_edge_features=4,
        num_targets=1, readout_kind="graph", readout_edges=False,
        num_virtual_nodes=c.num_virtual_nodes,
    )
    cfg.max_length = ZINC_MAX_LENGTH
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


def loss_and_metrics(pred, target, mask, sample_mask):
    """The ZINC schemes' loss (`egt_tpu/training/schemes/zinc.py:46-49`):
    the MAE of the graph target, with its (sum, count) pair as `mae`."""
    s, c = M.mae_loss(pred, target, mask, sample_mask)
    return s / torch.clamp(c, min=1.0), {"mae": (s, c)}
