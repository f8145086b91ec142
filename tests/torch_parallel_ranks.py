"""The rank side of the port's parallel CPU tests.

Each function here runs in every rank of a world that
`egt_torch.parallel.launch.spawn_ranks` starts (gloo on the CPU, a
`file://` store) and returns numpy results to the test, which compares them
with the unsharded port and with JAX in its own process. A rank imports
torch and the port only.
"""

from __future__ import annotations

import numpy as np
import torch

from egt_torch.models.graph_model import EGTGraphModel, GraphModelConfig
from egt_torch.ops import rng
from egt_torch.parallel import collectives as C
from egt_torch.parallel import dryrun
from egt_torch.parallel import mesh as meshlib
from egt_torch.parallel.edge_partition import edge_partitioned_forward
from egt_torch.training.steps import load_trainer
from egt_torch.weights import flat_arrays, load_npz


def model_for(cfg_kw: dict, weights: str) -> EGTGraphModel:
    model = EGTGraphModel(GraphModelConfig(**cfg_kw), device="cpu")
    return load_npz(model, weights)


def grads_of(model) -> dict:
    return {n.replace(".", "/"): (np.zeros(p.shape, np.float32)
                                  if p.grad is None else p.grad.numpy())
            for n, p in model.named_parameters() if p.requires_grad}


# ------------------------------------------------------------- edge partitioning


def sp_cases(init: dict, cases: dict, model_parallels=(4, 2)) -> dict:
    """{(mp, name): (this rank's data index, output, gradients | None, error
    | None)} for each case on a 4-rank world laid out 1 x 4 and 2 x 2.
    A case is (config kwargs, weights npz, batch, training, with
    gradients); its loss is the sum of the squared outputs."""
    out = {}
    for mp in model_parallels:
        mesh = meshlib.make_mesh(4, model_parallel=mp, device="cpu",
                                 verbose=False, **init)
        for name, (cfg_kw, weights, batch, training, grads) in cases.items():
            model = model_for(cfg_kw, weights)
            seeds = [11 + i for i in range(model.cfg.model_height)]
            try:
                y = edge_partitioned_forward(model, batch, mesh,
                                             training=training, seeds=seeds)
            except NotImplementedError as exc:
                out[(mp, name)] = (mesh.data.index, None, None, str(exc))
                continue
            g = None
            if grads:
                (torch.sum(y ** 2) / mesh.model.size).backward()
                C.sum_gradients([p for p in model.parameters()
                                 if p.requires_grad], mesh.world)
                g = grads_of(model)
            out[(mp, name)] = (mesh.data.index, y.detach().numpy(), g, None)
    return out


def sp_forward(init: dict, cfg_kw: dict, weights: str, batch: dict):
    """On a world of two on the card: the edge-partitioned forward at
    inference and K1's launches in it."""
    from egt_torch.ops import egt_attention

    mesh = meshlib.make_mesh(2, model_parallel=2, verbose=False, **init)
    model = load_npz(EGTGraphModel(GraphModelConfig(**cfg_kw),
                                   device=mesh.device), weights)
    n = egt_attention.KERNEL.launches
    with torch.no_grad():
        y = edge_partitioned_forward(model, batch, mesh)
    return y.cpu().numpy(), egt_attention.KERNEL.launches - n


# -------------------------------------------------------------- data parallelism


def trainer_step(init: dict, config: dict, batch: dict, model_parallel: int,
                 weights: str) -> dict:
    """One `Trainer` step on this rank's shard of `batch`: the reported
    loss and metrics, the step's gradients (summed over the ranks) and the
    parameters after the update."""
    world = init["world_size"]
    mesh = meshlib.make_mesh(world, model_parallel=model_parallel,
                             device="cpu", verbose=False, **init)
    trainer = load_trainer(config, weights, mesh=mesh)
    report = trainer.train_step(meshlib.batch_shard(batch, mesh))
    return {"report": report, "grads": grads_of(trainer.model),
            "params": trainer.flat_params()}


def data_parallel_checks(init: dict, config: dict, batch: dict,
                         bn_case: tuple, weights: str, dry_weights: str
                         ) -> dict:
    """On a world of two data ranks: one trainer step (draws off); the
    draws' seeds and bits of each rank with the draws on, and a step with
    them; the BatchNorm moving statistics of a training forward on the
    rank's shard; and both dry runs from `dry_weights` with the draws off,
    their losses at the first and the second step."""
    res = {"step": trainer_step(init, config, batch, 1, weights)}
    mesh = meshlib.make_mesh(2, device="cpu", verbose=False)
    drawn = load_trainer({**config, "random_mask_prob": 0.3}, weights,
                         mesh=mesh)
    seeds = drawn.layer_seeds(0)
    res["seeds"] = seeds
    res["bits"] = rng.pair_uniform(seeds[0], (1, 8, 8, 2), rng.RANDOM_MASK,
                                   "cpu").numpy()
    res["drawn_step"] = drawn.train_step(meshlib.batch_shard(batch, mesh))
    cfg_kw, bn_weights, bn_batch = bn_case
    model = model_for(cfg_kw, bn_weights)
    _, ctx = model(meshlib.batch_shard(bn_batch, mesh), training=True,
                   with_context=True, data=mesh.data)
    res["stats"] = {"/".join(map(str, k)): {n: v.numpy()
                                             for n, v in upd.items()}
                    for k, upd in ctx.stats_updates.items()}
    kw = dict(weights=dry_weights, device="cpu")
    res["dry"] = {}
    for steps in (1, 2):
        res["dry"]["dp", steps] = dryrun.run_one_step(
            2, 1, steps=steps, random_mask_prob=0.0, **kw)
        res["dry"]["sp", steps] = dryrun.run_one_step_sp(2, 2, steps=steps,
                                                         **kw)
    return res


def dp_sp_checks(init: dict, config: dict, batch: dict, weights: str,
                 dry_weights: str, engine_config: dict) -> dict:
    """On a world of four: one trainer step laid out 2 data x 2 edge
    shards; the dry runs from `dry_weights` (DP x SP 2 x 2 and SP 4, batch
    4, at the first and the second step); and the engine with
    `edge_partition` 4 (one training run, then its validation metrics)."""
    from egt_torch.training.schemes import import_scheme

    res = {"step": trainer_step(init, config, batch, 2, weights)}
    res["dry"] = {(f"sp{sp}", steps): dryrun.run_one_step_sp(
        4, sp, weights=dry_weights, steps=steps, batch_size=4, device="cpu")
        for sp in (2, 4) for steps in (1, 2)}
    scheme = import_scheme(engine_config["scheme"])(engine_config,
                                                    device="cpu")
    scheme.execute_training()
    res["engine"] = scheme.evaluate_split("validation")
    res["engine_epoch"] = scheme.state["current_epoch"]
    res["engine_params"] = flat_arrays(scheme.model)
    return res


def uneven_bucket_losses(init: dict, config: dict, weights: str,
                         batches: list) -> list:
    """On a world of four data ranks: each batch's loss at inference, the
    batches of different pads and the last one ragged (its real graphs
    reach only the first rank)."""
    mesh = meshlib.make_mesh(4, device="cpu", verbose=False, **init)
    trainer = load_trainer(config, weights, mesh=mesh)
    return [trainer.eval_step(meshlib.batch_shard(b, mesh))["loss"]
            for b in batches]


# ------------------------------------------------------------ tensor parallelism


def tensor_parallel_checks(init: dict, weights: str) -> dict:
    """On a world of four, from `weights`, the draws off, batch 4: the dry
    run's loss at its first and its second step for DP 4 x TP 1, DP 2 x TP
    2 and TP 4."""
    kw = dict(weights=weights, batch_size=4, device="cpu",
              random_mask_prob=0.0, init=init)
    return {mp: [dryrun.run_one_step(4, mp, steps=s, **kw) for s in (1, 2)]
            for mp in (1, 2, 4)}
