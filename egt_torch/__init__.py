"""egt_torch: the PyTorch / CUDA port of the EGT framework.

Entry points: `egt_torch.serving.load_predictor(config, weights, device=None)`,
`egt_torch.serving.load_serving(path)` (a `torch.export` artifact written by
`export_serving`), `egt_torch.training.steps.load_trainer(config,
weights=None, device=None)`, `EGTGraphModel.analyze(batch)`, the engine's
`TrainingBase.make_predictions` / `do_analysis` / `export_serving`, and
`python -m egt_torch.run_training | do_evaluations | end_training |
do_analysis | export_serving <config>`; several ranks under `torchrun
--standalone --nproc_per_node N -m egt_torch.run_training <config>`
(`distributed`, `num_devices`, `edge_partition`), `load_predictor(...,
mesh=)` / `load_trainer(..., mesh=)` with `egt_torch.parallel.mesh`, and
`python -m egt_torch.parallel.dryrun N`. The package imports torch, numpy,
scipy and (to read HDF5) h5py; it never imports jax or egt_tpu.
"""
