"""egt_torch: the PyTorch / CUDA port of the EGT framework.

Entry points: `egt_torch.serving.load_predictor(config, weights, device=None)`,
`egt_torch.training.steps.load_trainer(config, weights=None, device=None)` and
`python -m egt_torch.run_training | do_evaluations | end_training <config>`.
The package imports torch, numpy, scipy and (to read HDF5) h5py; it never
imports jax or egt_tpu.
"""
