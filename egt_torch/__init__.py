"""egt_torch: the PyTorch / CUDA port of the EGT framework (serving slice).

Entry point: `egt_torch.serving.load_predictor(config, weights, device=None)`.
The package imports torch and numpy only; it never imports jax or egt_tpu.
"""
