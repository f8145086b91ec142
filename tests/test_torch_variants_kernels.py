"""The model variants of `test_torch_variants.py` on the kernel paths,
against the JAX package on the CPU (2 layers, width 16, edge width 8, 4
heads, l 12, b 4, f32; the port through the kernels' plain versions, JAX
through its Pallas kernels in interpret mode, as its own tests run them):
cross-talk with BatchNorm and gelu through the attention kernel (K1 / K2),
the encodings with `readout_edges` through the whole-layer kernel (K3 /
K4 / K5) and through the attention kernel and the edge block (K1, K8 / K9,
K2; edge width 64, where JAX takes its edge block). Outputs, the ZINC loss
and every gradient in training mode with the draws off within 1e-4 (the
loss 1e-5), every moving-statistics update within 1e-5, and with BatchNorm
the inference outputs within 1e-4."""

import pytest

from tests.test_torch_variants import KERNEL_MODELS, check_model


@pytest.mark.parametrize("name", list(KERNEL_MODELS))
def test_kernel_path_matches_jax(name):
    check_model(KERNEL_MODELS[name])
