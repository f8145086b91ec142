"""The port's activation table against `jax.nn` on the CPU: every function
that maps an array to one of its shape, with JAX's defaults, on a grid of
negative and positive values (13 rows of 13 for the functions over the
last axis) within 1e-6, `lreluN` as the reference's leaky ReLU of
slope N / 10; `glu`, which halves the last axis, and an unknown name
raise. The rows over which softmax, log_softmax and standardize run mix
the grid's values: `standardize` takes JAX's variance, mean(x^2) -
mean(x)^2, which in f32 loses digits to cancellation where |mean| is many
times the spread, and two sums of another order then differ past 1e-6."""

import jax
import numpy as np
import pytest
import torch

from egt_torch.models import layers as TL
from egt_tpu.models import layers as JL

GRID = np.concatenate([np.linspace(-8.0, 8.0, 161),
                       [-1.0, 0.0, 1.0, 3.0, -3.0, 6.0, 1e-3, -1e-3]]
                      ).astype(np.float32)


@pytest.mark.parametrize("name", sorted(TL.ACTIVATIONS) + ["lrelu2"])
def test_activation_matches_jax(name):
    x = GRID
    if name in ("softmax", "log_softmax", "standardize"):
        x = np.random.default_rng(0).permutation(GRID).reshape(-1, 13)
    if name == "log1mexp":
        x = np.abs(x) + 1e-3           # defined for x > 0
    ref = np.asarray(JL.activation(name, x))
    out = TL.activation(name, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_table_is_every_shape_keeping_jax_function():
    """The table holds every `jax.nn` function that keeps its input's
    shape (the others reduce, halve, take two arrays or are no
    activation)."""
    others = {"dot_product_attention", "get_scaled_dot_general_config",
              "glu", "initializers", "logmeanexp", "logsumexp", "one_hot",
              "scaled_dot_general", "scaled_matmul"}
    names = {n for n in dir(jax.nn) if not n.startswith("_")} - others
    assert names <= set(TL.ACTIVATIONS)


@pytest.mark.parametrize("name", ["glu", "no_such_activation"])
def test_activation_outside_the_table_raises(name):
    with pytest.raises(ValueError, match=name):
        TL.activation(name, torch.zeros(4, 6))
