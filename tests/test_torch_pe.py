"""The port's input features against the JAX package on the CPU: the
masked dense embedding (MNIST / CIFAR10 inputs), the distance objective's
targets, and the SVD and eigenvector positional encodings with the sign
flips off (both `transform` values), each within 1e-6 of
`egt_tpu/models/features.py`; then the port's sign flips by their
statistics (one a (graph, feature), shared by U and V and by every node,
each -1 with probability 1/2) and their determinism: equal seeds give
equal flips, on the plain and the whole-layer kernel paths alike."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch.models import features as tf
from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_tpu.models import features as jf
from tests.test_model_forward import small_cfg

RNG = np.random.default_rng(0)


def _dense_params(i, o, seed):
    r = np.random.default_rng(seed)
    return {"kernel": r.normal(size=(i, o)).astype(np.float32),
            "bias": r.normal(size=(o,)).astype(np.float32)}


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def test_masked_dense_embed_matches_jax():
    x = RNG.uniform(0, 1, (3, 10, 5)).astype(np.float32)
    x[:, 7:] = -1.0                     # padding rows
    x[0, 2, :2] = -1.0                  # a row with some features at -1
    p = _dense_params(5, 16, 1)
    got = tf.masked_dense_embed(_t(p), torch.from_numpy(x)).numpy()
    ref = np.asarray(jf.masked_dense_embed(p, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, 7:], np.broadcast_to(p["bias"],
                                                           got[:, 7:].shape))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_distance_targets_match_jax(k):
    adj = (RNG.random((3, 12, 12)) < 0.2).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1))
    adj[:, np.arange(12), np.arange(12)] = 1.0
    adj[2, 9:] = adj[2, :, 9:] = 0.0       # padding nodes
    got = tf.distance_targets(torch.from_numpy(adj), k).numpy()
    ref = np.asarray(jf.distance_targets(jnp.asarray(adj), k))
    np.testing.assert_array_equal(got, ref)
    assert got.max() <= k and got[2, 9:].max() == 0


@pytest.mark.parametrize("transform", [True, False], ids=["transform", "pad"])
@pytest.mark.parametrize("pe", ["svd", "eig"])
def test_positional_encoding_matches_jax(pe, transform):
    sel, width, k = 4, 16, 8
    if pe == "svd":
        x = RNG.normal(size=(3, 10, k, 2)).astype(np.float32)
        p = _dense_params(2 * sel, width, 2) if transform else None
        fn_t, fn_j = tf.process_svd, jf.process_svd
    else:
        x = RNG.normal(size=(3, 10, k)).astype(np.float32)
        p = _dense_params(sel, width, 3) if transform else None
        fn_t, fn_j = tf.process_eig, jf.process_eig
    kw = dict(sel=sel, model_width=width, transform=transform,
              random_neg=True, training=False)
    got = fn_t(None if p is None else _t(p), torch.from_numpy(x), **kw)
    ref = fn_j(p, jnp.asarray(x), **kw)
    assert got.shape == ref.shape == (3, 10, width)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def _svd_flips(seed, b=64, n=5, sel=8):
    """The signs process_svd applied to all-ones singular vectors:
    (b, n, sel) for U and for V."""
    ones = torch.ones((b, n, sel, 2))
    out = tf.process_svd(None, ones, sel=sel, model_width=2 * sel,
                         transform=False, random_neg=True, training=True,
                         seed=seed)
    return out[..., :sel], out[..., sel:]


def test_sign_flips_per_graph_and_feature():
    u, v = _svd_flips(7)
    assert torch.equal(u, v)                          # shared by U and V
    assert torch.equal(u, u[:, :1].expand_as(u))      # and by every node
    assert set(u.unique().tolist()) == {-1.0, 1.0}
    eig = tf.process_eig(None, torch.ones((64, 5, 8)), sel=8, model_width=8,
                         transform=False, random_neg=True, training=True,
                         seed=7)
    assert torch.equal(eig, eig[:, :1].expand_as(eig))
    # the rate over many seeds: 200 seeds x 64 graphs x 8 features
    flips = torch.stack([_svd_flips(s)[0][:, 0] for s in range(200)])
    n = flips.numel()
    rate = float((flips < 0).float().mean())
    assert abs(rate - 0.5) <= 4 * (0.25 / n) ** 0.5, rate
    # neither a graph nor a feature always flips alike
    assert 0 < float((flips[:, 0] < 0).float().mean()) < 1
    assert 0 < float((flips[:, :, 0] < 0).float().mean()) < 1
    # off at inference and without random_neg; a seed is needed in training
    ones = torch.ones((4, 5, 8, 2))
    for kw in (dict(training=False, random_neg=True),
               dict(training=True, random_neg=False)):
        out = tf.process_svd(None, ones, sel=8, model_width=16,
                             transform=False, seed=None, **kw)
        assert torch.equal(out, torch.ones((4, 5, 16)))
    with pytest.raises(ValueError, match="seed"):
        tf.process_svd(None, ones, sel=8, model_width=16, transform=False,
                       random_neg=True, training=True, seed=None)


def test_equal_seeds_give_equal_flips_on_both_paths():
    jcfg = small_cfg(node_input_kind="dense", node_feature_dim=3,
                     edge_input_kind="dense", edge_feature_dim=1,
                     num_targets=10, use_svd=True, transform_svd=True,
                     sel_svd_features=4, random_neg=True)
    b, l = 4, 12
    batch = {"node_features": RNG.uniform(0, 1, (b, l, 3)).astype(np.float32),
             "singular_vectors": RNG.normal(size=(b, l, 8, 2)).astype(
                 np.float32)}
    models = {}
    for path, kw in (("plain", dict(fused_layer=False)),
                     ("whole_layer_kernel", dict(fused_layer=True))):
        cfg = TCfg(**{**dataclasses.asdict(jcfg), **kw})
        models[path] = TModel(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    h = {p: m.embed_nodes(batch, training=True, pe_seed=11)
         for p, m in models.items()}
    assert torch.equal(h["plain"], h["whole_layer_kernel"])
    again = models["plain"].embed_nodes(batch, training=True, pe_seed=11)
    other = models["plain"].embed_nodes(batch, training=True, pe_seed=12)
    assert torch.equal(again, h["plain"]) and not torch.equal(other, again)
