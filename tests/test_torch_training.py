"""The port's training slice against the JAX package on the CPU: losses and
metrics, the optimizers, the model's gradients of the ZINC loss through each
layer path, a short Adam trajectory, the random draws, and the trainer's
entry point.

Tolerances: metrics and optimizer updates 1e-6 (f32, the same formulas);
model gradients 1e-4, as the forward (`tests/test_torch_model.py`), on
gradients of magnitude up to ~1; the 3-step trajectory 1e-5 on losses and
parameters (Adam moves each parameter by ~lr = 1e-3 a step, so a gradient
difference at f32 noise moves it by far less), except for elements whose
exact gradient is 0 (the key bias, as softmax is invariant to a shift of
all logits; the last layer's edge-bias bias, whose edge output no loss
reads): there both sides get rounding noise, which Adam normalises to a step
of up to lr either way, so they are held to 3 lr. The random draws cannot
match JAX's bits (different generators), so the model comparisons run with
the draws off and the draws are tested by their statistics and fixed
vectors.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egt_torch import schemes, synthetic, weights
from egt_torch.models.egt import egt_attention_core
from egt_torch.ops import rng as trng
from egt_torch.training import metrics as tm
from egt_torch.training import optim as topt
from egt_torch.training.steps import load_trainer
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training import metrics as jm
from egt_tpu.training import optim as jopt
from tests.test_model_forward import random_zinc_batch, small_cfg
from tests.test_torch_model import PATHS, jax_params, port_model

REPO = Path(__file__).resolve().parents[1]
CONFIG_100K = REPO / "configs" / "main" / "zinc" / "100k" / "egt.json"


# ----------------------------------------------------------- losses, metrics


def _pairs_close(got, ref, tol=1e-6):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=tol, atol=tol)


def test_mae_loss_matches_jax():
    rng = np.random.default_rng(0)
    pred, target = rng.normal(size=(2, 6, 3)).astype(np.float32)
    mask = rng.random((6, 3)) > 0.3
    smask = np.array([1, 1, 0, 1, 1, 0], np.float32)
    for m, sm in ((None, None), (mask, None), (None, smask), (mask, smask)):
        got = tm.mae_loss(torch.from_numpy(pred), torch.from_numpy(target),
                          None if m is None else torch.from_numpy(m),
                          None if sm is None else torch.from_numpy(sm))
        _pairs_close(got, jm.mae_loss(pred, target, m, sm))


def test_sparse_xent_and_accuracy_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(5, 7, 4)).astype(np.float32)
    target = rng.integers(0, 4, (5, 7))
    mask = rng.random((5, 7)) > 0.2
    smask = np.array([1, 0, 1, 1, 1], np.float32)
    cw = tm.class_weights_from_sizes([10, 3, 5, 1])
    np.testing.assert_allclose(cw, jm.class_weights_from_sizes([10, 3, 5, 1]))
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    for w in (None, cw):
        _pairs_close(tm.sparse_xent_loss(tp, tt, torch.from_numpy(mask),
                                         torch.from_numpy(smask), w),
                     jm.sparse_xent_loss(pred, target, mask, smask, w), 1e-5)
    _pairs_close(tm.accuracy(tp, tt, torch.from_numpy(mask)),
                 jm.accuracy(pred, target, mask))


def test_metric_accumulator_matches_jax():
    pairs = [{"mae": (3.0, 2.0), "loss": (1.0, 1.0)},
             {"mae": (1.5, 4.0), "loss": (0.5, 1.0)}]
    a, b = tm.MetricAccumulator(), jm.MetricAccumulator()
    for p in pairs:
        a.update(p)
        b.update(p)
    assert a.result() == b.result()
    a.reset()
    assert a.result() == {}


# ---------------------------------------------------------------- optimizers


@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", ["adam", "rmsprop", "sgd"])
def test_optimizer_matches_optax(name, clip):
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = jopt.make_optimizer(name, 1e-2, clip, jp)
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt_ = topt.make_optimizer(tp.values(), name, 1e-2, clip)
    for i, g in enumerate(grads):
        lr = 1e-2 / (1 + i)                    # the host writes it each step
        state = jopt.set_learning_rate(state, lr)
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.set_learning_rate(topt_, lr)
        assert topt.get_learning_rate(topt_) == pytest.approx(lr)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt_.step()
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_optimizer_leaves_unreached_parameters():
    p = [torch.ones(3), torch.ones(2)]
    opt = topt.make_optimizer(p, "adam", 0.1)
    p[0].grad = torch.ones(3)
    opt.step()                                 # p[1].grad is None
    assert torch.equal(p[1], torch.ones(2)) and not torch.equal(
        p[0], torch.ones(3))
    assert topt.trainable([("x.moving_mean", p[0]), ("x.gamma", p[1])]) == [p[1]]


# ------------------------------------------------------- the model's gradients

GRAD_PATHS = ["whole_layer_kernel", "attention_kernel", "plain"]


def _zinc_loss_jax(jcfg):
    """jit(value_and_grad) of the JAX model's ZINC loss: fn(params, batch)."""
    model = JModel(jcfg)

    def loss_fn(p, batch):
        out, _ = model.apply(p, batch, training=True,
                             rng=jax.random.PRNGKey(0))
        s, c = jm.mae_loss(out, batch["target"])
        return s / jnp.maximum(c, 1.0)

    return jax.jit(jax.value_and_grad(loss_fn))


def _zinc_loss_port(model, batch):
    out = model(batch, training=True, seeds=[1, 2])
    return schemes.loss_and_metrics(out, torch.from_numpy(batch["target"]),
                                    model.output_mask(batch), None)[0]


@pytest.mark.parametrize("path", GRAD_PATHS)
def test_model_grads_match_jax(path):
    jcfg = small_cfg(**PATHS[path])
    params = jax_params(jcfg)
    batch = random_zinc_batch(np.random.default_rng(6), b=4, l=12)
    loss_j, grads_j = _zinc_loss_jax(jcfg)(params, batch)
    model = port_model(jcfg, jckpt._flatten_params(params))
    loss_t = _zinc_loss_port(model, batch)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    flat_j = jckpt._flatten_params(grads_j)
    for name, p in weights.flat_names(model).items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, flat_j[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_adam_trajectory_matches_jax():
    jcfg = small_cfg(**PATHS["plain"])
    params = jax_params(jcfg, seed=3)
    rng = np.random.default_rng(7)
    batches = [random_zinc_batch(rng, b=4, l=12) for _ in range(3)]
    opt = jopt.make_optimizer("adam", 1e-3, None, params)
    state = opt.init(params)
    model = port_model(jcfg, jckpt._flatten_params(params))
    topt_ = topt.make_optimizer(model.parameters(), "adam", 1e-3)
    gmax = {}
    step_j = _zinc_loss_jax(jcfg)
    for batch in batches:
        loss_j, g = step_j(params, batch)
        for k, x in jckpt._flatten_params(g).items():
            gmax[k] = np.maximum(gmax.get(k, 0.0), np.abs(x))
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        topt_.zero_grad()
        loss_t = _zinc_loss_port(model, batch)
        loss_t.backward()
        topt_.step()
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5,
                                   atol=1e-5)
    flat_j = jckpt._flatten_params(params)
    n_noise = 0
    for name, p in weights.flat_names(model).items():
        got, ref = p.detach().numpy(), flat_j[name]
        # exact gradient 0, rounding noise in its place (a gradient that is
        # 0 in f32 too, like the last layer's edge tail, moves neither side)
        noise = (gmax[name] > 0) & (gmax[name] < 1e-6)
        n_noise += int(noise.sum())
        np.testing.assert_allclose(got[noise], ref[noise], atol=3e-3,
                                   err_msg=name)
        np.testing.assert_allclose(got[~noise], ref[~noise], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the key biases (2 x 16) and the last layer's edge-bias bias (4), at most
    assert n_noise <= 2 * jcfg.model_width + jcfg.num_heads


# ------------------------------------------------------------------ the draws


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    m = 0xFFFFFFFF
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((m, m, m, m), (m, m),
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = trng.philox4x32(*ctr, *key)
        assert tuple(int(w) for w in got) == want


def test_draws_are_keyed_by_seed_pair_and_draw():
    shape = (3, 12, 12, 4)
    u = trng.pair_uniform(11, shape, trng.RANDOM_MASK, "cpu")
    assert torch.equal(u, trng.pair_uniform(11, shape, trng.RANDOM_MASK, "cpu"))
    assert u.dtype == torch.float32 and 0 <= u.min() and u.max() < 1
    for other in (trng.pair_uniform(12, shape, trng.RANDOM_MASK, "cpu"),
                  trng.pair_uniform(11, shape, trng.DROPOUT, "cpu"),
                  trng.pair_uniform(trng.fold_seed(5, 1001), shape, 0, "cpu")):
        assert (u != other).float().mean() > 0.99
    # the head-major grid draws the same bit for the same (b, i, j, head)
    hm = trng.pair_uniform(11, (3, 4, 12, 12), 0, "cpu", head_major=True)
    assert torch.equal(hm.permute(0, 2, 3, 1), u)
    # per-layer seeds of one step differ, and so do one layer's across steps
    seeds = {trng.fold_seed(s, step, 1000 + i) for s in (7,) for step in
             range(3) for i in range(10)}
    assert len(seeds) == 30


@pytest.mark.parametrize("kind", ["random_mask_prob", "attn_dropout"])
def test_draw_rates_match_their_probability(kind):
    """The share of valid (b, i, j, head) that the random mask (or dropout)
    zeroes in the plain attention core is within 3 sigma of p."""
    p = 0.1
    rng = np.random.default_rng(4)
    b, l, d, h = 8, 24, 4, 4
    q, k, v = (torch.from_numpy(rng.normal(size=(b, l, d, h)).astype(
        np.float32)) for _ in range(3))
    e = torch.from_numpy(rng.normal(size=(b, l, l, h)).astype(np.float32))
    n = rng.integers(6, l + 1, size=b)
    mask = torch.from_numpy(np.arange(l)[None] < n[:, None])
    out = egt_attention_core(q, k, v, e, None, node_mask=mask, training=True,
                             seed=9, **{kind: p})
    valid = mask[:, None, :, None].expand(b, l, l, h)
    share = float((out.a_tild[valid] == 0).float().mean())
    sigma = (p * (1 - p) / int(valid.sum())) ** 0.5
    assert abs(share - p) < 3 * sigma, (share, sigma)


def test_dropout_share_scale_and_seed():
    """Inverted dropout (`egt_tpu/models/layers.py::dropout`): the dropped
    share within 3 sigma of the rate, kept values scaled by 1 / (1 - rate),
    the same seed the same mask, and no change outside training."""
    from egt_torch.models.layers import dropout
    x = torch.ones(64, 256)
    y = dropout(x, 0.25, True, 5)
    share = float((y == 0).float().mean())
    assert abs(share - 0.25) < 3 * (0.25 * 0.75 / x.numel()) ** 0.5
    assert torch.all((y == 0) | (y == 1 / 0.75))
    assert torch.equal(y, dropout(x, 0.25, True, 5))
    assert not torch.equal(y, dropout(x, 0.25, True, 6))
    assert dropout(x, 0.25, False, None) is x
    with pytest.raises(ValueError):
        dropout(x, 0.25, True, None)


# ---------------------------------------------------------- the entry point


def _small_run_config():
    raw = json.loads(CONFIG_100K.read_text())
    raw.update(model_height=1, compute_dtype="float32")
    return raw


def test_load_trainer_needs_a_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        load_trainer(_small_run_config())


def test_load_trainer_on_cpu_takes_steps():
    raw = _small_run_config()
    cfg = schemes.model_config_from_config(raw)
    flat = synthetic.random_flat_params(cfg, seed=1)
    trainer = load_trainer(raw, flat, device="cpu")
    batch = synthetic.zinc_batch(np.random.default_rng(0), 6)
    assert dataclasses.asdict(trainer.model.cfg) == dataclasses.asdict(cfg)
    first = trainer.eval_step(batch)
    losses = [trainer.train_step(batch)["loss"] for _ in range(5)]
    assert set(first) == {"loss", "mae"} and np.all(np.isfinite(losses))
    # the training losses see the random mask (p 0.1); evaluation does not
    assert trainer.eval_step(batch)["loss"] < first["loss"]
    after = trainer.flat_params()
    assert sorted(after) == sorted(flat)
    assert not np.allclose(after["target/kernel"], flat["target/kernel"])
