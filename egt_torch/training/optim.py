"""Optimizer construction.

Port of `egt_tpu/training/optim.py` (the reference's
`TrainingBase.get_optimizer`): adam / rmsprop / sgd with the Keras eps 1e-7,
optional element-wise gradient value clipping (`optax.clip`), a learning
rate the host writes each step, and the trainable mask (BatchNorm moving
statistics are left to the forward pass).

- Adam: `torch.optim.Adam(eps=1e-7)` has optax's form (eps outside the
  square root of the bias-corrected second moment).
- RMSprop: optax's `rmsprop(lr, eps=1e-7)` decays with 0.9 and puts eps
  INSIDE the square root, `g / sqrt(nu + eps)`; `torch.optim.RMSprop`
  (alpha 0.99, eps outside) is another function, so `RMSprop` below is
  written out.
- SGD: plain `-lr * g`.

A parameter whose gradient is None (no loss reaches it, like
`edge_norm_final` under a graph readout) is left unchanged, as optax's zero
gradient leaves it under all three.
"""

from __future__ import annotations

import torch

NON_TRAINABLE_KEYS = ("moving_mean", "moving_var")


def trainable(named_params) -> list:
    """The parameters an optimizer updates: all but the BatchNorm moving
    statistics (named by their last key)."""
    return [p for name, p in named_params
            if name.replace("/", ".").rsplit(".", 1)[-1]
            not in NON_TRAINABLE_KEYS]


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop: nu = decay nu + (1 - decay) g^2;
    p -= lr g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1.0 - group["decay"])
                p.sub_(group["lr"] * p.grad / torch.sqrt(nu + group["eps"]))


class Optimizer:
    """An optimizer over `params` with optional value clipping of the
    gradients before each step."""

    def __init__(self, inner: torch.optim.Optimizer,
                 clip_value: float | None = None):
        self.inner = inner
        self.clip_value = clip_value

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        if self.clip_value is not None:
            for group in self.inner.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.clamp_(-self.clip_value, self.clip_value)
        self.inner.step()


def make_optimizer(params, name: str = "adam", learning_rate: float = 5e-4,
                   clip_value: float | None = None) -> Optimizer:
    """`params`: the trainable parameters (see `trainable`)."""
    name = name.lower()
    params = list(params)
    if name == "adam":
        inner = torch.optim.Adam(params, lr=learning_rate, eps=1e-7)
    elif name == "rmsprop":
        inner = RMSprop(params, lr=learning_rate, eps=1e-7)
    elif name == "sgd":
        inner = torch.optim.SGD(params, lr=learning_rate)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(inner, clip_value)


def set_learning_rate(opt: Optimizer, lr: float) -> None:
    for group in opt.inner.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(opt: Optimizer) -> float:
    return float(opt.inner.param_groups[0]["lr"])
