"""Learned MLP dynamics: train a small MLP on random transitions of a true
system and wrap it as a ``System``.

The counterpart of the JAX package's ``models/mlp.py``: tanh hidden layers,
a residual output x + Linear(h), initialised as flax's ``Dense`` is
(LeCun-normal kernels from a truncated normal, zero biases), fitted by Adam
(whose defaults equal ``optax.adam``'s) on minibatches drawn by
``np.random.RandomState(seed)``.  Any estimator runs against the learned
system unchanged; its Jacobians come from ``torch.func.jacfwd``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from .base import System

Tensor = torch.Tensor

# The standard deviation of a unit normal truncated to [-2, 2]: flax's
# LeCun-normal divides by it so that the kernel has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class DynamicsMlp(nn.Module):
    """x_next = x + Linear(tanh(... tanh(Linear(xu)))) with ``hidden``
    widths, for xu = (x, u) of widths ``dim_x`` + ``dim_u``, built on
    ``device`` with its kernels drawn from ``generator`` (on that
    device)."""

    def __init__(self, hidden: Sequence[int], dim_x: int, dim_u: int,
                 generator: torch.Generator = None, device=None):
        super().__init__()
        self.dim_x = dim_x
        widths = [dim_x + dim_u] + list(hidden)
        self.hidden = nn.ModuleList(nn.Linear(a, b, device=device)
                                    for a, b in zip(widths, widths[1:]))
        self.out = nn.Linear(widths[-1], dim_x, device=device)
        with torch.no_grad():
            for layer in list(self.hidden) + [self.out]:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                layer.bias.zero_()

    def forward(self, xu: Tensor) -> Tensor:
        h = xu
        for layer in self.hidden:
            h = torch.tanh(layer(h))
        return xu[..., :self.dim_x] + self.out(h)


def fit_mlp(model: DynamicsMlp, XU: Tensor, Y: Tensor, epochs: int,
            batch: int, lr: float, seed: int) -> float:
    """``epochs`` Adam steps of the mean squared error on minibatches of
    ``batch`` rows of (XU, Y), the rows drawn with replacement by
    ``np.random.RandomState(seed)``.  Returns the last step's loss."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    rng = np.random.RandomState(seed)
    loss = None
    for _ in range(epochs):
        idx = torch.from_numpy(rng.randint(0, XU.shape[0], size=batch)).to(
            XU.device)
        loss = torch.mean((model(XU[idx]) - Y[idx]) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
    return loss.item()


def mlp_system(model: DynamicsMlp, system: System) -> System:
    """The frozen ``model`` as a ``System`` in place of ``system``."""
    model.requires_grad_(False)

    def step(x, u):
        return model(torch.cat([x, u], dim=-1))

    return System(name=f"{system.name}_mlp", dim_x=system.dim_x,
                  dim_u=system.dim_u, h=system.h, step=step)


def train_mlp_dynamics(system: System, num_transitions: int = 20_000,
                       hidden: Sequence[int] = (64, 64),
                       x_range: float = 4.0, u_range: float = 4.0,
                       epochs: int = 400, batch: int = 2048,
                       lr: float = 1e-3, seed: int = 0,
                       device="cuda") -> System:
    """Train an MLP on ``num_transitions`` one-step transitions of
    ``system`` from states and inputs drawn uniformly in +-``x_range`` and
    +-``u_range`` (a ``torch.Generator`` seeded with ``seed``), and return
    it as a System that carries the last training loss as
    ``final_loss``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    n, m = system.dim_x, system.dim_u

    def uniform(shape, half):
        return (2 * torch.rand(shape, generator=g, device=device) - 1) * half

    X = uniform((num_transitions, n), x_range)
    U = uniform((num_transitions, m), u_range)
    Y = system.step_batch(X, U)
    model = DynamicsMlp(hidden, n, m, generator=g, device=device)
    loss = fit_mlp(model, torch.cat([X, U], dim=1), Y, epochs, batch, lr,
                   seed)
    sys_nn = mlp_system(model, system)
    # System is frozen; the training loss rides along for diagnostics.
    object.__setattr__(sys_nn, "final_loss", loss)
    return sys_nn
