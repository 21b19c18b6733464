"""Kinematic bicycle (Dubins car with steering dynamics), explicit Euler.

State = [x, y, heading, speed, steer], input = [accel, steer_rate]:

    x' = x + h * [v cos(heading), v sin(heading), v tan(steer), a, w].
"""
import torch

from .base import System


def make_bicycle(h: float = 0.1) -> System:
    def step(x, u):
        heading, v, steer = x[..., 2], x[..., 3], x[..., 4]
        dxdt = torch.stack([v * torch.cos(heading), v * torch.sin(heading),
                            v * torch.tan(steer), u[..., 0], u[..., 1]],
                           dim=-1)
        return x + h * dxdt

    return System(name="bicycle", dim_x=5, dim_u=2, h=h, step=step)
