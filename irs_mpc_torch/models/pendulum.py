"""Pendulum: 2-state torque-driven pendulum, semi-implicit Euler.

State = [angle, speed], input = [torque], gravity normalised to 1:

    speed' = speed + h * (-sin(angle) + u)
    angle' = angle + h * speed'
"""
import torch

from .base import System


def make_pendulum(h: float = 0.05) -> System:
    def step(x, u):
        angle, speed = x[..., 0], x[..., 1]
        next_speed = speed + h * (-torch.sin(angle) + u[..., 0])
        next_angle = angle + h * next_speed
        return torch.stack([next_angle, next_speed], dim=-1)

    return System(name="pendulum", dim_x=2, dim_u=1, h=h, step=step)
