"""The planar hand for the reference, from the upstream example's setup
(``examples/planar_hand/planar_hand_setup.py``): a ball (a circle of
radius 0.25; pose y, z, theta; masses 1, 1 and 0.05; gravity -10 on z)
between two 2-link arms (bases at (-0.35, -0.1) and (0.35, -0.1), links
0.15*sqrt(2) and 0.28 long as capsules of radius 0.05, angles measured
from +z; stiffness 50 and 25 on each arm's joints) over the ground z >= 0.
Contacts: each arm's two links against the ball, then the ground against
the ball."""
from __future__ import annotations

import math

import torch

from .geometry import capsule_circle, halfspace_circle, jacobian, perp
from .quasistatic import QuasistaticReference

LINKS = (0.15 * math.sqrt(2.0), 0.28)
ARMS = (((-0.35, -0.1), (3, 4)), ((0.35, -0.1), (5, 6)))


class Model(QuasistaticReference):
    masses = {0: 1.0, 1: 1.0, 2: 0.05}
    gravity_force = {1: -10.0}
    stiffness = {3: 50.0, 4: 25.0, 5: 50.0, 6: 25.0}

    def contacts(self, q):
        ey, ez = self.axes(q)
        ball = q[..., 0:2]

        def ball_jacobian(p):
            return jacobian(q, {0: ey, 1: ez, 2: perp(p - ball)})

        out = []
        for base, joints in ARMS:
            pts = [torch.tensor(base, dtype=q.dtype,
                                device=q.device).expand_as(ball)]
            angle = 0.0
            for j, length in zip(joints, LINKS):
                angle = angle + q[..., j]
                a = angle + math.pi
                pts.append(pts[-1] + length * torch.stack(
                    [torch.sin(a), -torch.cos(a)], dim=-1))
            for k in range(len(LINKS)):
                phi, p, n = capsule_circle(pts[k], pts[k + 1], 0.05, ball,
                                           0.25)
                J_link = jacobian(q, {joints[j]: perp(p - pts[j])
                                      for j in range(k + 1)})
                out.append((phi, p, n, J_link, ball_jacobian(p)))
        phi, p, n = halfspace_circle((0.0, 1.0), 0.0, ball, 0.25)
        out.append((phi, p, n, torch.zeros_like(ball_jacobian(p)),
                    ball_jacobian(p)))
        return out
