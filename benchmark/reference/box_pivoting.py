"""Box pivoting for the reference: the stiff pusher of the upstream
example (``examples/box_pivoting/box_pivoting_setup.py``, Kp = 5e4) in
the task that the JAX package's ``examples/box_pivoting.py`` rebuilds,
since the upstream's box and wall model files are not available: the
unit box of box pushing (half extents 0.5; pose y, z, theta; masses 1, 1
and 0.17) under gravity (-10 on z), on the ground z >= 0 and against a
wall y <= 1, pushed by a very stiff point hand (a circle of radius 0.1
at y, z; stiffness 5e4 on both).  Contacts, in the port's row order: the
ground against each of the box's four corners, the wall against each
corner, then the hand against the box.

The box's corners against a world-fixed half-space are written here, by
the same mathematics as the port's narrow phase: each corner is a point
contact with the signed distance n . p - offset and the half-space's
normal n (from the world into the box); the corners run (+,+), (-,+),
(-,-), (+,-) in the box's frame.  The warm chains carry each contact's
two duals as their mean (the port's canonical carry, ``canon_warm_duals``),
after the non-finite ones are sanitised.  No other departure: the step's
QP, its PDIP and its Jacobian are the shared ``QuasistaticReference``'s.
"""
from __future__ import annotations

import torch

from .geometry import circle_box, jacobian, perp, rotate
from .quasistatic import QuasistaticReference

HALF = (0.5, 0.5)
GROUND = ((0.0, 1.0), 0.0)      # z >= 0
WALL = ((-1.0, 0.0), -1.0)      # y <= 1


def corners(center, half, theta):
    """(..., 4, 2) world corners of an oriented box, in the order
    (+,+), (-,+), (-,-), (+,-) of its frame."""
    hy, hz = half
    local = torch.tensor([[hy, hz], [-hy, hz], [-hy, -hz], [hy, -hz]],
                         dtype=center.dtype, device=center.device)
    return center[..., None, :] + rotate(theta[..., None], local)


def halfspace_box(normal, offset, center, half, theta):
    """A world-fixed half-space {n . p >= offset} (A) against an oriented
    box (B): [(phi, p, n)] of its four corners."""
    n = torch.tensor(normal, dtype=center.dtype, device=center.device)
    pts = corners(center, half, theta)
    return [((n * pts[..., i, :]).sum(-1) - offset, pts[..., i, :],
             n.expand_as(pts[..., i, :])) for i in range(4)]


class Model(QuasistaticReference):
    masses = {0: 1.0, 1: 1.0, 2: 0.17}
    gravity_force = {1: -10.0}
    stiffness = {3: 5e4, 4: 5e4}

    def contacts(self, q):
        ey, ez = self.axes(q)
        hand, box, theta = q[..., 3:5], q[..., 0:2], q[..., 2]

        def box_jacobian(p):
            return jacobian(q, {0: ey, 1: ez, 2: perp(p - box)})

        out = []
        for normal, offset in (GROUND, WALL):
            for phi, p, n in halfspace_box(normal, offset, box, HALF, theta):
                J_box = box_jacobian(p)
                out.append((phi, p, n, torch.zeros_like(J_box), J_box))
        phi, p, n = circle_box(hand, 0.1, box, HALF, theta)
        out.append((phi, p, n, jacobian(q, {3: ey, 4: ez}), box_jacobian(p)))
        return out

    def step_warm(self, x, u, carry):
        """The warm-started step, its carried duals canonicalised: rows
        2c and 2c+1 of contact c both take their mean."""
        x_next, (dq, lam) = super().step_warm(x, u, carry)
        pairs = lam.reshape(lam.shape[:-1] + (lam.shape[-1] // 2, 2))
        canon = pairs.mean(-1, keepdim=True).expand(pairs.shape)
        return x_next, (dq, canon.reshape(lam.shape))
