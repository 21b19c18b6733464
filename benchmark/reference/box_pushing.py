"""Box pushing for the reference, from the upstream example's setup
(``examples/box_pushing/box_pushing_setup.py``): a unit box (half extents
0.5; pose y, z, theta; masses 1, 1 and 0.17 as the quasi-dynamic
regulariser) pushed by a point hand (a circle of radius 0.1 at y, z;
stiffness 500 on both), gravity off, one hand-box contact."""
from __future__ import annotations

from .geometry import circle_box, jacobian, perp
from .quasistatic import QuasistaticReference


class Model(QuasistaticReference):
    masses = {0: 1.0, 1: 1.0, 2: 0.17}
    gravity_force = {}
    stiffness = {3: 500.0, 4: 500.0}

    def contacts(self, q):
        ey, ez = self.axes(q)
        hand, box = q[..., 3:5], q[..., 0:2]
        phi, p, n = circle_box(hand, 0.1, box, (0.5, 0.5), q[..., 2])
        J_hand = jacobian(q, {3: ey, 4: ez})
        J_box = jacobian(q, {0: ey, 1: ez, 2: perp(p - box)})
        return [(phi, p, n, J_hand, J_box)]
