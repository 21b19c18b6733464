"""Contact-rich example systems (quasistatic): the planar hand.

The counterpart of the JAX package's ``models/contact/systems.py``; the
other four factories of that module are carried over with
``convert.model_from_jax`` until they are ported with their goldens.
"""
from __future__ import annotations

import numpy as np

from . import geometry as geom
from .quasistatic import ContactPair, ModelInstance, QuasistaticModel


def make_planar_hand(h: float = 0.1, mu: float = 0.8) -> QuasistaticModel:
    """Two 2-link arms + free ball (Kp = [50, 25], h = 0.1, gravity -10;
    ball a circle of radius 0.25 at (0, 0.35)), dim_x = 7, dim_u = 4.

    At q0 = (arms at +-(pi/4, pi/4), ball at (0, 0.35)) both second links
    are horizontal rails at z = 0.05, so the ball rests there: rail radius
    0.05 + ball radius 0.25 puts its centre at z = 0.35."""
    ball = geom.FreeBody2D(idx_pos=(0, 1), idx_rot=2,
                           shapes=(geom.Circle((0., 0.), 0.25),))
    arm_l = geom.Arm2D(base=(-0.35, -0.1), link_lengths=(0.15 * np.sqrt(2.),
                                                         0.28),
                       joint_idx=(3, 4), radius=0.05, angle_offset=np.pi)
    arm_r = geom.Arm2D(base=(0.35, -0.1), link_lengths=(0.15 * np.sqrt(2.),
                                                        0.28),
                       joint_idx=(5, 6), radius=0.05, angle_offset=np.pi)
    ground = geom.StaticBody(shapes=(geom.HalfSpace((0.0, 1.0), 0.0),))
    pairs = [ContactPair(body_a=arm_i, body_b=0, shape_a=link, shape_b=0,
                         mu=mu)
             for arm_i in (1, 2) for link in (0, 1)]
    pairs.append(ContactPair(body_a=3, body_b=0, shape_a=0, shape_b=0,
                             mu=mu))
    return QuasistaticModel(
        name="planar_hand", h=h, nq=7,
        models=(
            ModelInstance("sphere", (0, 1, 2), actuated=False,
                          mass=(1.0, 1.0, 0.05)),
            ModelInstance("arm_left", (3, 4), actuated=True,
                          stiffness=(50.0, 25.0)),
            ModelInstance("arm_right", (5, 6), actuated=True,
                          stiffness=(50.0, 25.0)),
        ),
        bodies=(ball, arm_l, arm_r, ground), pairs=tuple(pairs),
        gravity=(0.0, -10.0))
