"""Contact-rich example systems (quasistatic), the counterpart of the JAX
package's ``models/contact/systems.py``: the same bodies, shapes, pairs,
dof layout and stiffness values.

| system        | dim_x / dim_u | layout                                    |
|---------------|---------------|-------------------------------------------|
| planar_hand   | 7 / 4         | ball (y,z,th); arm_l (2); arm_r (2)       |
| box_pushing   | 5 / 2         | box (y,z,th); hand (y,z)                  |
| box_pivoting  | 5 / 2         | box (y,z,th); hand (y,z)  + wall, ground  |
| plate_pickup  | 8 / 5         | plate (y,z,th); gripper (y,z,th,f1,f2)    |
| carrots       | 45 / 5        | gripper (5); 20 pieces (y,z) each         |
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


def _box_and_hand():
    """A unit box (half extents 0.5) on a free body (y, z, th) and a point
    pusher, a circle of radius 0.1 on a free body (y, z)."""
    box = geom.FreeBody2D(idx_pos=(0, 1), idx_rot=2,
                          shapes=(geom.Box((0.5, 0.5)),))
    hand = geom.FreeBody2D(idx_pos=(3, 4), idx_rot=None,
                           shapes=(geom.Circle((0., 0.), 0.1),))
    return box, hand


def make_box_pushing(h: float = 0.1, mu: float = 0.3) -> QuasistaticModel:
    """Point pusher + 1 m box, gravity off (Kp = 500), dim_x = 5,
    dim_u = 2; one box-circle pair."""
    box, hand = _box_and_hand()
    return QuasistaticModel(
        name="box_pushing", h=h, nq=5,
        models=(
            ModelInstance("box", (0, 1, 2), actuated=False,
                          mass=(1.0, 1.0, 0.17)),
            ModelInstance("hand", (3, 4), actuated=True,
                          stiffness=(500.0, 500.0)),
        ),
        bodies=(box, hand),
        pairs=(ContactPair(body_a=1, body_b=0, mu=mu),),
        gravity=(0.0, 0.0))


def make_box_pivoting(h: float = 0.05, mu: float = 0.6) -> QuasistaticModel:
    """Box against a wall (y <= 1) on the ground (z >= 0) under gravity,
    very stiff pusher (Kp = 5e4), dim_x = 5, dim_u = 2: ground-box and
    wall-box (four corners each) and hand-box, 18 contact rows.  Opts into
    the canonical dual carry (``canon_warm_duals``), which keeps the warm
    chains of this stiff system on one trajectory family."""
    box, hand = _box_and_hand()
    world = geom.StaticBody(shapes=(
        geom.HalfSpace((0.0, 1.0), 0.0),       # ground z >= 0
        geom.HalfSpace((-1.0, 0.0), -1.0),     # wall  y <= 1
    ))
    pairs = (
        ContactPair(body_a=2, body_b=0, shape_a=0, shape_b=0, mu=mu),  # ground
        ContactPair(body_a=2, body_b=0, shape_a=1, shape_b=0, mu=mu),  # wall
        ContactPair(body_a=1, body_b=0, mu=mu),                        # hand
    )
    return QuasistaticModel(
        name="box_pivoting", h=h, nq=5,
        models=(
            ModelInstance("box", (0, 1, 2), actuated=False,
                          mass=(1.0, 1.0, 0.17)),
            ModelInstance("hand", (3, 4), actuated=True,
                          stiffness=(50000.0, 50000.0)),
        ),
        bodies=(box, hand, world), pairs=pairs, gravity=(0.0, -10.0),
        canon_warm_duals=True)


def make_plate_pickup(h: float = 0.1, mu: float = 0.9) -> QuasistaticModel:
    """Gripper (floating base + 2 prismatic capsule fingers) + plate on the
    ground, dim_x = 8, dim_u = 5."""
    plate = geom.FreeBody2D(idx_pos=(0, 1), idx_rot=2,
                            shapes=(geom.Box((0.4, 0.04)),))
    finger_l = geom.PrismaticFinger2D(
        idx_base_pos=(3, 4), idx_base_rot=5, idx_slide=6,
        axis=(1.0, 0.0), offset=(-0.3, 0.0), radius=0.04, length=0.25)
    finger_r = geom.PrismaticFinger2D(
        idx_base_pos=(3, 4), idx_base_rot=5, idx_slide=7,
        axis=(-1.0, 0.0), offset=(0.3, 0.0), radius=0.04, length=0.25)
    ground = geom.StaticBody(shapes=(geom.HalfSpace((0.0, 1.0), 0.0),))
    pairs = (
        ContactPair(body_a=1, body_b=0, mu=mu),   # finger_l vs plate
        ContactPair(body_a=2, body_b=0, mu=mu),   # finger_r vs plate
        ContactPair(body_a=3, body_b=0, mu=0.3),  # ground vs plate
    )
    return QuasistaticModel(
        name="plate_pickup", h=h, nq=8,
        models=(
            ModelInstance("plate", (0, 1, 2), actuated=False,
                          mass=(1.0, 1.0, 0.06)),
            ModelInstance("gripper", (3, 4, 5, 6, 7), actuated=True,
                          stiffness=(200.0, 200.0, 100.0, 400.0, 400.0)),
        ),
        bodies=(plate, finger_l, finger_r, ground),
        pairs=pairs, gravity=(0.0, -10.0))


def make_carrots(n_pieces: int = 20, h: float = 1.0,
                 mu: float = 0.4) -> QuasistaticModel:
    """Many-object pile: gripper (5 dof, two prismatic capsule fingers) +
    ``n_pieces`` round pieces (2 dof each), dim_x = 5 + 2n (45 for n=20):
    every piece against both fingers and the ground, and every pair of
    pieces."""
    ng = 5
    piece_r = 0.05
    models = [ModelInstance("gripper", tuple(range(ng)), actuated=True,
                            stiffness=(100.0, 100.0, 50.0, 200.0, 200.0))]
    finger_l = geom.PrismaticFinger2D(
        idx_base_pos=(0, 1), idx_base_rot=2, idx_slide=3,
        axis=(1.0, 0.0), offset=(-0.25, 0.0), radius=0.03, length=0.2)
    finger_r = geom.PrismaticFinger2D(
        idx_base_pos=(0, 1), idx_base_rot=2, idx_slide=4,
        axis=(-1.0, 0.0), offset=(0.25, 0.0), radius=0.03, length=0.2)
    ground = geom.StaticBody(shapes=(geom.HalfSpace((0.0, 1.0), 0.0),))
    bodies = [finger_l, finger_r, ground]
    pairs = []
    for k in range(n_pieces):
        i0 = ng + 2 * k
        bodies.append(geom.FreeBody2D(
            idx_pos=(i0, i0 + 1), idx_rot=None,
            shapes=(geom.Circle((0., 0.), piece_r),)))
        models.append(ModelInstance(f"carrot_{k}", (i0, i0 + 1),
                                    actuated=False, mass=(0.1, 0.1)))
        body_idx = 3 + k
        pairs += [ContactPair(body_a=a, body_b=body_idx, mu=mu)
                  for a in (0, 1, 2)]
    for a in range(n_pieces):
        for b in range(a + 1, n_pieces):
            pairs.append(ContactPair(body_a=3 + a, body_b=3 + b, mu=mu))
    return QuasistaticModel(
        name="carrots", h=h, nq=ng + 2 * n_pieces,
        models=tuple(models), bodies=tuple(bodies), pairs=tuple(pairs),
        gravity=(0.0, -10.0))
