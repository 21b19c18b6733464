"""Plain 2D contact geometry of the reference: the signed distance, contact
point and normal of the shape pairs the configurations use, and the point
Jacobians of their bodies, over leading batch dims.

Conventions (those of the upstream quasistatic model): a contact between
shapes A and B gives (phi, p, n) with n the unit normal from A into B; a
point Jacobian (..., 2, nq) maps the configuration's velocity to the world
velocity of the body-fixed point now at p.  Every function is elementwise,
so ``torch.func.jacfwd`` passes through it.
"""
from __future__ import annotations

import torch


def perp(v):
    """90-degree counter-clockwise rotation of (..., 2) vectors."""
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def rotate(th, v):
    """R(th) @ v for angles (...,) and vectors (..., 2)."""
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1]], dim=-1)


def circle_circle(ca, ra, cb, rb):
    """Circle A against circle B."""
    delta = cb - ca
    dist = torch.sqrt((delta ** 2).sum(-1) + 1e-12)
    n = delta / dist[..., None]
    phi = dist - ra - rb
    return phi, ca + n * (ra + 0.5 * phi)[..., None], n


def capsule_circle(a0, a1, ra, cb, rb):
    """Capsule A (segment a0-a1, radius ra) against circle B: the circle
    against the segment's closest point."""
    ab = a1 - a0
    t = torch.clamp(((cb - a0) * ab).sum(-1) / ((ab * ab).sum(-1) + 1e-12),
                    0.0, 1.0)
    return circle_circle(a0 + t[..., None] * ab, ra, cb, rb)


def halfspace_circle(normal, offset, c, r):
    """A world-fixed half-space {n . p >= offset} against circle B."""
    n = torch.tensor(normal, dtype=c.dtype, device=c.device)
    phi = (n * c).sum(-1) - offset - r
    return phi, c - n * r, n.expand_as(c)


def circle_box(c, r, center, half, theta):
    """Circle A against an oriented box B (centre, half extents, angle).
    Outside the box: the closest point; inside: the nearest face, ties to
    the first axis."""
    hy, hz = half
    halfv = torch.tensor([hy, hz], dtype=c.dtype, device=c.device)
    d = c - center
    local = torch.stack([torch.cos(theta) * d[..., 0]
                         + torch.sin(theta) * d[..., 1],
                         -torch.sin(theta) * d[..., 0]
                         + torch.cos(theta) * d[..., 1]], dim=-1)
    clamped = torch.maximum(torch.minimum(local, halfv), -halfv)
    delta_out = local - clamped
    dist_out = torch.sqrt((delta_out ** 2).sum(-1) + 1e-12)
    inside = (local.abs() < halfv).all(-1)
    n_out = delta_out / dist_out[..., None]
    face = halfv - local.abs()
    axis0 = face[..., 0] <= face[..., 1]
    sgn = torch.sign(local) + (local == 0.0).to(local.dtype)
    zero = torch.zeros_like(face[..., 0])
    n_in = torch.stack([torch.where(axis0, sgn[..., 0], zero),
                        torch.where(axis0, zero, sgn[..., 1])], dim=-1)
    face_min = torch.minimum(face[..., 0], face[..., 1])
    phi = torch.where(inside, -face_min - r, dist_out - r)
    n_local = torch.where(inside[..., None], n_in, n_out)
    p_local = torch.where(inside[..., None],
                          local + n_in * face_min[..., None], clamped)
    # The box's normal points from the box to the circle; A is the circle.
    return phi, center + rotate(theta, p_local), -rotate(theta, n_local)


def jacobian(q, columns):
    """(..., 2, nq) point Jacobian whose column i is ``columns[i]`` (a
    (..., 2) tensor) and zero elsewhere."""
    zero = torch.zeros_like(q[..., :2])
    cols = [columns.get(i, zero) for i in range(q.shape[-1])]
    return torch.stack(cols, dim=-1)


def contact_rows(pairs, q, mu):
    """The Anitescu rows of a list of contacts ``pairs``, each (phi, p, n,
    J_a, J_b): two rows (J_n +- mu J_t) per contact, with J = J_b - J_a
    taken along the normal n and the tangent perp(n).  Returns G (..., rows,
    nq) and phi (..., rows), the constraint set G dq >= -phi."""
    Gs, phis = [], []
    for phi, p, n, Ja, Jb in pairs:
        Jrel = Jb - Ja
        Jn = (n[..., :, None] * Jrel).sum(-2)
        Jt = (perp(n)[..., :, None] * Jrel).sum(-2)
        Gs += [Jn + mu * Jt, Jn - mu * Jt]
        phis += [phi, phi]
    return torch.stack(Gs, dim=-2), torch.stack(phis, dim=-1)
