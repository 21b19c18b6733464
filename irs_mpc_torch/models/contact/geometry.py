"""2D contact geometry: signed distances, contact frames, body kinematics.

The counterpart of the JAX package's ``models/contact/geometry.py``, in the
y-z plane, written over leading batch dimensions: a configuration is a
(..., nq) tensor, a point a (..., 2) tensor, and every function broadcasts
over the leading dims, so the same code serves one state, a batch, and
``torch.func`` transforms.  Shapes keep their parameters as plain Python
values; contact sets are enumerated statically from the pair list.

Conventions:
* a contact between shapes A and B returns (phi, p, n): signed distance
  (...,), world contact point (..., 2), unit normal (..., 2) from A into B;
* bodies expose ``point_jacobian(q, p) -> (..., 2, nq)``, the map from
  q-velocity to the world velocity of the body-fixed point now at p.  It is
  assembled from one-hot rows of the identity (no in-place writes), so that
  ``torch.func.jacfwd`` and ``vmap`` pass through it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _perp(v: Tensor) -> Tensor:
    """90-degree counter-clockwise rotation of (..., 2) vectors."""
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def _rot_apply(th: Tensor, v) -> Tensor:
    """R(th) @ v for angles (...,) and vectors (..., 2) or a pair of
    floats."""
    c, s = torch.cos(th), torch.sin(th)
    if isinstance(v, Tensor):
        vy, vz = v[..., 0], v[..., 1]
    else:
        vy, vz = float(v[0]), float(v[1])
    return torch.stack([c * vy - s * vz, s * vy + c * vz], dim=-1)


def _const(v, like: Tensor) -> Tensor:
    """The constant ``v`` (floats) as a tensor of ``like``'s dtype and
    device, made once and shared by every caller (never write to it): a
    copy from the host would wait on the device's queue at every call."""
    return _cached_const(tuple(map(float, v)), like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _cached_const(v, dtype, device) -> Tensor:
    return torch.tensor(v, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Shapes (parameters in body frame)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Circle:
    center: Tuple[float, float] = (0.0, 0.0)
    radius: float = 0.1


@dataclasses.dataclass(frozen=True)
class Capsule:
    p0: Tuple[float, float]
    p1: Tuple[float, float]
    radius: float = 0.05


@dataclasses.dataclass(frozen=True)
class Box:
    half: Tuple[float, float]
    center: Tuple[float, float] = (0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class HalfSpace:
    """Free space is n . p >= offset.  World-fixed (static bodies only)."""
    normal: Tuple[float, float]
    offset: float = 0.0


# ---------------------------------------------------------------------------
# Primitive distance queries (world-frame shape parameters)
# ---------------------------------------------------------------------------

def circle_circle(ca, ra, cb, rb):
    """Returns (phi, p, n): n from A to B."""
    delta = cb - ca
    dist = torch.sqrt((delta ** 2).sum(-1) + 1e-12)
    n = delta / dist[..., None]
    phi = dist - ra - rb
    p = ca + n * (ra + 0.5 * phi)[..., None]
    return phi, p, n


def segment_closest_point(p, a, b):
    """Closest point to p on segment ab."""
    ab = b - a
    t = torch.clamp(((p - a) * ab).sum(-1) / ((ab * ab).sum(-1) + 1e-12),
                    0.0, 1.0)
    return a + t[..., None] * ab


def capsule_circle(a0, a1, ra, cb, rb):
    """Capsule (segment a0-a1, radius ra) vs circle: n from capsule to
    circle."""
    cp = segment_closest_point(cb, a0, a1)
    return circle_circle(cp, ra, cb, rb)


def circle_halfspace(c, r, normal, offset):
    n_hs = _const(normal, c)
    phi = (n_hs * c).sum(-1) - offset - r
    p = c - n_hs * r
    # Normal from the half-space INTO the circle body.
    return phi, p, n_hs.expand_as(c)


def point_halfspace(p, normal, offset):
    n_hs = _const(normal, p)
    phi = (n_hs * p).sum(-1) - offset
    return phi, p, n_hs.expand_as(p)


def circle_box(c, r, box_center, box_half, box_theta):
    """Circle vs oriented box.  Returns (phi, p, n) with n from box to
    circle.  Outside: closest-point construction; inside: nearest-face
    pushout (ties pick the first axis, as ``argmin`` does)."""
    hy, hz = float(box_half[0]), float(box_half[1])
    half = _const((hy, hz), c)
    ct, st = torch.cos(box_theta), torch.sin(box_theta)
    dy, dz = c[..., 0] - box_center[..., 0], c[..., 1] - box_center[..., 1]
    local = torch.stack([ct * dy + st * dz, -st * dy + ct * dz], dim=-1)
    clamped = torch.maximum(torch.minimum(local, half), -half)
    delta_out = local - clamped
    dist_out = torch.sqrt((delta_out ** 2).sum(-1) + 1e-12)
    inside = (local.abs() < half).all(-1)

    n_out = delta_out / dist_out[..., None]
    face = half - local.abs()                        # (..., 2)
    axis0 = face[..., 0] <= face[..., 1]
    sgn = torch.sign(local) + (local == 0.0).to(local.dtype)
    zero = torch.zeros_like(face[..., 0])
    n_in = torch.stack([torch.where(axis0, sgn[..., 0], zero),
                        torch.where(axis0, zero, sgn[..., 1])], dim=-1)
    face_min = torch.minimum(face[..., 0], face[..., 1])
    phi = torch.where(inside, -face_min - r, dist_out - r)
    n_local = torch.where(inside[..., None], n_in, n_out)
    p_local = torch.where(inside[..., None], local + n_in * face_min[..., None],
                          clamped)
    n = _rot_apply(box_theta, n_local)
    p = box_center + _rot_apply(box_theta, p_local)
    return phi, p, n


def box_corners(box_center, box_half, box_theta):
    """(..., 4, 2) world corners of an oriented box, in the order
    (+,+), (-,+), (-,-), (+,-)."""
    hy, hz = float(box_half[0]), float(box_half[1])
    corners = [box_center + _rot_apply(box_theta, (ly, lz))
               for ly, lz in ((hy, hz), (-hy, hz), (-hy, -hz), (hy, -hz))]
    return torch.stack(corners, dim=-2)


# ---------------------------------------------------------------------------
# Bodies
# ---------------------------------------------------------------------------

def _unit(q: Tensor, i: int) -> Tensor:
    """The one-hot row e_i of length nq, on q's device (made once and
    shared, as ``_const``)."""
    return _cached_unit(q.shape[-1], i, q.dtype, q.device)


@functools.lru_cache(maxsize=None)
def _cached_unit(n: int, i: int, dtype, device) -> Tensor:
    return torch.eye(n, dtype=dtype, device=device)[i]


def _jac(q: Tensor, terms) -> Tensor:
    """(..., 2, nq) Jacobian from ``terms``, a list of (coefficient (..., 2)
    or a pair of floats, q index): column i gets the coefficient."""
    J = torch.zeros(q.shape[:-1] + (2, q.shape[-1]), dtype=q.dtype,
                    device=q.device)
    for coef, i in terms:
        if not isinstance(coef, Tensor):
            coef = _const(coef, q)
        J = J + coef[..., :, None] * _unit(q, i)
    return J


class BodyBase:
    """Static config objects; all q-dependent math happens in methods."""
    shapes: tuple

    def point_jacobian(self, q: Tensor, p: Tensor) -> Tensor:
        raise NotImplementedError

    def world_shapes(self, q: Tensor):
        """Returns a list of (shape_kind, params...) in world frame."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StaticBody(BodyBase):
    """World-fixed geometry (grounds, walls)."""
    shapes: tuple = ()

    def point_jacobian(self, q, p):
        return _jac(q, [])

    def world_shapes(self, q):
        out = []
        for s in self.shapes:
            if isinstance(s, HalfSpace):
                out.append(("halfspace", tuple(map(float, s.normal)),
                            float(s.offset)))
            elif isinstance(s, Circle):
                out.append(("circle", _const(s.center, q), float(s.radius)))
            elif isinstance(s, Capsule):
                out.append(("capsule", _const(s.p0, q), _const(s.p1, q),
                            float(s.radius)))
            elif isinstance(s, Box):
                out.append(("box", _const(s.center, q), tuple(s.half),
                            torch.zeros_like(q[..., 0])))
            else:
                raise TypeError(s)
        return out


@dataclasses.dataclass(frozen=True)
class FreeBody2D(BodyBase):
    """Rigid body with pose (y, z[, theta]) read from q at given indices."""
    idx_pos: Tuple[int, int]
    idx_rot: Optional[int] = None
    shapes: tuple = ()

    def _pose(self, q):
        c = torch.stack([q[..., self.idx_pos[0]], q[..., self.idx_pos[1]]],
                        dim=-1)
        th = (q[..., self.idx_rot] if self.idx_rot is not None
              else torch.zeros_like(q[..., 0]))
        return c, th

    def point_jacobian(self, q, p):
        terms = [((1.0, 0.0), self.idx_pos[0]), ((0.0, 1.0), self.idx_pos[1])]
        if self.idx_rot is not None:
            c, _ = self._pose(q)
            terms.append((_perp(p - c), self.idx_rot))
        return _jac(q, terms)

    def world_shapes(self, q):
        c, th = self._pose(q)
        out = []
        for s in self.shapes:
            if isinstance(s, Circle):
                out.append(("circle", c + _rot_apply(th, s.center),
                            float(s.radius)))
            elif isinstance(s, Capsule):
                out.append(("capsule", c + _rot_apply(th, s.p0),
                            c + _rot_apply(th, s.p1), float(s.radius)))
            elif isinstance(s, Box):
                out.append(("box", c + _rot_apply(th, s.center),
                            tuple(s.half), th))
            else:
                raise TypeError(s)
        return out


@dataclasses.dataclass(frozen=True)
class Arm2D(BodyBase):
    """Planar revolute chain anchored at ``base``; joint angles from q.

    Link k is a capsule from joint k to joint k+1 (absolute angle =
    cumulative sum of joint angles, first measured from -z like a hanging
    arm; positive = counter-clockwise)."""
    base: Tuple[float, float]
    link_lengths: Tuple[float, ...]
    joint_idx: Tuple[int, ...]
    radius: float = 0.05
    # Added to the cumulative angle: 0 = hanging (-z); pi = pointing up.
    angle_offset: float = 0.0

    def _joint_positions(self, q):
        """[base, joint 2, ..., tip], each (..., 2)."""
        acc = None
        pts = [_const(self.base, q).expand(q.shape[:-1] + (2,))]
        for k, l in enumerate(self.link_lengths):
            a = q[..., self.joint_idx[k]]
            acc = a if acc is None else acc + a
            ang = acc + float(self.angle_offset)
            d = torch.stack([torch.sin(ang), -torch.cos(ang)], dim=-1) \
                * float(l)
            pts.append(pts[-1] + d)
        return pts

    def link_segment(self, q, k):
        pts = self._joint_positions(q)
        return pts[k], pts[k + 1]

    def point_jacobian_link(self, q, p, k):
        """Jacobian for a point attached to link k (0-based)."""
        pts = self._joint_positions(q)
        return _jac(q, [(_perp(p - pts[j]), self.joint_idx[j])
                        for j in range(k + 1)])

    def point_jacobian(self, q, p):
        raise RuntimeError(
            "Arm2D needs the link index; use point_jacobian_link.")

    def world_shapes(self, q):
        pts = self._joint_positions(q)
        return [("capsule", pts[k], pts[k + 1], float(self.radius))
                for k in range(len(self.link_lengths))]


@dataclasses.dataclass(frozen=True)
class PrismaticFinger2D(BodyBase):
    """A finger shape on a prismatic slide attached to a floating base:
        p = base_pos + R(theta) (offset + q[idx_slide] * axis)."""
    idx_base_pos: Tuple[int, int]
    idx_base_rot: Optional[int]
    idx_slide: int
    axis: Tuple[float, float]          # slide axis in base frame
    offset: Tuple[float, float]        # finger rest offset in base frame
    radius: float = 0.04
    length: float = 0.0                # >0: capsule hanging down

    def _frame(self, q):
        c = torch.stack([q[..., self.idx_base_pos[0]],
                         q[..., self.idx_base_pos[1]]], dim=-1)
        th = (q[..., self.idx_base_rot] if self.idx_base_rot is not None
              else torch.zeros_like(q[..., 0]))
        return c, th

    def _tip(self, q):
        c, th = self._frame(q)
        slide = q[..., self.idx_slide]
        local = torch.stack([float(self.offset[0]) + slide
                             * float(self.axis[0]),
                             float(self.offset[1]) + slide
                             * float(self.axis[1])], dim=-1)
        return c + _rot_apply(th, local), th

    def point_jacobian(self, q, p):
        c, th = self._frame(q)
        terms = [((1.0, 0.0), self.idx_base_pos[0]),
                 ((0.0, 1.0), self.idx_base_pos[1])]
        if self.idx_base_rot is not None:
            terms.append((_perp(p - c), self.idx_base_rot))
        terms.append((_rot_apply(th, self.axis), self.idx_slide))
        return _jac(q, terms)

    def world_shapes(self, q):
        tip, th = self._tip(q)
        if self.length > 0:
            # Capsule hanging straight down in the base frame.
            d = _rot_apply(th, (0.0, -float(self.length)))
            return [("capsule", tip, tip + d, float(self.radius))]
        return [("circle", tip, float(self.radius))]


# ---------------------------------------------------------------------------
# Pairwise narrow-phase dispatch
# ---------------------------------------------------------------------------

def shape_contact(sa, sb):
    """Contact between two world-frame shapes -> list of (phi, p, n).

    n points from shape A into shape B.  Multi-contact pairs (box vs
    halfspace) return several entries; the count is static."""
    ka, kb = sa[0], sb[0]
    if ka == "circle" and kb == "circle":
        return [circle_circle(sa[1], sa[2], sb[1], sb[2])]
    if ka == "capsule" and kb == "circle":
        return [capsule_circle(sa[1], sa[2], sa[3], sb[1], sb[2])]
    if ka == "circle" and kb == "capsule":
        phi, p, n = capsule_circle(sb[1], sb[2], sb[3], sa[1], sa[2])
        return [(phi, p, -n)]
    if ka == "halfspace" and kb == "circle":
        return [circle_halfspace(sb[1], sb[2], sa[1], sa[2])]
    if ka == "circle" and kb == "halfspace":
        phi, p, n = circle_halfspace(sa[1], sa[2], sb[1], sb[2])
        return [(phi, p, -n)]
    if ka == "halfspace" and kb == "capsule":
        return [circle_halfspace(end, sb[3], sa[1], sa[2])
                for end in (sb[1], sb[2])]
    if ka == "box" and kb == "circle":
        return [circle_box(sb[1], sb[2], sa[1], sa[2], sa[3])]
    if ka == "circle" and kb == "box":
        phi, p, n = circle_box(sa[1], sa[2], sb[1], sb[2], sb[3])
        return [(phi, p, -n)]
    if ka == "capsule" and kb == "box":
        # Approximate: test both capsule endpoints against the box.
        out = []
        for end in (sa[1], sa[2]):
            phi, p, n = circle_box(end, sa[3], sb[1], sb[2], sb[3])
            out.append((phi, p, -n))
        return out
    if ka == "box" and kb == "capsule":
        return [circle_box(end, sb[3], sa[1], sa[2], sa[3])
                for end in (sb[1], sb[2])]
    if ka == "halfspace" and kb == "box":
        corners = box_corners(sb[1], sb[2], sb[3])
        return [point_halfspace(corners[..., i, :], sa[1], sa[2])
                for i in range(4)]
    if ka == "box" and kb == "halfspace":
        corners = box_corners(sa[1], sa[2], sa[3])
        out = []
        for i in range(4):
            phi, p, n = point_halfspace(corners[..., i, :], sb[1], sb[2])
            out.append((phi, p, -n))
        return out
    raise NotImplementedError(f"contact pair {ka}-{kb}")
