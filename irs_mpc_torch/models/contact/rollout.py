"""The whole line-searched contact rollout chain: host tables and the plain
version of kernel K4.

The forward pass of a contact iteration is a serial chain: T knots, each
the feedback law, the input clips, the contact narrow phase and row
assembly, and one warm-started PDIP solve, for every line-search lane.  On
CUDA tensors the solver runs it as one launch of K4
(``cuda_rollout.linesearch_rollout_cuda``, the system's ``ls_rollout_fn``);
``linesearch_rollout_plain`` is the same chain as lane-batched tensor code,
the kernel's plain version.  On CPU tensors the solver's own line-search
loop runs the warm chain (``step_ws``), which the tests hold to this one.

Both walk the same flattened description of the model (``make_consts``):
for every contact pair, its first row and contact count, then one record
per side naming the shape kind, the body kind and its indices and
parameters.  The plain assembly below reads that table exactly as the
kernel does, so the CPU tests check the table too.

Scope (``supports_model``, the JAX package's whole-chain kernel's): Anitescu
models whose pairs are one of the eleven kinds of ``_PAIR_KINDS``, over
circles, capsules, centred boxes and halfspaces, on a StaticBody, a
FreeBody2D (circles and boxes centred on the body), an Arm2D (each link a
capsule) or a PrismaticFinger2D (a capsule, or a circle at length 0).  A
circle or capsule against a box, and a box against a halfspace, give
several contacts (a capsule's two ends; a box's four corners), each with
its two rows.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as geom
from .qp import MU_FLOOR, W_CAP
from ...ops.linalg import solve_spd

Tensor = torch.Tensor

# Table layout, shared with csrc/rollout.cu.  Per side:
#   ints   shape, body, i0, i1, i2, i3
#   floats radius, v0, v1, s, base y, base z, angle offset
# by body kind:
#   static     circle: (v0, v1) centre; halfspace: (v0, v1) normal, s offset
#   free       (i0, i1) position, i2 rotation or -1; box: (v0, v1) half
#              extents
#   arm        i0 link index k, i3 the arm's first record in the link
#              table; base, angle offset
#   finger     (i0, i1) base position, i2 base rotation or -1, i3 slide;
#              (v0, v1) slide axis, s length, base (y, z) rest offset
# Per pair: first row, contact count, side a, side b; mu, side a, side b.
# The link table holds every arm of the pairs once, link by link: its joint
# index (``link_i``) and length (``link_f``); an arm of any length, up to
# MAX_LINK_RECORDS links over all the arms of a model (every link is a
# joint state, so MAX_NQ bounds a model whose arms share no joint).
SIDE_INTS = 6
SIDE_FLOATS = 7
PAIR_INTS = 2 + 2 * SIDE_INTS
PAIR_FLOATS = 1 + 2 * SIDE_FLOATS
MAX_LINK_RECORDS = 64
SHAPE_CIRCLE, SHAPE_CAPSULE, SHAPE_HALFSPACE, SHAPE_BOX = 0, 1, 2, 3
BODY_STATIC, BODY_FREE, BODY_ARM, BODY_FINGER = 0, 1, 2, 3
_SHAPES = {"circle": SHAPE_CIRCLE, "capsule": SHAPE_CAPSULE,
           "halfspace": SHAPE_HALFSPACE, "box": SHAPE_BOX}

_PAIR_KINDS = (
    ("capsule", "circle"), ("circle", "capsule"),
    ("halfspace", "circle"), ("circle", "halfspace"),
    ("circle", "circle"),
    ("box", "circle"), ("circle", "box"),
    ("capsule", "box"), ("box", "capsule"),
    ("halfspace", "box"), ("box", "halfspace"),
)
# The kernel keeps a lane's whole QP in shared memory.
MAX_ROWS = 64
MAX_NQ = 16
MAX_M = 16
BIG = 1e9


def _body_kind(body, shape_idx):
    if isinstance(body, geom.Arm2D):
        return "capsule"
    if isinstance(body, geom.StaticBody):
        s = body.shapes[shape_idx]
        if isinstance(s, geom.HalfSpace):
            return "halfspace"
        if isinstance(s, geom.Circle):
            return "circle"
        return None
    if isinstance(body, geom.PrismaticFinger2D):
        return "capsule" if body.length > 0 else "circle"
    if isinstance(body, geom.FreeBody2D):
        s = body.shapes[shape_idx]
        if isinstance(s, (geom.Circle, geom.Box)) \
                and tuple(s.center) == (0.0, 0.0):
            return "circle" if isinstance(s, geom.Circle) else "box"
        return None
    return None


def _contacts(kinds) -> int:
    """Contacts of a pair kind: a box against a halfspace touches at its
    four corners, a capsule against a box at its two ends."""
    if set(kinds) == {"box", "halfspace"}:
        return 4
    if set(kinds) == {"box", "capsule"}:
        return 2
    return 1


def _pair_kinds(model, pair):
    return (_body_kind(model.bodies[pair.body_a], pair.shape_a),
            _body_kind(model.bodies[pair.body_b], pair.shape_b))


def supports_model(model) -> bool:
    """True if every contact pair is one the CUDA narrow phase implements
    and the model fits the kernel's shared-memory bounds (at most 64
    contact rows, two for each contact)."""
    if model.contact_model != "anitescu" or not model.pairs:
        return False
    if model.nq > MAX_NQ or model.dim_u > MAX_M:
        return False
    kinds = [_pair_kinds(model, pair) for pair in model.pairs]
    if any(k not in _PAIR_KINDS for k in kinds):
        return False
    return 2 * sum(_contacts(k) for k in kinds) <= MAX_ROWS


def chain_gate(model) -> bool:
    """Quality gate on top of ``supports_model``, the JAX package's: the
    whole-chain rollout is attached only where the warm chain keeps the
    recorded convergence curves.  Prismatic-finger grasping is excluded;
    a model that canonicalises its warm duals is admitted; otherwise stiff
    actuation (Kp > 1000) is excluded."""
    for body in model.bodies:
        if isinstance(body, geom.PrismaticFinger2D):
            return False
    if model.canon_warm_duals:
        return True
    for mi in model.models:
        if mi.actuated and max(mi.stiffness) > 1000.0:
            return False
    return True


def _hessian_constants(model):
    """P diagonal (constant), and b(q, u) = pq*q - u @ KU' - tau."""
    nq, m = model.nq, model.dim_u
    p_diag = np.zeros(nq, np.float32)
    pq_vec = np.zeros(nq, np.float32)
    KU = np.zeros((nq, m), np.float32)
    tau = np.zeros(nq, np.float32)
    g = np.asarray(model.gravity, np.float32)
    iu = 0
    for mi in model.models:
        idx = np.asarray(mi.q_indices)
        if mi.actuated:
            kp = np.asarray(mi.stiffness, np.float32)
            p_diag[idx] = kp
            pq_vec[idx] = kp
            for j, qi in enumerate(idx):
                KU[qi, iu + j] = kp[j]
            iu += len(idx)
        else:
            mass = np.asarray(mi.mass, np.float32)
            p_diag[idx] = mass / np.float32(model.h ** 2)
            t = np.zeros(len(idx), np.float32)
            if len(idx) >= 2:
                t[:2] = mass[:2] * g
            tau[idx] += t
    return p_diag, pq_vec, KU, tau


def _side_record(body, shape_idx, kind, arms):
    """(ints, floats) of one side of a pair; see the layout constants.
    ``arms`` maps each arm already in the link table to its first record
    and takes a new arm's links."""
    ints = np.zeros(SIDE_INTS, np.int32)
    flts = np.zeros(SIDE_FLOATS, np.float32)
    ints[0] = _SHAPES[kind]
    ints[4] = -1
    if isinstance(body, geom.Arm2D):
        if id(body) not in arms["first"]:
            arms["first"][id(body)] = len(arms["joint"])
            arms["joint"] += list(body.joint_idx)
            arms["length"] += list(body.link_lengths)
        ints[1], ints[2] = BODY_ARM, shape_idx
        ints[5] = arms["first"][id(body)]
        flts[0] = body.radius
        flts[4:6] = body.base
        flts[6] = body.angle_offset
    elif isinstance(body, geom.PrismaticFinger2D):
        ints[1] = BODY_FINGER
        ints[2], ints[3] = body.idx_base_pos
        if body.idx_base_rot is not None:
            ints[4] = body.idx_base_rot
        ints[5] = body.idx_slide
        flts[0] = body.radius
        flts[1:3] = body.axis
        flts[3] = body.length
        flts[4:6] = body.offset
    elif isinstance(body, geom.FreeBody2D):
        s = body.shapes[shape_idx]
        ints[1] = BODY_FREE
        ints[2], ints[3] = body.idx_pos
        if body.idx_rot is not None:
            ints[4] = body.idx_rot
        if kind == "box":
            flts[1:3] = s.half
        else:
            flts[0] = s.radius
    else:
        s = body.shapes[shape_idx]
        ints[1] = BODY_STATIC
        if kind == "halfspace":
            flts[1:3] = s.normal
            flts[3] = s.offset
        else:
            flts[0] = s.radius
            flts[1:3] = s.center
    return ints, flts


def make_consts(model, device="cpu"):
    """The constants the chain needs, as f32/i32 tensors on ``device``:
    ``pdiag``/``pq``/``tau`` (nq,), ``KUT`` (m, nq), the pair table
    ``pair_i`` (pairs, PAIR_INTS) / ``pair_f`` (pairs, PAIR_FLOATS) and
    the link table ``link_i`` / ``link_f`` (links,).  Raises on a pair kind
    outside ``_PAIR_KINDS``, and past MAX_LINK_RECORDS links."""
    p_diag, pq_vec, KU, tau = _hessian_constants(model)
    pair_i = np.zeros((len(model.pairs), PAIR_INTS), np.int32)
    pair_f = np.zeros((len(model.pairs), PAIR_FLOATS), np.float32)
    arms = {"first": {}, "joint": [], "length": []}
    row = 0
    for k, pair in enumerate(model.pairs):
        kinds = _pair_kinds(model, pair)
        if kinds not in _PAIR_KINDS:
            raise ValueError(f"pair {k} of model {model.name!r}: no "
                             f"whole-chain narrow phase for {kinds}")
        ia, fa = _side_record(model.bodies[pair.body_a], pair.shape_a,
                              kinds[0], arms)
        ib, fb = _side_record(model.bodies[pair.body_b], pair.shape_b,
                              kinds[1], arms)
        pair_i[k] = np.concatenate([[row, _contacts(kinds)], ia, ib])
        pair_f[k] = np.concatenate([[pair.mu], fa, fb])
        row += 2 * _contacts(kinds)
    if len(arms["joint"]) > MAX_LINK_RECORDS:
        raise ValueError(f"model {model.name!r}: {len(arms['joint'])} arm "
                         f"links, the link table holds {MAX_LINK_RECORDS}")
    # An empty table still hands the kernel one (unread) record.
    link_i = np.asarray(arms["joint"] or [0], np.int32)
    link_f = np.asarray(arms["length"] or [0.0], np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"pdiag": t(p_diag), "pq": t(pq_vec), "KUT": t(KU.T),
            "tau": t(tau), "pair_i": t(pair_i), "pair_f": t(pair_f),
            "link_i": t(link_i), "link_f": t(link_f),
            "links": len(arms["joint"]), "rows": row}


# ---------------------------------------------------------------------------
# Plain assembly from the pair table (the kernel's narrow phase, batched)
# ---------------------------------------------------------------------------

def _col(x, i):
    return x[:, int(i)]


def _frame(si, x):
    """Origin (B, 2) and angle (B,) of a free body or a finger's base."""
    c = torch.stack([_col(x, si[2]), _col(x, si[3])], dim=-1)
    th = _col(x, si[4]) if int(si[4]) >= 0 else torch.zeros_like(x[:, 0])
    return c, th


def _arm_joints(si, sf, links, x):
    """Base and joints 0..k+1 of an Arm2D up to link k = si[2], its links
    from the link table ``links`` = (joint indices, lengths)."""
    joint, length = links
    pts = [x.new_tensor([float(sf[4]), float(sf[5])]).expand(x.shape[0], 2)]
    acc = None
    for j in range(int(si[5]), int(si[5]) + int(si[2]) + 1):
        a = _col(x, joint[j])
        acc = a if acc is None else acc + a
        ang = acc + float(sf[6])
        d = torch.stack([torch.sin(ang), -torch.cos(ang)], dim=-1) \
            * float(length[j])
        pts.append(pts[-1] + d)
    return pts


def _side_geometry(si, sf, links, x):
    """World shape of one side for lanes x (B, nq), as
    ``geometry.shape_contact`` takes it: ("circle", c, r),
    ("capsule", a0, a1, r), ("halfspace", n, offset) or
    ("box", c, half, th)."""
    shape, body = int(si[0]), int(si[1])
    if shape == SHAPE_HALFSPACE:
        return ("halfspace", (float(sf[1]), float(sf[2])), float(sf[3]))
    r = float(sf[0])
    if body == BODY_STATIC:
        c = x.new_tensor([float(sf[1]), float(sf[2])]).expand(x.shape[0], 2)
        return ("circle", c, r)
    if body == BODY_FREE:
        c, th = _frame(si, x)
        if shape == SHAPE_BOX:
            return ("box", c, (float(sf[1]), float(sf[2])), th)
        return ("circle", c, r)
    if body == BODY_ARM:
        pts = _arm_joints(si, sf, links, x)
        k = int(si[2])
        return ("capsule", pts[k], pts[k + 1], r)
    # Finger: tip = base + R(th) (offset + slide * axis); a capsule hangs
    # from the tip straight down in the base frame.
    c, th = _frame(si, x)
    slide = _col(x, si[5])
    local = torch.stack([float(sf[4]) + slide * float(sf[1]),
                         float(sf[5]) + slide * float(sf[2])], dim=-1)
    tip = c + geom._rot_apply(th, local)
    if shape == SHAPE_CAPSULE:
        return ("capsule", tip,
                tip + geom._rot_apply(th, (0.0, -float(sf[3]))), r)
    return ("circle", tip, r)


def _side_jacobian(si, sf, links, p, x):
    """(Jy, Jz), each (B, nq), of the point p (B, 2) on one side."""
    body = int(si[1])
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    Jy = torch.zeros_like(x)
    Jz = torch.zeros_like(x)
    if body in (BODY_FREE, BODY_FINGER):
        # Translation of the body or base, rotation about its origin.
        c, th = _frame(si, x)
        Jy = Jy + eye[int(si[2])]
        Jz = Jz + eye[int(si[3])]
        if int(si[4]) >= 0:
            Jy = Jy + (-(p[:, 1] - c[:, 1]))[:, None] * eye[int(si[4])]
            Jz = Jz + (p[:, 0] - c[:, 0])[:, None] * eye[int(si[4])]
        if body == BODY_FINGER:
            # The slide, along the axis turned by the base angle.
            a = geom._rot_apply(th, (float(sf[1]), float(sf[2])))
            Jy = Jy + a[:, 0:1] * eye[int(si[5])]
            Jz = Jz + a[:, 1:2] * eye[int(si[5])]
    elif body == BODY_ARM:
        pts = _arm_joints(si, sf, links, x)
        for j in range(int(si[2]) + 1):
            e = eye[int(links[0][int(si[5]) + j])]
            Jy = Jy + (-(p[:, 1] - pts[j][:, 1]))[:, None] * e
            Jz = Jz + (p[:, 0] - pts[j][:, 0])[:, None] * e
    return Jy, Jz


def assemble(consts, x: Tensor, u: Tensor):
    """b (B, nq), C (B, rows, nq), d (B, rows) in the solver's C dq <= d
    form (Anitescu), for lanes x (B, nq), u (B, m), from the pair table.
    The narrow phase is ``geometry.shape_contact``: the kernel's contact
    order, normal signs and tie rules."""
    b = consts["pq"] * x - u @ consts["KUT"] - consts["tau"]
    pair_i = consts["pair_i"].cpu().numpy()
    pair_f = consts["pair_f"].cpu().numpy()
    links = (consts["link_i"].cpu().numpy(), consts["link_f"].cpu().numpy())
    C_rows, d_cols = [], []
    for ints, flts in zip(pair_i, pair_f):
        ia, ib = ints[2:2 + SIDE_INTS], ints[2 + SIDE_INTS:]
        fa, fb = flts[1:1 + SIDE_FLOATS], flts[1 + SIDE_FLOATS:]
        mu = float(flts[0])
        contacts = geom.shape_contact(_side_geometry(ia, fa, links, x),
                                      _side_geometry(ib, fb, links, x))
        assert len(contacts) == ints[1]
        for phi, p, n in contacts:
            Jay, Jaz = _side_jacobian(ia, fa, links, p, x)
            Jby, Jbz = _side_jacobian(ib, fb, links, p, x)
            ry, rz = Jby - Jay, Jbz - Jaz
            ny, nz = n[:, 0:1], n[:, 1:2]
            Jn = ny * ry + nz * rz
            Jt = (-nz) * ry + ny * rz
            C_rows += [-(Jn + mu * Jt), -(Jn - mu * Jt)]
            d_cols += [phi, phi]
    return b, torch.stack(C_rows, dim=1), torch.stack(d_cols, dim=1)


# ---------------------------------------------------------------------------
# Dense-batched warm PDIP with diagonal P
# ---------------------------------------------------------------------------

def _pdip_warm_dense(consts, b, C, d, dq0, lam0, iters: int,
                     sigma: float = 0.25):
    """Warm-started PDIP on B independent QPs with P = diag(pdiag): the
    init branch of ``qp._pdip_solve`` (same delta shift, floors, caps,
    fraction-to-boundary and last-finite rescue).  Returns (x, lam) with
    non-finite duals set to 0."""
    delta = 1e-2
    ok0 = torch.isfinite(dq0).all(-1, keepdim=True)
    x = torch.where(ok0, dq0, torch.zeros_like(dq0))
    slack = d - (C * x[:, None, :]).sum(-1)
    shift = torch.clamp(-slack.amin(-1, keepdim=True), min=0.0) + delta
    s = slack + shift
    lam = torch.where(torch.isfinite(lam0), lam0, torch.ones_like(lam0))
    lam = torch.clamp(lam, delta, 1e6)
    return _pdip_loop_dense(consts, b, C, d, x, s, lam, iters, sigma)


def _pdip_loop_dense(consts, b, C, d, x, s, lam, iters, sigma):
    mr = d.shape[1]
    Pd = consts["pdiag"]
    Pdmat = torch.diag(Pd + 1e-8)
    x_keep = x
    for _ in range(int(iters)):
        mu = torch.clamp((s * lam).sum(-1, keepdim=True) / mr, min=MU_FLOOR)
        Cx = (C * x[:, None, :]).sum(-1)
        r_d = Pd * x + b + (C * lam[:, :, None]).sum(1)
        r_p = Cx + s - d
        r_c = lam * s - sigma * mu
        s_safe = torch.clamp(s, min=1e-7)
        w = torch.clamp(lam / s_safe, max=W_CAP)
        H = Pdmat + torch.einsum("bk,bki,bkj->bij", w, C, C)
        t_k = w * r_p - r_c / s_safe
        rhs = -(r_d + (C * t_k[:, :, None]).sum(1))
        dx = solve_spd(H, rhs)
        ds = -r_p - (C * dx[:, None, :]).sum(-1)
        dlam = (-r_c - lam * ds) / s_safe

        inf = torch.full_like(s, float("inf"))
        neg_s, neg_l = ds < 0, dlam < 0
        ratio_s = torch.where(neg_s, -s / torch.where(neg_s, ds, -1.0), inf)
        ratio_l = torch.where(neg_l, -lam / torch.where(neg_l, dlam, -1.0),
                              inf)
        amax = torch.minimum(ratio_s.amin(-1, keepdim=True),
                             ratio_l.amin(-1, keepdim=True))
        alpha = torch.clamp(0.995 * amax, max=1.0)
        x_new = x + alpha * dx
        s = s + alpha * ds
        lam = lam + alpha * dlam
        ok = torch.isfinite(x_new).all(-1, keepdim=True)
        x_keep = torch.where(ok, x_new, x_keep)
        x = x_new
    lam = torch.where(torch.isfinite(lam), lam, torch.zeros_like(lam))
    return x_keep, lam


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------

def bound_rows(bv, side: float, T: int, m: int, device,
               dtype=torch.float32) -> Tensor:
    """A (T, m) bound as finite rows: +-inf -> +-1e9, and a NaN bound
    becomes its side's no-op value (side * 1e9), i.e. unconstrained."""
    bv = torch.as_tensor(bv, dtype=dtype, device=device)
    bv = torch.where(torch.isnan(bv), torch.full_like(bv, side * BIG), bv)
    return torch.clamp(bv, -BIG, BIG).expand(T, m).contiguous()


def linesearch_rollout_plain(model, x0, u_prev0, K, z_ref_x, z_ref_w,
                             u_ref, lb, ub, rel_lb, rel_ub):
    """The plain version of K4: every line-search lane through the T knots
    as lane-batched tensor code.  Shapes: x0 (nq,), u_prev0 (m,),
    K (T, m, nz), z_ref_x (A, T, nq), z_ref_w (A, T, m) or None,
    u_ref (A, T, m), lb/ub (T, m), rel_lb/rel_ub (T, m) or None.  Returns
    xs (A, T+1, nq), us (A, T, m).  Computes in the dtype of ``x0`` (float64
    inputs give the float64 chain that float32 chains are held to where
    float32 does not determine them)."""
    A, T, m = u_ref.shape
    nq = model.nq
    dev, dt = x0.device, x0.dtype
    consts = {k: (v.to(dt) if torch.is_tensor(v) and v.is_floating_point()
                  else v) for k, v in make_consts(model, dev).items()}
    aug = z_ref_w is not None
    has_rel = rel_lb is not None
    lb = bound_rows(lb, -1.0, T, m, dev, dt)
    ub = bound_rows(ub, 1.0, T, m, dev, dt)
    if has_rel:
        rel_lb = bound_rows(rel_lb, -1.0, T, m, dev, dt)
        rel_ub = bound_rows(rel_ub, 1.0, T, m, dev, dt)

    x = x0.expand(A, nq)
    up = u_prev0.expand(A, m)
    dq = torch.zeros(A, nq, dtype=dt, device=dev)
    lam = torch.ones(A, consts["rows"], dtype=dt, device=dev)
    xs, us = [x], []
    for t in range(T):
        fb = (x - z_ref_x[:, t]) @ K[t, :, :nq].T
        if aug:
            fb = fb + (up - z_ref_w[:, t]) @ K[t, :, nq:].T
        u = u_ref[:, t] - fb
        if has_rel:
            u = torch.minimum(torch.maximum(u, up + rel_lb[t]),
                              up + rel_ub[t])
        u = torch.minimum(torch.maximum(u, lb[t]), ub[t])
        b, C, d = assemble(consts, x, u)
        dq, lam = _pdip_warm_dense(consts, b, C, d, dq, lam,
                                   model.qp_iters_ws)
        if model.canon_warm_duals:
            lam = model.canon_duals(lam)
        x = x + dq
        xs.append(x)
        us.append(u)
        up = u
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)
