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
for every contact pair, one record per side naming the shape kind, the body
kind and its indices and parameters.  The plain assembly below reads that
table exactly as the kernel does, so the CPU tests check the table too.

Scope (``supports_model``): Anitescu models whose pairs are capsule (an
Arm2D link) against circle, or halfspace against circle, either way round;
circles on a FreeBody2D (centred) or a StaticBody.  The other pair kinds of
the JAX package's whole-chain kernel (circle-circle and the box kinds)
are not in the CUDA narrow phase yet; models that use them keep the
solver's plain rollout loop.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as geom
from .qp import MU_FLOOR, W_CAP
from ...ops.linalg import solve_spd

Tensor = torch.Tensor

# Table layout, shared with csrc/rollout.cu.
MAX_LINKS = 4
SIDE_INTS = 5 + MAX_LINKS     # shape, body, i0, i1, i2, joint_idx[MAX_LINKS]
SIDE_FLOATS = 7 + MAX_LINKS   # radius, v0, v1, offset, base y, base z,
#                               angle offset, link_lengths[MAX_LINKS]
PAIR_INTS = 2 * SIDE_INTS
PAIR_FLOATS = 1 + 2 * SIDE_FLOATS   # mu, side a, side b
SHAPE_CIRCLE, SHAPE_CAPSULE, SHAPE_HALFSPACE = 0, 1, 2
BODY_STATIC, BODY_FREE, BODY_ARM = 0, 1, 2

_PAIR_KINDS = (("capsule", "circle"), ("circle", "capsule"),
               ("halfspace", "circle"), ("circle", "halfspace"))
# The kernel keeps a lane's whole QP in shared memory.
MAX_ROWS = 64
MAX_NQ = 16
MAX_M = 16
BIG = 1e9


def _body_kind(body, shape_idx):
    if isinstance(body, geom.Arm2D):
        if len(body.link_lengths) <= MAX_LINKS:
            return "capsule"
        return None
    if isinstance(body, geom.StaticBody):
        s = body.shapes[shape_idx]
        if isinstance(s, geom.HalfSpace):
            return "halfspace"
        if isinstance(s, geom.Circle):
            return "circle"
        return None
    if isinstance(body, geom.FreeBody2D):
        s = body.shapes[shape_idx]
        if isinstance(s, geom.Circle) and tuple(s.center) == (0.0, 0.0):
            return "circle"
        return None
    return None


def supports_model(model) -> bool:
    """True if every contact pair is one the CUDA narrow phase implements
    and the model fits the kernel's shared-memory bounds."""
    if model.contact_model != "anitescu" or not model.pairs:
        return False
    if (model.nq > MAX_NQ or model.dim_u > MAX_M
            or model.n_constraint_rows() > MAX_ROWS):
        return False
    for pair in model.pairs:
        kinds = (_body_kind(model.bodies[pair.body_a], pair.shape_a),
                 _body_kind(model.bodies[pair.body_b], pair.shape_b))
        if kinds not in _PAIR_KINDS:
            return False
    return True


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


def _side_record(body, shape_idx):
    """(ints, floats) of one side of a pair; see the layout constants."""
    ints = np.zeros(SIDE_INTS, np.int32)
    flts = np.zeros(SIDE_FLOATS, np.float32)
    ints[4] = -1
    if isinstance(body, geom.Arm2D):
        ints[0], ints[1], ints[2] = SHAPE_CAPSULE, BODY_ARM, shape_idx
        ints[5:5 + len(body.joint_idx)] = body.joint_idx
        flts[0] = body.radius
        flts[4:6] = body.base
        flts[6] = body.angle_offset
        flts[7:7 + len(body.link_lengths)] = body.link_lengths
    elif isinstance(body, geom.FreeBody2D):
        s = body.shapes[shape_idx]
        ints[0], ints[1] = SHAPE_CIRCLE, BODY_FREE
        ints[2], ints[3] = body.idx_pos
        ints[4] = -1 if body.idx_rot is None else body.idx_rot
        flts[0] = s.radius
    else:
        s = body.shapes[shape_idx]
        ints[1] = BODY_STATIC
        if isinstance(s, geom.HalfSpace):
            ints[0] = SHAPE_HALFSPACE
            flts[1:3] = s.normal
            flts[3] = s.offset
        else:
            ints[0] = SHAPE_CIRCLE
            flts[0] = s.radius
            flts[1:3] = s.center
    return ints, flts


def make_consts(model, device="cpu"):
    """The constants the chain needs, as f32/i32 tensors on ``device``:
    ``pdiag``/``pq``/``tau`` (nq,), ``KUT`` (m, nq), and the pair table
    ``pair_i`` (pairs, PAIR_INTS) / ``pair_f`` (pairs, PAIR_FLOATS)."""
    p_diag, pq_vec, KU, tau = _hessian_constants(model)
    pair_i = np.zeros((len(model.pairs), PAIR_INTS), np.int32)
    pair_f = np.zeros((len(model.pairs), PAIR_FLOATS), np.float32)
    for k, pair in enumerate(model.pairs):
        ia, fa = _side_record(model.bodies[pair.body_a], pair.shape_a)
        ib, fb = _side_record(model.bodies[pair.body_b], pair.shape_b)
        pair_i[k] = np.concatenate([ia, ib])
        pair_f[k] = np.concatenate([[pair.mu], fa, fb])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"pdiag": t(p_diag), "pq": t(pq_vec), "KUT": t(KU.T),
            "tau": t(tau), "pair_i": t(pair_i), "pair_f": t(pair_f)}


# ---------------------------------------------------------------------------
# Plain assembly from the pair table (the kernel's narrow phase, batched)
# ---------------------------------------------------------------------------

def _side_geometry(si, sf, x):
    """World shape of one side for lanes x (B, nq): (kind, params) with
    circle (c, r), capsule (a0, a1, r, joints) or halfspace (n, offset)."""
    shape, body = int(si[0]), int(si[1])
    B = x.shape[0]
    if shape == SHAPE_HALFSPACE:
        return ("halfspace", (float(sf[1]), float(sf[2])), float(sf[3]))
    if shape == SHAPE_CIRCLE:
        if body == BODY_FREE:
            c = torch.stack([x[:, int(si[2])], x[:, int(si[3])]], dim=-1)
        else:
            c = x.new_tensor([float(sf[1]), float(sf[2])]).expand(B, 2)
        return ("circle", c, float(sf[0]))
    k = int(si[2])
    pts = [x.new_tensor([float(sf[4]), float(sf[5])]).expand(B, 2)]
    acc = None
    for j in range(k + 1):
        a = x[:, int(si[5 + j])]
        acc = a if acc is None else acc + a
        ang = acc + float(sf[6])
        d = torch.stack([torch.sin(ang), -torch.cos(ang)], dim=-1) \
            * float(sf[7 + j])
        pts.append(pts[-1] + d)
    return ("capsule", pts[k], pts[k + 1], float(sf[0]), pts)


def _side_jacobian(si, geo, p, x):
    """(Jy, Jz), each (B, nq), of the point p (B, 2) on one side."""
    body = int(si[1])
    nq = x.shape[1]
    eye = torch.eye(nq, dtype=x.dtype, device=x.device)
    Jy = torch.zeros_like(x)
    Jz = torch.zeros_like(x)
    if body == BODY_FREE:
        Jy = Jy + eye[int(si[2])]
        Jz = Jz + eye[int(si[3])]
        if int(si[4]) >= 0:
            c = geo[1]
            Jy = Jy + (-(p[:, 1] - c[:, 1]))[:, None] * eye[int(si[4])]
            Jz = Jz + (p[:, 0] - c[:, 0])[:, None] * eye[int(si[4])]
    elif body == BODY_ARM:
        pts = geo[4]
        for j in range(int(si[2]) + 1):
            e = eye[int(si[5 + j])]
            Jy = Jy + (-(p[:, 1] - pts[j][:, 1]))[:, None] * e
            Jz = Jz + (p[:, 0] - pts[j][:, 0])[:, None] * e
    return Jy, Jz


def _narrow_phase(ga, gb):
    """(phi, p, n) of one pair, n from A into B."""
    if ga[0] == "capsule" and gb[0] == "circle":
        return geom.capsule_circle(ga[1], ga[2], ga[3], gb[1], gb[2])
    if ga[0] == "circle" and gb[0] == "capsule":
        phi, p, n = geom.capsule_circle(gb[1], gb[2], gb[3], ga[1], ga[2])
        return phi, p, -n
    if ga[0] == "halfspace" and gb[0] == "circle":
        return geom.circle_halfspace(gb[1], gb[2], ga[1], ga[2])
    if ga[0] == "circle" and gb[0] == "halfspace":
        phi, p, n = geom.circle_halfspace(ga[1], ga[2], gb[1], gb[2])
        return phi, p, -n
    raise NotImplementedError((ga[0], gb[0]))


def assemble(consts, x: Tensor, u: Tensor):
    """b (B, nq), C (B, rows, nq), d (B, rows) in the solver's C dq <= d
    form (Anitescu), for lanes x (B, nq), u (B, m), from the pair table."""
    b = consts["pq"] * x - u @ consts["KUT"] - consts["tau"]
    pair_i = consts["pair_i"].cpu().numpy()
    pair_f = consts["pair_f"].cpu().numpy()
    C_rows, d_cols = [], []
    for ints, flts in zip(pair_i, pair_f):
        ia, ib = ints[:SIDE_INTS], ints[SIDE_INTS:]
        fa, fb = flts[1:1 + SIDE_FLOATS], flts[1 + SIDE_FLOATS:]
        ga, gb = _side_geometry(ia, fa, x), _side_geometry(ib, fb, x)
        phi, p, n = _narrow_phase(ga, gb)
        Jay, Jaz = _side_jacobian(ia, ga, p, x)
        Jby, Jbz = _side_jacobian(ib, gb, p, x)
        ry, rz = Jby - Jay, Jbz - Jaz
        ny, nz = n[:, 0:1], n[:, 1:2]
        Jn = ny * ry + nz * rz
        Jt = (-nz) * ry + ny * rz
        mu = float(flts[0])
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

def bound_rows(bv, side: float, T: int, m: int, device) -> Tensor:
    """A (T, m) bound as finite f32 rows: +-inf -> +-1e9, and a NaN bound
    becomes its side's no-op value (side * 1e9), i.e. unconstrained."""
    bv = torch.as_tensor(bv, dtype=torch.float32, device=device)
    bv = torch.where(torch.isnan(bv), torch.full_like(bv, side * BIG), bv)
    return torch.clamp(bv, -BIG, BIG).expand(T, m).contiguous()


def linesearch_rollout_plain(model, x0, u_prev0, K, z_ref_x, z_ref_w,
                             u_ref, lb, ub, rel_lb, rel_ub):
    """The plain version of K4: every line-search lane through the T knots
    as lane-batched tensor code.  Shapes: x0 (nq,), u_prev0 (m,),
    K (T, m, nz), z_ref_x (A, T, nq), z_ref_w (A, T, m) or None,
    u_ref (A, T, m), lb/ub (T, m), rel_lb/rel_ub (T, m) or None.  Returns
    xs (A, T+1, nq), us (A, T, m)."""
    A, T, m = u_ref.shape
    nq = model.nq
    dev = x0.device
    consts = make_consts(model, dev)
    aug = z_ref_w is not None
    has_rel = rel_lb is not None
    lb, ub = bound_rows(lb, -1.0, T, m, dev), bound_rows(ub, 1.0, T, m, dev)
    if has_rel:
        rel_lb = bound_rows(rel_lb, -1.0, T, m, dev)
        rel_ub = bound_rows(rel_ub, 1.0, T, m, dev)

    x = x0.expand(A, nq)
    up = u_prev0.expand(A, m)
    dq = torch.zeros(A, nq, device=dev)
    lam = torch.ones(A, model.n_constraint_rows(), device=dev)
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
