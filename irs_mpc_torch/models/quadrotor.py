"""12-state quadrotor with roll-pitch-yaw attitude, explicit Euler.

State x = [xyz (3), rpy (3), xyz_dot (3), rpy_dot (3)]; input u = 4 rotor
commands (squared rotor speeds, force = kF u).  The physical constants and
the RPY kinematics are those of the JAX package's model.  The step works
over leading batch dims; the rate of the rpy-rate map Φ along rpy_dot is
its forward-mode derivative (``torch.func.jvp``), which nests under the
``jacfwd`` of ``System.jacobian_xu``.
"""
import torch

from .base import System

M = 0.775
L = 0.15
G = 9.81
INERTIA_DIAG = (0.0015, 0.0025, 0.0035)
KF = 1.0
KM = 0.0245


def _phi(rpy):
    """Φ (..., 3, 3), mapping body angular velocity pqr to rpy rates."""
    sr, cr = torch.sin(rpy[..., 0]), torch.cos(rpy[..., 0])
    sp, cp = torch.sin(rpy[..., 1]), torch.cos(rpy[..., 1])
    tp = sp / cp
    one, zero = torch.ones_like(sr), torch.zeros_like(sr)
    return torch.stack([
        torch.stack([one, sr * tp, cr * tp], dim=-1),
        torch.stack([zero, cr, -sr], dim=-1),
        torch.stack([zero, sr / cp, cr / cp], dim=-1)], dim=-2)


def _mv(A, v):
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def make_quadrotor(h: float = 0.01) -> System:
    # float32 tensors, one copy per device: a Python-float constant times a
    # 0-dim component would give a float64 tangent under jacfwd.
    base = {"inertia": torch.tensor(INERTIA_DIAG, dtype=torch.float32)}
    base["inertia_inv"] = 1.0 / base["inertia"]
    consts = {}

    def on(device):
        if device not in consts:
            consts[device] = {k: v.to(device) for k, v in base.items()}
        return consts[device]

    def step(x, u):
        c = on(x.device)
        uf = KF * u
        um = KM * u
        moment = torch.stack([
            L * (-uf[..., 0] - uf[..., 1] + uf[..., 2] + uf[..., 3]),
            L * (-uf[..., 0] - uf[..., 3] + uf[..., 1] + uf[..., 2]),
            -um[..., 0] + um[..., 1] - um[..., 2] + um[..., 3]], dim=-1)
        fz = uf.sum(-1)

        rpy, rpy_d = x[..., 3:6], x[..., 9:12]
        sr, cr = torch.sin(rpy[..., 0]), torch.cos(rpy[..., 0])
        sp, cp = torch.sin(rpy[..., 1]), torch.cos(rpy[..., 1])
        sy, cy = torch.sin(rpy[..., 2]), torch.cos(rpy[..., 2])
        # The thrust acts along the third column of R = Rz Ry Rx.
        xyz_dd = torch.stack([
            (cy * sp * cr + sy * sr) * fz,
            (sy * sp * cr - cy * sr) * fz,
            cp * cr * fz - M * G], dim=-1) / M

        # pqr = Φ⁻¹ rpy_dot.
        pqr = torch.stack([
            rpy_d[..., 0] - sp * rpy_d[..., 2],
            cr * rpy_d[..., 1] + (sr * cp) * rpy_d[..., 2],
            -sr * rpy_d[..., 1] + (cr * cp) * rpy_d[..., 2]], dim=-1)
        ipqr = c["inertia"] * pqr
        cross = torch.stack([
            pqr[..., 1] * ipqr[..., 2] - pqr[..., 2] * ipqr[..., 1],
            pqr[..., 2] * ipqr[..., 0] - pqr[..., 0] * ipqr[..., 2],
            pqr[..., 0] * ipqr[..., 1] - pqr[..., 1] * ipqr[..., 0]],
            dim=-1)
        pqr_d = c["inertia_inv"] * (moment - cross)

        # rpy_dd = dΦ/dt pqr + Φ pqr_d, dΦ/dt = the derivative of Φ along
        # rpy_dot.
        # (jvp refuses primals that share memory, as an expanded batch of
        # states does.)
        phi_val, phi_dot = torch.func.jvp(_phi, (rpy.contiguous(),),
                                          (rpy_d.contiguous(),))
        rpy_dd = _mv(phi_dot, pqr) + _mv(phi_val, pqr_d)

        xdot = torch.cat([x[..., 6:12], xyz_dd, rpy_dd], dim=-1)
        return x + h * xdot

    return System(name="quadrotor", dim_x=12, dim_u=4, h=h, step=step)
