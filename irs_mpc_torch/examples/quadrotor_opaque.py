"""Opaque-simulator quadrotor: the "simulator in the loop, zero-order
only" usage.

The port of ``examples/quadrotor_opaque.py``: the "external simulator" is
a 4-substep RK4 integrator of the quadrotor ODE behind a gradient wall
(``detach``), so its exact Jacobian is zero and only the zero-order
estimator can recover a linearisation; 7 iterations of the quadrotor's
zero-order configuration, curve ``quadrotor_opaque_zero_order``.
"""
import torch

from .. import IrsMpc, System, make_quadrotor
from .common import OUT_DIR, iterate, report
from .quadrotor import build_params


def make_opaque_quadrotor(h=0.05, substeps=4) -> System:
    """RK4 sub-stepping of the quadrotor behind a gradient wall: under
    ``torch.func.jacfwd`` the detached result carries no tangent, so the
    Jacobian is exactly zero, as a compiled simulator's missing one."""
    dt = h / substeps
    analytic = make_quadrotor(dt)

    def derivative(x, u):
        # The continuous-time derivative from the explicit-Euler step.
        return (analytic.step(x, u) - x) / dt

    def rk4_step(x, u):
        for _ in range(substeps):
            k1 = derivative(x, u)
            k2 = derivative(x + 0.5 * dt * k1, u)
            k3 = derivative(x + 0.5 * dt * k2, u)
            k4 = derivative(x + dt * k3, u)
            x = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        return x.detach()

    return System(name="quadrotor_opaque", dim_x=12, dim_u=4, h=h,
                  step=rk4_step)


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    system = make_opaque_quadrotor()
    J = system.jacobian_xu(torch.full((12,), 0.1, device=device),
                           torch.full((4,), 2.0, device=device))
    if float(J.abs().max()) != 0.0:
        raise RuntimeError("the simulator must be opaque: its Jacobian is "
                           "not zero")
    solver = IrsMpc(system, build_params("zero_order"), device=device)
    return [report(solver, "quadrotor_opaque_zero_order",
                   iterate(solver, 7), out_dir)]
