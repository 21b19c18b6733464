"""Learned-dynamics pendulum: train an MLP model, then swing up through it.

The port of ``examples/pendulum_nn.py``: an MLP (64, 64) trained on 20k
random transitions for 600 Adam steps, then the exact and zero-order
swing-ups through it (T=100, 500 samples, 10 iterations), each plan costed
on the true pendulum.  Like the JAX driver it writes no curve: the
training draws decide its numbers.
"""
import numpy as np

from .. import (IrsMpc, IrsMpcParams, SmoothingConfig, make_pendulum,
                train_mlp_dynamics)
from .common import OUT_DIR, iterate, report

MODES = ("exact", "zero_order")


def build_params(mode, T=100, num_samples=500, **kw):
    """``examples/pendulum_nn.py:22-32``: the swing-up at T=100, std 0.5."""
    return IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), gradient_mode=mode,
        smoothing=SmoothingConfig(num_samples=num_samples, std_x=0.5,
                                  std_u=0.5), **kw)


def learned_pendulum(device="cuda", seed=0, num_transitions=20_000,
                     epochs=600, T=100, num_samples=500, iterations=10,
                     modes=MODES, drive=None):
    """Train the MLP on ``num_transitions`` random transitions of the
    pendulum for ``epochs`` Adam steps (``seed`` draws the transitions,
    the weights and the minibatches), then run each mode's swing-up
    through it for ``iterations`` (by ``drive(label, solver, iterations)``
    if given) and cost its best plan on the true pendulum.  Returns (the
    training loss, {mode: (solver, the plan's cost on the true
    dynamics)})."""
    true_sys = make_pendulum(0.05)
    nn_sys = train_mlp_dynamics(true_sys, num_transitions, hidden=(64, 64),
                                epochs=epochs, seed=seed, device=device)
    out = {}
    for mode in modes:
        solver = IrsMpc(nn_sys, build_params(mode, T, num_samples),
                        device=device)
        if drive is None:
            solver.iterate(iterations, verbose=False)
        else:
            drive(f"learned pendulum {mode}", solver, iterations)
        u = solver.u_trj_best
        x_true = true_sys.rollout(solver.x0, u)
        out[mode] = (solver, float(solver.eval_cost(x_true, u)[0]))
    return nn_sys.final_loss, out


def main(out_dir=OUT_DIR, device="cuda", gifs=True):
    def drive(label, solver, iterations):
        report(solver, label.replace(" ", "_"),
               iterate(solver, iterations), out_dir, save=False)

    loss, out = learned_pendulum(device, drive=drive)
    print(f"MLP train loss: {loss:.2e}")
    for mode, (_, true_cost) in out.items():
        print(f"  [{mode}] plan evaluated on the true dynamics: "
              f"{true_cost:.2f}")
    return []
