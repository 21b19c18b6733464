"""The estimator comparison on the second-order (mbp2d) planar hand.

The port of ``examples/planar_hand_second_order_estimators.py``: at the
cradle state of the position-mode plant (x = (q, v), the left finger's
command raised by 0.1), the exact Jacobian [A | B] against the three
smoothed estimates (first_order; zero_order_B with A from averaged
first-order Jacobians; zero_order_AB), 500 samples at std_u 0.01, std_x
1e-3, damping 3e-3.

    python -m irs_mpc_torch.examples.planar_hand_second_order_estimators
        [--check] [--out DIR] [--cpu]

``planar_hand_second_estimators.csv`` (the JAX study's header and rows:
each mode's max abs error of A and of B against the exact Jacobian, and
those over its largest entry) goes to ``--out``, and the four-panel
heatmap ``planar_hand_second_estimators.png`` too where matplotlib
imports (the card's machine has none).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.estimators import SmoothingConfig, estimate_tv_matrices
from .common import OUT_DIR, out_path
from .planar_hand_second_order import Q0, make_mbp

# (mode, its zero_order_B_A_source), as the JAX study runs them.
MODES = (("first_order", "exact"), ("zero_order_B", "first_order"),
         ("zero_order_AB", "exact"))
HEADER = "mode,max_abs_err_A,max_abs_err_B,rel_err_A,rel_err_B"


def probe_state(mbp):
    """The cradle state x0 = (Q0, 0) and the nominal command with the left
    finger's raised by 0.1."""
    x0 = np.concatenate([Q0, np.zeros(mbp.nq)]).astype(np.float32)
    u0 = Q0[mbp.indices_u_into_x()].astype(np.float32)
    u0[0] += 0.1
    return x0, u0


def smoothing(num_samples, std_u, a_src):
    return SmoothingConfig(num_samples=num_samples, std_u=std_u, std_x=1e-3,
                           decay=lambda it: 1.0, decay_std_x=False,
                           damp=3e-3, zero_order_B_A_source=a_src)


def compare(system, x0, u0, num_samples=500, std_u=0.01, generator=None,
            draws=None):
    """The exact [A | B] and each mode's estimate at one knot, and the
    CSV rows.  ``draws`` maps a mode to its (dx (1, S, n), du (1, S, m))
    perturbations, as the estimator takes them; otherwise they come from
    ``generator``.  It runs on the device of the generator or the draws."""
    dev = (generator.device if generator is not None
           else next(iter(draws.values()))[0].device)
    x = torch.as_tensor(x0, device=dev)
    u = torch.as_tensor(u0, device=dev)
    AB_exact = system.jacobian_xu(x, u).cpu().numpy()
    n = x.shape[0]
    results = {"exact_jacfwd": AB_exact}
    rows = []
    scale = np.abs(AB_exact).max()
    for mode, a_src in MODES:
        tv = estimate_tv_matrices(
            system, mode, torch.stack([x, x]), u[None], generator, 1,
            smoothing(num_samples, std_u, a_src),
            None if draws is None else draws[mode])
        AB = torch.cat([tv.A[0], tv.B[0]], dim=1).cpu().numpy()
        results[mode] = AB
        err_a = np.abs(AB[:, :n] - AB_exact[:, :n]).max()
        err_b = np.abs(AB[:, n:] - AB_exact[:, n:]).max()
        rows.append((mode, float(err_a), float(err_b), float(err_a / scale),
                     float(err_b / scale)))
    return results, rows


def main(out_dir=OUT_DIR, device="cuda", num_samples=500, std_u=0.01,
         seed=0):
    """Run the comparison; returns its rows as a dict of mode: (max abs
    err A, max abs err B, rel err A, rel err B)."""
    mbp = make_mbp("position")
    x0, u0 = probe_state(mbp)
    gen = torch.Generator(device).manual_seed(seed)
    results, rows = compare(mbp.system(), x0, u0, num_samples, std_u, gen)
    for mode, ea, eb, ra, rb in rows:
        print(f"[{mode:15s}] max|dA|={ea:.4f} max|dB|={eb:.4f} "
              f"(rel {ra:.4f} / {rb:.4f})", flush=True)
    path = out_path(out_dir, "planar_hand_second_estimators.csv")
    path.write_text(HEADER + "\n" + "".join(
        f"{r[0]},{r[1]:.6f},{r[2]:.6f},{r[3]:.6f},{r[4]:.6f}\n"
        for r in rows))
    plot(results, Path(out_dir) / "planar_hand_second_estimators.png")
    return {r[0]: r[1:] for r in rows}


def plot(results, out):
    """The four [A | B] heatmaps, where matplotlib imports."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no heatmap drawn")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(4, 1, figsize=(8, 11))
    vmax = np.abs(results["exact_jacfwd"]).max()
    titles = ["Exact AB (jacfwd)", "First order smoothing AB",
              "Zero order smoothing B (A: averaged first-order)",
              "Zero order smoothing AB"]
    for ax, v, t in zip(axes, results.values(), titles):
        im = ax.imshow(v, vmin=-vmax, vmax=vmax, cmap="RdBu_r",
                       aspect="auto")
        ax.set_title(t)
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print("saved", out)


if __name__ == "__main__":
    from .run_all import study_cli
    sys.exit(study_cli("planar_hand_second_order_estimators"))
