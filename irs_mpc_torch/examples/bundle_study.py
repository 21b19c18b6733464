"""Bundled against true one-step dynamics near a contact boundary.

The port of ``examples/analysis/bundle_study.py``, the project's picture of
why randomized smoothing helps, on box pushing (h=0.1):

1. the hand just below the box, its commanded height swept over 101
   points through the contact boundary: the true one-step box height, the
   exact slope at the nominal (one-sided: it sees no contact) and the
   zero_order_B slopes at std 0.01, 0.03 and 0.06 from 3000 samples;
2. the hand's start height swept over 81 points with a fixed upward push
   of 0.06, on the Anitescu and the LCP contact model at ``qp_iters=80``:
   each model's true response and its bundle, the mean over 800 draws of
   the start height at std 0.02, all 81 x 800 steps in one flat
   ``step_batch`` a model.

Every step goes through the model's default ``system()``, the plain
batched PDIP (not K2), as in the JAX study.

    python -m irs_mpc_torch.examples.bundle_study [--check]
        [--out DIR] [--cpu]

``main`` returns the numbers the JAX study prints (the exact slope, the
three bundled slopes, each model's true and bundle ranges) and the curves;
``bundle_study.png`` goes to ``--out`` where matplotlib imports.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..models.contact.systems import make_box_pushing
from ..ops.estimators import SmoothingConfig, estimate_tv_matrices
from .common import OUT_DIR, out_path

# The nominal: the hand just below the box (moving up makes contact).
X_NOMINAL = (0., 0.5, 0., 0., -0.13)
SWEEP_POINTS, STDS, SLOPE_SAMPLES = 101, (0.01, 0.03, 0.06), 3000
N_PTS, N_MC, STD_W, PUSH, QP_ITERS = 81, 800, 0.02, 0.06, 80


def sweep_inputs(device="cuda"):
    """The commanded height offsets of panel 1 and its (SWEEP_POINTS, 5)
    states and (SWEEP_POINTS, 2) inputs."""
    du_z = torch.linspace(-0.1, 0.1, SWEEP_POINTS, device=device)
    x = torch.tensor(X_NOMINAL, device=device)
    us = torch.stack([torch.zeros_like(du_z), -0.13 + du_z], dim=1)
    return du_z, x.expand(SWEEP_POINTS, 5), us


def hand_heights(points=N_PTS, device="cuda"):
    """Panel 2's start heights (the box's bottom at -0.05)."""
    return torch.linspace(-0.20, -0.06, points, device=device)


def response(system, z):
    """The box's next height from hand start heights ``z`` under the
    upward push."""
    xs = torch.tensor(X_NOMINAL, device=z.device).repeat(z.shape[0], 1)
    xs[:, 4] = z
    us = torch.stack([torch.zeros_like(z), z + PUSH], dim=1)
    return system.step_batch(xs, us)[:, 1]


def contact_systems(model):
    """(tag, system) of panel 2: the deep-iteration Anitescu model and its
    LCP twin."""
    deep = dataclasses.replace(model, qp_iters=QP_ITERS)
    return (("Anitescu", deep.system()),
            ("LCP", dataclasses.replace(deep, contact_model="lcp").system()))


def slope(system, x, u, std, generator=None, draws=None,
          num_samples=SLOPE_SAMPLES):
    """The zero_order_B slope d box_z / d u_z at (x, u): ``draws``
    (dx (1, S, 5), du (1, S, 2)) or the generator's."""
    cfg = SmoothingConfig(num_samples=num_samples, std_x=1e-4, std_u=std,
                          decay=lambda it: 1.0)
    tv = estimate_tv_matrices(system, "zero_order_B", torch.stack([x, x]),
                              u[None], generator, 1, cfg, draws)
    return float(tv.B[0, 1, 1])


def deterministic(device="cuda"):
    """The study's parts that no draw enters: panel 1's true sweep, the
    step at the nominal and the exact slope; panel 2's true curves."""
    model = make_box_pushing(h=0.1)
    system = model.system()
    du_z, xs, us = sweep_inputs(device=device)
    x, u = xs[0], torch.tensor(X_NOMINAL[3:], device=device)
    out = {"sweep": system.step_batch(xs, us)[:, 1],
           "z0": float(system.step(x[None], u[None])[0, 1]),
           "exact_slope": float(system.jacobian_xu(x, u)[1, 6])}
    z = hand_heights(device=device)
    for tag, s in contact_systems(model):
        out[f"true_{tag}"] = response(s, z)
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def bundles(w, n_pts=N_PTS):
    """Panel 2's bundles for start-height draws ``w`` (n_mc,): each
    model's mean response over the draws, from one flat step_batch, on
    the draws' device."""
    z = hand_heights(n_pts, w.device)
    z_flat = (z[None, :] + w[:, None]).reshape(-1)
    return {tag: response(s, z_flat).reshape(w.shape[0], n_pts).mean(0)
            .cpu().numpy()
            for tag, s in contact_systems(make_box_pushing(h=0.1))}


def main(out_dir=OUT_DIR, device="cuda", seed=0):
    """Run the study; returns its numbers (and the curves)."""
    gen = torch.Generator(device).manual_seed(seed)
    det = deterministic(device)
    system = make_box_pushing(h=0.1).system()
    x = torch.tensor(X_NOMINAL, device=device)
    u = x[3:5]
    slopes = {std: slope(system, x, u, std, gen) for std in STDS}
    w = STD_W * torch.randn(N_MC, generator=gen, device=device)
    bundle = bundles(w)
    result = {"exact_slope": det["exact_slope"], "slopes": slopes,
              "z0": det["z0"], "sweep": det["sweep"].tolist()}
    print("exact slope:", det["exact_slope"], "bundled:", slopes)
    for tag in ("Anitescu", "LCP"):
        true_c, b = det[f"true_{tag}"], bundle[tag]
        result[tag] = {"true": true_c.tolist(), "bundle": b.tolist(),
                       "true_range": [float(true_c.min()),
                                      float(true_c.max())],
                       "bundle_range": [float(b.min()), float(b.max())]}
        print(f"{tag}: true range [{true_c.min():.3f},{true_c.max():.3f}] "
              f"bundle range [{b.min():.3f},{b.max():.3f}]", flush=True)
    plot(result, out_path(out_dir, "bundle_study.png"))
    return result


def plot(result, out):
    """The study's two panels, where matplotlib imports."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no figure drawn")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, (ax, ax2) = plt.subplots(1, 2, figsize=(12, 4.5))
    du_z = np.linspace(-0.1, 0.1, len(result["sweep"]))
    ax.plot(du_z, result["sweep"], "k-", label="true one-step dynamics")
    ax.plot(du_z, result["z0"] + result["exact_slope"] * du_z, "r--",
            label=f"exact gradient (slope {result['exact_slope']:.2f})")
    for std, s in result["slopes"].items():
        ax.plot(du_z, result["z0"] + s * du_z, "--",
                label=f"bundled, std={std} (slope {s:.2f})")
    ax.set_xlabel("hand command delta-z")
    ax.set_ylabel("box z next")
    ax.set_title("bundled vs exact linearization (Anitescu)")
    ax.legend()
    ax.grid(True)
    zs = np.linspace(-0.20, -0.06, N_PTS)
    for tag, color in (("Anitescu", "springgreen"), ("LCP", "blue")):
        ax2.plot(zs, result[tag]["true"], "-", color=color,
                 label=f"{tag} dynamics")
        ax2.plot(zs, result[tag]["bundle"], "--", color=color,
                 label=f"bundled ({tag}, std={STD_W})")
    ax2.set_xlabel("hand start height (contact boundary at -0.10)")
    ax2.set_ylabel("box z next")
    ax2.set_title("contact models: LCP step vs Anitescu ramp, and bundles")
    ax2.legend()
    ax2.grid(True)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print("saved", out)


if __name__ == "__main__":
    from .run_all import study_cli
    sys.exit(study_cli("bundle_study"))
