"""Cost-curve plots and 2D scene animations.

The port of ``irs_mpc_tpu/utils/viz.py``: one matplotlib renderer that
draws the contact engine's geometry (``Body.world_shapes``) and the
analytic systems.  matplotlib is imported inside the functions, with the
headless Agg backend, so that importing this module needs none; tensors
are moved to numpy before drawing.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(a):
    """``a`` (a tensor on any device, or an array-like) as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _save(fig, plt, path):
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_cost_curves(curves: dict, path, logy: bool = False,
                     title: str = "Trajectory cost"):
    """curves: {label: [cost per iteration]} -> saved PNG."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, ys in curves.items():
        ax.plot(_np(ys), label=label)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("Iterations")
    ax.set_title(title)
    ax.legend()
    ax.grid(True)
    return _save(fig, plt, path)


def plot_phase_trajectories(x_trj_lst, path, dims=(0, 1),
                            title: str = "iterates"):
    """Phase-space plot of the iterates, later iterates more opaque."""
    plt = _mpl()
    import matplotlib
    fig, ax = plt.subplots(figsize=(5, 5))
    colormap = matplotlib.colormaps["jet"]
    n = len(x_trj_lst)
    for i, x_trj in enumerate(x_trj_lst):
        x = _np(x_trj)
        col = colormap(i / max(n - 1, 1))
        ax.plot(x[:, dims[0]], x[:, dims[1]],
                color=(col[0], col[1], col[2], (i + 1) / n))
    ax.set_title(title)
    return _save(fig, plt, path)


def _draw_shape(ax, shape, color):
    import matplotlib.patches as mp
    kind = shape[0]
    if kind == "circle":
        c, r = _np(shape[1]), float(shape[2])
        ax.add_patch(mp.Circle(c, r, fill=False, color=color, lw=1.5))
    elif kind == "capsule":
        a, b, r = _np(shape[1]), _np(shape[2]), float(shape[3])
        ax.plot([a[0], b[0]], [a[1], b[1]], color=color,
                lw=2 * r * 72, alpha=0.4, solid_capstyle="round")
        ax.plot([a[0], b[0]], [a[1], b[1]], color=color, lw=1.5)
    elif kind == "box":
        c, half, th = _np(shape[1]), np.asarray(shape[2]), float(shape[3])
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        corners = [c + R @ (half * np.array([sx, sy]))
                   for sx, sy in [(1, 1), (-1, 1), (-1, -1), (1, -1)]]
        ax.add_patch(mp.Polygon(np.asarray(corners), fill=False,
                                color=color, lw=1.5))
    elif kind == "halfspace":
        n, off = np.asarray(shape[1]), float(shape[2])
        p0 = n * off
        t = np.array([-n[1], n[0]])
        a, b = p0 - 3 * t, p0 + 3 * t
        ax.plot([a[0], b[0]], [a[1], b[1]], color=color, lw=1.0, ls="--")


def _save_gif(fig, plt, draw_frame, frames, path, fps):
    from matplotlib.animation import FuncAnimation, PillowWriter
    anim = FuncAnimation(fig, draw_frame, frames=frames)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def animate_contact_trajectory(model, x_trj, path, fps: int = 10,
                               xlim=(-1.5, 1.5), ylim=(-0.5, 1.5)):
    """Render a contact-system trajectory to an animated GIF.  ``model`` is
    a QuasistaticModel; ``x_trj`` (T+1, nq) configurations."""
    plt = _mpl()
    x_trj = torch.as_tensor(_np(x_trj), dtype=torch.float32)
    colors = ["tab:blue", "tab:orange", "tab:green", "tab:red",
              "tab:purple", "tab:brown", "tab:gray"]
    fig, ax = plt.subplots(figsize=(5, 5))

    def draw_frame(i):
        ax.clear()
        ax.set_xlim(*xlim)
        ax.set_ylim(*ylim)
        ax.set_aspect("equal")
        for b_i, body in enumerate(model.bodies):
            for shape in body.world_shapes(x_trj[i]):
                _draw_shape(ax, shape, colors[b_i % len(colors)])
        ax.set_title(f"{model.name} t={i}")

    return _save_gif(fig, plt, draw_frame, len(x_trj), path, fps)


# ---------------------------------------------------------------------------
# The analytic systems' frames
# ---------------------------------------------------------------------------

def _frame_pendulum(ax, x, _u):
    import matplotlib.patches as mp
    th = float(x[0])
    # theta = 0 hanging down, theta = pi upright.
    tip = np.array([np.sin(th), -np.cos(th)])
    ax.plot([0, tip[0]], [0, tip[1]], "k-", lw=2)
    ax.add_patch(mp.Circle(tip, 0.08, color="tab:blue"))
    ax.set_xlim(-1.3, 1.3)
    ax.set_ylim(-1.3, 1.3)


def _frame_three_cart(ax, x, _u, x_trj=None):
    import matplotlib.patches as mp
    w, hgt = 0.4, 0.3
    for i, col in enumerate(["tab:blue", "tab:orange", "tab:green"]):
        ax.add_patch(mp.Rectangle((float(x[i]) - w / 2, 0), w, hgt,
                                  color=col))
    ax.axhline(0, color="k", lw=1)
    # One camera over the whole trajectory (per-frame limits jitter).
    ref = x[:3] if x_trj is None else x_trj[:, :3]
    ax.set_xlim(float(np.min(ref)) - 1.5, float(np.max(ref)) + 1.5)
    ax.set_ylim(-0.5, 1.0)


def _frame_bicycle(ax, x, _u):
    px, py, th = float(x[0]), float(x[1]), float(x[2])
    d = np.array([np.cos(th), np.sin(th)]) * 0.3
    ax.plot([px - d[0], px + d[0]], [py - d[1], py + d[1]], "k-", lw=3)
    ax.plot([px + d[0]], [py + d[1]], "r.", ms=10)
    ax.set_xlim(px - 3, px + 3)
    ax.set_ylim(py - 3, py + 3)


_ANALYTIC_FRAMES = {
    "pendulum": _frame_pendulum,
    "three_cart": _frame_three_cart,
    "bicycle": _frame_bicycle,
}


def animate_analytic_trajectory(name: str, x_trj, path, u_trj=None,
                                fps: int = 20, max_frames: int = 80):
    """Animate an analytic system's state trajectory to a GIF.  ``name``
    in {pendulum, three_cart, bicycle, quadrotor}; frames are subsampled
    to at most ``max_frames``."""
    plt = _mpl()
    x_trj = _np(x_trj)
    u_trj = None if u_trj is None else _np(u_trj)
    stride = max(1, len(x_trj) // max_frames)
    idx = list(range(0, len(x_trj), stride))

    if name == "quadrotor":
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(projection="3d")

        def draw_frame(i):
            k = idx[i]
            ax.clear()
            ax.plot(x_trj[:k + 1, 0], x_trj[:k + 1, 1], x_trj[:k + 1, 2],
                    "b-", lw=1)
            ax.scatter(*x_trj[k, :3], color="tab:red", s=40)
            lo, hi = x_trj[:, :3].min() - 0.5, x_trj[:, :3].max() + 0.5
            ax.set_xlim(lo, hi)
            ax.set_ylim(lo, hi)
            ax.set_zlim(lo, hi)
            ax.set_title(f"quadrotor t={k}")
    else:
        frame_fn = _ANALYTIC_FRAMES[name]
        fig, ax = plt.subplots(figsize=(5, 5))

        def draw_frame(i):
            k = idx[i]
            ax.clear()
            ax.set_aspect("equal")
            u_k = None if u_trj is None else u_trj[min(k, len(u_trj) - 1)]
            if name == "three_cart":
                frame_fn(ax, x_trj[k], u_k, x_trj)
            else:
                frame_fn(ax, x_trj[k], u_k)
            ax.set_title(f"{name} t={k}")

    return _save_gif(fig, plt, draw_frame, len(idx), path, fps)
