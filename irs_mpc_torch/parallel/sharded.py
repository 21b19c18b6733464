"""Mesh-sharded Monte-Carlo estimation.

The counterpart of the JAX package's ``parallel/sharded.py``: the
estimation sweep split over a (sample, knot) grid of devices,

* axis ``knot``   - the time dimension (padded to a multiple of the knot
                    shards; padded knots compute values that are dropped);
* axis ``sample`` - the Monte-Carlo samples of every knot,

and the regression moments (G = S'S, M = S'D), or the sums of the sampled
Jacobians, reduced over the sample axis.  A mesh may span the ranks of a
``torch.distributed`` group (``multihost.pod_mesh``): every rank computes
the cells it owns, and one ``all_reduce`` of a (knot shard, knot, ...)
buffer per estimate, zero where a rank owns nothing, both reduces over the
samples and brings the knots together, so every rank fits every knot.

Every cell takes its slice of the SAME (T, S) draws that the single-device
estimator makes from the solver's generator (each rank draws them in full
from the same seed), so the sharded estimate equals the single-device one
up to the order of summation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.base import System
from ..ops.estimators import (GRADIENT_MODES, SmoothingConfig,
                              TvLinearization, _affine_c, _draws, _flat,
                              fit_from_moments)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (sample, knot) grid of cells.  ``devices`` and ``ranks`` run
    row-major over the grid: cell (s, k) is entry s * n_knot + k, computed
    on that device by that rank.  ``distributed`` meshes reduce across the
    ranks of ``group`` (None: the default group)."""
    devices: Tuple[torch.device, ...]
    ranks: Tuple[int, ...]
    n_sample: int
    n_knot: int
    distributed: bool = False
    group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {"sample": self.n_sample, "knot": self.n_knot}

    def cells(self, rank: int):
        """(s, k, device) of every cell that ``rank`` computes."""
        for i, (dev, r) in enumerate(zip(self.devices, self.ranks)):
            if r == rank:
                yield i // self.n_knot, i % self.n_knot, dev


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def make_mesh(n_sample: int = 1, n_knot: int = 1,
              devices: Optional[object] = "cuda") -> Mesh:
    """A (sample, knot) mesh of this process's devices: ``devices`` is one
    device for every cell (a device, or its name) or a sequence of
    n_sample * n_knot of them.  Several cells may share a device."""
    n = n_sample * n_knot
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(devices=devices, ranks=(_rank(),) * n, n_sample=n_sample,
                n_knot=n_knot)


def default_mesh(devices: Sequence = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device of this
    process) that favours the sample axis: 4 or 2 knot shards where that
    leaves at least 2 sample shards, else 1."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    n_knot = next((c for c in (4, 2) if n % c == 0 and n // c >= 2), 1)
    return make_mesh(n // n_knot, n_knot, devices)


def _pad_T(T: int, shards: int) -> int:
    return ((T + shards - 1) // shards) * shards


def _moments(S: Tensor, D: Tensor):
    """(S'S, S'D) summed over the samples of every knot: S (Tk, s, p),
    D (Tk, s, n)."""
    St = S.transpose(-1, -2)
    return St @ S, St @ D


def _cell(system: System, mode: str, cfg: SmoothingConfig, x, u, f0, dx,
          du, first: bool) -> dict:
    """The partial sums of one cell over its knots (Tk) and samples;
    ``first`` marks the cells of sample shard 0, which also compute the
    per-knot (unsampled) terms."""
    n = system.dim_x
    if mode == "exact":
        return {"AB": system.jacobian_xu_batch(x, u)} if first else {}
    if system.projection is not None and mode in ("first_order",
                                                  "zero_order"):
        xp, up = system.projection(x, dx, u, du)
    else:
        xp, up = x[:, None] + dx, u[:, None] + du
    if mode == "first_order":
        return {"AB": _flat(system.jacobian_xu_batch, xp, up).sum(1)}
    if mode in ("zero_order", "zero_order_AB"):
        if system.projection is not None and mode == "zero_order":
            dx, du = xp - x[:, None], up - u[:, None]
        fd = _flat(system.step_batch, xp, up)
        G, M = _moments(torch.cat([dx, du], dim=2), fd - f0[:, None])
        return {"G": G, "M": M}
    # zero_order_B: the samples share the nominal state.
    xb = x[:, None].expand(dx.shape)
    ub = u[:, None] + du
    G, M = _moments(du, _flat(system.step_batch, xb, ub) - f0[:, None])
    out = {"G": G, "M": M}
    if cfg.zero_order_B_A_source == "first_order":
        out["A"] = _flat(system.jacobian_xu_batch, xb, ub)[..., :n].sum(1)
    elif first:
        out["A"] = system.jacobian_xu_batch(x, u)[:, :, :n]
    return out


def _sums_shapes(mode: str, n: int, m: int) -> dict:
    """The name and per-knot shape of every sum that ``mode`` reduces."""
    if mode in ("exact", "first_order"):
        return {"AB": (n, n + m)}
    if mode == "zero_order_B":
        return {"G": (m, m), "M": (m, n), "A": (n, n)}
    return {"G": (n + m, n + m), "M": (n + m, n)}


def sharded_estimate_tv_matrices(
        system: System, mode: str, x_trj: Tensor, u_trj: Tensor,
        generator: Optional[torch.Generator], it, cfg: SmoothingConfig,
        mesh: Mesh, perturbations=None) -> TvLinearization:
    """``estimate_tv_matrices`` sharded over ``mesh``: knots over its knot
    axis, samples over its sample axis, the sums reduced over the samples
    (and across ranks by ``all_reduce`` on a distributed mesh).

    The draws are those of the single-device estimator (from ``generator``
    on the trajectories' device, or ``perturbations``); sample shard s
    takes the s-th of n_sample near-equal slices of every knot's samples.
    The sample steps go through ``system.step_batch``, the Jacobians
    through ``system.jacobian_xu_batch``, on each cell's device."""
    if mode not in GRADIENT_MODES:
        raise ValueError(
            f"gradient mode {mode!r} not in {list(GRADIENT_MODES)}")
    T, m = u_trj.shape
    n = system.dim_x
    home = x_trj.device
    Tp = _pad_T(T, mesh.n_knot)
    Tk = Tp // mesh.n_knot

    def pad(a, fill=None):
        """(T, ...) -> (Tp, ...), padded with ``fill`` or zeros."""
        tail = (a.new_zeros((Tp - T,) + a.shape[1:]) if fill is None
                else fill.expand((Tp - T,) + a.shape[1:]))
        return torch.cat([a, tail])

    x_nom = x_trj[:-1]
    f_nom = system.step_batch(x_nom, u_trj)
    xs, us, f0 = pad(x_nom, x_trj[-1]), pad(u_trj), pad(f_nom, f_nom[-1])
    if mode != "exact":
        dx, du = _draws(system, x_trj, generator, it, cfg, perturbations)
        S = du.shape[1]
        if S < mesh.n_sample:
            raise ValueError(f"{S} samples for {mesh.n_sample} sample "
                             f"shards")
        dx, du = pad(dx), pad(du)
        bounds = [(S * s) // mesh.n_sample for s in range(mesh.n_sample + 1)]

    shapes = _sums_shapes(mode, n, m)
    sums = {name: x_trj.new_zeros((mesh.n_knot, Tk) + shp)
            for name, shp in shapes.items()}
    for s, k, dev in mesh.cells(_rank()):
        knots = slice(k * Tk, (k + 1) * Tk)
        if mode == "exact":
            cdx = cdu = None
        else:
            samples = slice(bounds[s], bounds[s + 1])
            cdx = dx[knots, samples].to(dev)
            cdu = du[knots, samples].to(dev)
        out = _cell(system, mode, cfg, xs[knots].to(dev), us[knots].to(dev),
                    f0[knots].to(dev), cdx, cdu, first=s == 0)
        for name, v in out.items():
            sums[name][k] += v.to(home)
    if mesh.distributed:
        names = list(sums)
        flat = torch.cat([sums[k].reshape(-1) for k in names])
        dist.all_reduce(flat, group=mesh.group)
        parts = flat.split([sums[k].numel() for k in names])
        sums = {k: v.reshape(sums[k].shape) for k, v in zip(names, parts)}
    sums = {name: v.reshape((Tp,) + v.shape[2:])[:T]
            for name, v in sums.items()}

    if mode == "exact":
        AB = sums["AB"]
    elif mode == "first_order":
        AB = sums["AB"] / S
    elif mode == "zero_order":
        AB = fit_from_moments(sums["G"], sums["M"])
    elif mode == "zero_order_AB":
        AB = fit_from_moments(sums["G"], sums["M"], damp=cfg.damp)
    else:
        A = sums["A"]
        if cfg.zero_order_B_A_source == "first_order":
            A = A / S
        AB = torch.cat([A, fit_from_moments(sums["G"], sums["M"])], dim=2)
    A, B = AB[:, :, :n], AB[:, :, n:]
    return TvLinearization(A=A, B=B, c=_affine_c(A, B, f_nom, x_nom, u_trj))
