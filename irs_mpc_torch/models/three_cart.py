"""Three carts on a line with inelastic collisions (a non-smooth toy).

State = [q1, q2, q3, v1, v2, v3], input = [u1, u3] (forces on the outer
carts), cart width ``d``.  Semi-implicit Euler, then one of four collision
cases (all three / 1-2 / 2-3 / none) chosen by masks, so that one code
path covers every case over any leading batch dims.

``projection`` moves sampled states onto the non-penetration set.  Both
use the symmetric half shift of the penetration depth: the reference
applies the full depth in its batched dynamics and half of it in its
single-sample dynamics, and the JAX package fixed that double add by taking
the single-sample semantics everywhere, as this module does.
"""
import torch

from .base import System


def _resolve(q1, q2, q3, d):
    """The collision cases of positions (q1, q2, q3): returns the masks
    (both, only12, only23) and the positions moved apart: all three in
    collision cluster at their mean, one pair is shifted apart by half its
    penetration depth each."""
    pen12 = (q2 - q1) < d
    pen23 = (q3 - q2) < d
    both = pen12 & pen23
    only12 = pen12 & ~pen23
    only23 = ~pen12 & pen23
    mean = (q1 + q2 + q3) / 3.0
    half12, half23 = 0.5 * (d - (q2 - q1)), 0.5 * (d - (q3 - q2))
    w = torch.where
    q1n = w(both, mean - d, w(only12, q1 - half12, q1))
    q2n = w(both, mean, w(only12, q2 + half12, w(only23, q2 - half23, q2)))
    q3n = w(both, mean + d, w(only23, q3 + half23, q3))
    return both, only12, only23, (q1n, q2n, q3n)


def make_three_cart(h: float = 0.1, d: float = 0.2) -> System:
    def step(x, u):
        q1, q2, q3, v1, v2, v3 = x.unbind(-1)
        v1s = v1 + h * u[..., 0]
        v2s = v2
        v3s = v3 + h * u[..., 1]
        q1s = q1 + h * v1s
        q2s = q2 + h * v2s
        q3s = q3 + h * v3s
        both, only12, only23, (q1n, q2n, q3n) = _resolve(q1s, q2s, q3s, d)
        # All three in collision: average the velocities (inelastic
        # impact); one pair: the pair's mean velocity.
        v_c1 = (v1s + v2s + v3s) / 3.0
        v12 = 0.5 * (v1s + v2s)
        v23 = 0.5 * (v2s + v3s)
        w = torch.where
        v1n = w(both, v_c1, w(only12, v12, v1s))
        v2n = w(both, v_c1, w(only12, v12, w(only23, v23, v2s)))
        v3n = w(both, v_c1, w(only23, v23, v3s))
        return torch.stack([q1n, q2n, q3n, v1n, v2n, v3n], dim=-1)

    def projection(x, dx, u, du):
        """Absolute samples (x + dx, u + du) with the positions moved onto
        q2 - q1 >= d, q3 - q2 >= d; x (T,n), dx (T,S,n), u (T,m),
        du (T,S,m)."""
        xp = x[:, None] + dx
        up = u[:, None] + du
        q = _resolve(xp[..., 0], xp[..., 1], xp[..., 2], d)[3]
        return torch.cat([torch.stack(q, dim=-1), xp[..., 3:]], dim=-1), up

    return System(name="three_cart", dim_x=6, dim_u=2, h=h, step=step,
                  projection=projection)
