"""C-grid operator algebra: the port's twin of beom_tpu/core/ops.py.

All fields are tensors of shape (..., ny, nx); dim -1 is x, dim -2 is y.
Staggering (Arakawa C):

    h[j, i]  at cell center   (x_i,      y_j)
    u[j, i]  at east  face    (x_{i+1/2}, y_j)
    v[j, i]  at north face    (x_i,      y_{j+1/2})
    q[j, i]  at corner        (x_{i+1/2}, y_{j+1/2})

Every operator is a periodic shift built on `torch.roll`, with the same
shifts, dims and association as the reference, so each result is
bit-identical to it.  Physical boundaries enter only through masks.
"""

from __future__ import annotations

import torch

__all__ = [
    "sxp", "sxm", "syp", "sym",
    "d_xp", "d_xm", "d_yp", "d_ym",
    "a_xp", "a_xm", "a_yp", "a_ym",
]

_X, _Y = -1, -2


def sxp(a: torch.Tensor) -> torch.Tensor:
    """a[..., j, i+1] (periodic)."""
    return torch.roll(a, -1, _X)


def sxm(a: torch.Tensor) -> torch.Tensor:
    """a[..., j, i-1] (periodic)."""
    return torch.roll(a, 1, _X)


def syp(a: torch.Tensor) -> torch.Tensor:
    """a[..., j+1, i] (periodic)."""
    return torch.roll(a, -1, _Y)


def sym(a: torch.Tensor) -> torch.Tensor:
    """a[..., j-1, i] (periodic)."""
    return torch.roll(a, 1, _Y)


# -- differences -------------------------------------------------------

def d_xp(a, dx):
    """(a[i+1] - a[i]) / dx, staggered +x/2 from the input."""
    return (sxp(a) - a) * (1.0 / dx)


def d_xm(a, dx):
    """(a[i] - a[i-1]) / dx, staggered -x/2 from the input."""
    return (a - sxm(a)) * (1.0 / dx)


def d_yp(a, dy):
    return (syp(a) - a) * (1.0 / dy)


def d_ym(a, dy):
    return (a - sym(a)) * (1.0 / dy)


# -- two-point averages ------------------------------------------------

def a_xp(a):
    """0.5 (a[i] + a[i+1]), staggered +x/2."""
    return 0.5 * (a + sxp(a))


def a_xm(a):
    """0.5 (a[i-1] + a[i]), staggered -x/2."""
    return 0.5 * (a + sxm(a))


def a_yp(a):
    return 0.5 * (a + syp(a))


def a_ym(a):
    return 0.5 * (a + sym(a))
