"""Analytic tests of the port's dynamics, on the eager backend at f64 on
the CPU: twins of tests/physics/test_analytic.py (the Munk layer's in
tests/test_torch_munk.py) with the reference's tolerances and step counts,
the channel built again on the port's make_grid / make_forcing.  Where a
run has at most 1000 steps (the gravity wave's 150, the geostrophic
state's 200, the Kelvin wave's 150), beom_tpu's XLA path also runs from
the same inputs and the port's final h, u, v lie within 1e-9 of field
scale of it."""

import numpy as np
import pytest

from beom_tpu_torch.cases import make_case
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_forcing, make_grid
from beom_tpu_torch.core.state import init_state
from beom_tpu_torch.stepping import run_steps

from tests.torch_parity import one_thread, xla_twin

G = 9.81
TWIN = 1000      # the longest run that is also held against beom_tpu


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _channel(nx, ny, H0, dx, f0=0.0, beta=0.0, nz=1, rho=(1027.0,),
             periodic_x=False, **kw):
    """Closed basin (land ring), or a zonally periodic channel; returns
    (cfg, grid, forcing, H, mask) with H and mask as given to make_grid."""
    c = float(np.sqrt(G * H0))
    dt = kw.pop("dt", 0.3 * dx / (np.sqrt(2) * c))
    cfg = Config(nx=nx, ny=ny, dx=dx, dy=dx, nz=nz, rho=rho,
                 f0=f0, beta=beta, dt=float(dt), adv_scheme="linear",
                 dtype="float64", **kw)
    H = np.full((ny, nx), H0)
    mask = None
    if periodic_x:
        mask = np.ones((ny, nx))
        mask[0, :] = mask[-1, :] = 0.0     # walls north+south only
    grid = make_grid(cfg, H, mask=mask, device="cpu")
    forcing = make_forcing(cfg, device="cpu")
    return cfg, grid, forcing, H, mask


def _np(a):
    return a.numpy()


def _run(cfg, grid, forcing, H, mask, n, h0, u0=None):
    state = init_state(cfg, grid, h0=h0, u0=u0)
    out = run_steps(state, grid, forcing, cfg, n)
    if n <= TWIN:
        xla_twin(cfg, H, n, out, mask=mask, h0=h0, u0=u0)
    return state, out


def test_gravity_wave_phase_speed():
    """A small eta bump spreads at c = sqrt(g H) (non-rotating)."""
    nx = ny = 128
    H0, dx = 100.0, 1e3
    cfg, grid, forcing, H, mask = _channel(nx, ny, H0, dx)
    c = np.sqrt(G * H0)

    x = (np.arange(nx) - nx / 2)[None, :] * dx
    y = (np.arange(ny) - ny / 2)[:, None] * dx
    r = np.sqrt(x * x + y * y)
    eta0 = 0.01 * np.exp(-(r / (5 * dx)) ** 2)
    h0 = (H0 + eta0)[None] * _np(grid.mask)

    T = 0.25 * nx * dx / c
    n = int(T / cfg.dt)
    assert n <= TWIN
    _, out = _run(cfg, grid, forcing, H, mask, n, h0)
    eta = _np(out.h[0]) - H0 * _np(grid.mask)

    r_front = float(r[np.unravel_index(np.argmax(np.abs(eta)),
                                       eta.shape)])
    expected = c * n * cfg.dt
    assert abs(r_front - expected) / expected < 0.15


def test_geostrophic_state_is_stationary():
    """An exactly geostrophically balanced jet stays put on the f-plane."""
    nx = ny = 64
    H0, dx, f0 = 100.0, 1e3, 1e-4
    cfg, grid, forcing, H, mask = _channel(nx, ny, H0, dx, f0=f0,
                                           periodic_x=True)

    # the balance as the model discretizes it: an x-uniform zonal jet
    # u(y) and eta(y) from the discrete v-momentum balance
    # d_yp(eta) = -(f/g) a_yp(u)
    y = np.arange(ny)
    yc = ny / 2
    u_prof = 0.2 * np.exp(-((y - yc) / 8.0) ** 2)
    eta_prof = np.zeros(ny)
    for j in range(ny - 1):
        eta_prof[j + 1] = eta_prof[j] - (f0 * dx / G) * 0.5 * (
            u_prof[j] + u_prof[j + 1])
    eta_prof -= eta_prof[ny // 2]
    eta = np.broadcast_to(eta_prof[:, None], (ny, nx)).copy()
    u = np.broadcast_to(u_prof[:, None], (ny, nx)).copy()
    h0 = (H0 + eta)[None] * _np(grid.mask)
    u0 = (u * _np(grid.mask_u))[None]

    state, out = _run(cfg, grid, forcing, H, mask, 200, h0, u0)
    du = np.abs(_np(out.u) - _np(state.u)).max()
    assert du < 0.05 * np.abs(u).max()
    deta = np.abs((_np(out.h[0]) - h0[0]) * _np(grid.mask)).max()
    assert deta < 0.05 * 0.05


def test_kelvin_wave_hugs_the_wall():
    """With rotation, a coastal disturbance propagates as a boundary-
    trapped Kelvin wave with the coast on its right (f > 0)."""
    nx, ny = 128, 64
    H0, dx, f0 = 100.0, 1e3, 1e-3
    cfg, grid, forcing, H, mask = _channel(nx, ny, H0, dx, f0=f0,
                                           periodic_x=True)
    c = np.sqrt(G * H0)
    Ld = c / f0

    x = (np.arange(nx) - nx / 4)[None, :] * dx
    y = np.arange(ny)[:, None] * dx
    eta0 = 0.01 * np.exp(-(x / (5 * dx)) ** 2) * np.exp(-y / Ld)
    h0 = (H0 + eta0)[None] * _np(grid.mask)
    u0 = (G / c * eta0)[None] * _np(grid.mask_u)

    T = 0.25 * nx * dx / c
    n = int(T / cfg.dt)
    assert n <= TWIN
    _, out = _run(cfg, grid, forcing, H, mask, n, h0, u0)
    eta = (_np(out.h[0]) - H0) * _np(grid.mask)

    strip = eta[1:5, :].max(axis=0)
    i_peak = int(np.argmax(strip))
    i0 = nx // 4
    moved = (i_peak - i0) * dx
    expected = c * n * cfg.dt
    assert moved > 0.5 * expected
    assert abs(moved - expected) / expected < 0.3


def test_stommel_western_intensification():
    """With beta and linear drag the steady gyre piles up on the WEST."""
    cfg, grid, forcing, state = make_case(
        "double_gyre", nx=64, ny=64, dtype="float64", adv_scheme="linear",
        r_bot=2e-4, nu2=0.0, beta=2e-11, device="cpu")
    out = run_steps(state, grid, forcing, cfg, 4000)
    v = _np(out.v)[0]
    west = np.abs(v[:, 1:16]).max()
    east = np.abs(v[:, 48:63]).max()
    assert west > 3.0 * east


def test_baroclinic_gravity_wave_speed():
    """2-layer internal wave speed c_i = sqrt(g' h1 h2 / (h1+h2))."""
    nx = ny = 128
    H0, dx = 100.0, 1e3
    rho = (1026.0, 1027.0)
    cfg, grid, forcing, H, mask = _channel(nx, ny, H0, dx, nz=2, rho=rho)
    gp = G * (rho[1] - rho[0]) / cfg.rho0
    h1, h2 = 30.0, 70.0
    ci = np.sqrt(gp * h1 * h2 / (h1 + h2))

    x = (np.arange(nx) - nx / 2)[None, :] * dx
    y = (np.arange(ny) - ny / 2)[:, None] * dx
    r = np.sqrt(x * x + y * y)
    d = 1.0 * np.exp(-(r / (5 * dx)) ** 2)
    h0 = np.zeros((2, ny, nx))
    h0[0] = h1 + d
    h0[1] = h2 - d
    h0 *= _np(grid.mask)

    T = 0.2 * nx * dx / ci
    n = int(T / cfg.dt)
    _, out = _run(cfg, grid, forcing, H, mask, n, h0)
    disp = (_np(out.h[0]) - h1) * _np(grid.mask)

    r_front = float(r[np.unravel_index(np.argmax(np.abs(disp)),
                                       disp.shape)])
    expected = ci * n * cfg.dt
    assert abs(r_front - expected) / expected < 0.2
