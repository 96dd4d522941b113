"""Wetting / drying tests of the port, on the eager backend at f64 on the
CPU: twins of tests/physics/test_wetdry.py with the reference's
tolerances and step counts (a dam break onto a dry slope, a draining
basin, a rewetting slosh): h >= 0 always, mass conserved to round-off,
cells genuinely dry and re-wet.  The dam break's 800 steps and the
rewetting cycle's 10 x 100 are also run through beom_tpu's XLA path from
the same inputs, and the port's final h, u, v lie within 1e-9 of field
scale of it (a cell that crossed the dry threshold on one side only
would show there)."""

import numpy as np
import pytest

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.stepping import run_steps as jax_run_steps

from beom_tpu_torch.cases import make_case
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_forcing, make_grid
from beom_tpu_torch.core.state import init_state
from beom_tpu_torch.physics.wetdry import wet_mask
from beom_tpu_torch.stepping import run_steps

from tests.torch_parity import (assert_close, assert_state_close,
                                one_thread, xla_twin)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _setup(H, h0, dt, nu2=0.0, cd=2.5e-3):
    ny, nx = H.shape
    cfg = Config(nx=nx, ny=ny, dx=100.0, dy=100.0, nz=1, rho=(1000.0,),
                 f0=0.0, dt=dt, wetdry=True, h_dry=0.05, h_min=1e-4,
                 nu2=nu2, cd_bot=cd, dtype="float64")
    grid = make_grid(cfg, H, device="cpu")
    forcing = make_forcing(cfg, device="cpu")
    h0 = h0[None] * grid.mask.numpy()
    state = init_state(cfg, grid, h0=h0)
    return cfg, grid, forcing, state, h0


def test_dam_break_onto_dry_slope():
    """Water column released onto an initially dry upward slope."""
    ny, nx = 16, 128
    x = np.linspace(0.0, 1.0, nx)[None, :]
    H = np.broadcast_to(5.0 - 4.0 * x, (ny, nx)).copy()   # shoals east
    # dam: left third holds 3 m of water above the bed; right is dry
    h0 = np.where(x < 0.33, 3.0, 1e-4) * np.ones((ny, nx))
    dt = 0.5 * 100.0 / np.sqrt(2 * 9.81 * 8.0)
    cfg, grid, forcing, state, h0 = _setup(H, h0, dt)

    m0 = float(state.h.sum())
    out = run_steps(state, grid, forcing, cfg, 800)
    xla_twin(cfg, H, 800, out, h0=h0)
    h = out.h.numpy()

    assert np.isfinite(h).all()
    assert h.min() >= 0.0
    m1 = float(np.sum(h))
    assert abs(m1 - m0) / m0 < 1e-12
    # the front genuinely advanced: wet cells beyond the dam at the end
    wet_end = wet_mask(out.h, grid, cfg).numpy()[0]
    assert wet_end[:, int(0.5 * nx)].max() == 1.0


def test_draining_basin_dries_and_conserves():
    """A perched shelf drains into a deep pool: the thin sheet flows off
    the step (throttled by drag and the positive-definite limiter, so
    drainage is slow but monotone), stays non-negative, and conserves
    mass exactly through the wet/dry transition."""
    ny, nx = 16, 96
    x = np.linspace(0.0, 1.0, nx)[None, :]
    # left half: deep pool (H=10); right half: shelf at H=0.5
    H = np.where(x < 0.5, 10.0, 0.5) * np.ones((ny, nx))
    # start with 0.3 m of water everywhere above local bed
    h0 = np.where(x < 0.5, 5.0, 0.3) * np.ones((ny, nx))
    dt = 0.4 * 100.0 / np.sqrt(2 * 9.81 * 10.0)
    cfg, grid, forcing, state, _ = _setup(H, h0, dt, cd=5e-4)

    m0 = float(state.h.sum())
    shelf_cols = slice(int(0.55 * nx), nx - 1)
    mean0 = float(state.h.numpy()[0][:, shelf_cols].mean())
    out = run_steps(state, grid, forcing, cfg, 4000)
    h = out.h.numpy()

    assert np.isfinite(h).all()
    assert h.min() >= 0.0
    assert abs(float(np.sum(h)) - m0) / m0 < 1e-12
    # the shelf genuinely drained: mean depth down substantially, and
    # the cells next to the step thinned toward the dry threshold
    mean1 = float(h[0][:, shelf_cols].mean())
    assert mean1 < 0.75 * mean0
    near_step = h[0][1:-1, int(0.52 * nx)]
    assert near_step.max() < 3.0 * cfg.h_dry


def test_rewetting_cycle():
    """Slosh: a tilted surface swings back and wets previously dry
    cells; every intermediate state stays non-negative.  beom_tpu's XLA
    path steps beside it, chunk for chunk."""
    cfg, grid, forcing, state = make_case("coastal_wetdry", nx=64, ny=48,
                                          dtype="float64", device="cpu")
    jcfg, jgrid, jforcing, js = jax_make_case("coastal_wetdry", nx=64,
                                              ny=48, dtype="float64")
    assert_close(state.h, js.h, 0.0, "initial h")
    s = state
    m0 = float(state.h.sum())
    dried = rewet = False
    wet0 = wet_mask(state.h, grid, cfg).numpy()
    for _ in range(10):
        s = run_steps(s, grid, forcing, cfg, 100)
        js = jax_run_steps(js, jgrid, jforcing, jcfg, 100)
        h = s.h.numpy()
        assert h.min() >= 0.0
        wet = wet_mask(s.h, grid, cfg).numpy()
        if ((wet0 - wet) > 0).any():
            dried = True
        if dried and ((wet - wet0) > 0).any():
            rewet = True
    assert_state_close(s, js, 1e-9, "after 1000 steps vs beom_tpu XLA")
    assert abs(float(s.h.sum()) - m0) / m0 < 1e-11
    assert dried
