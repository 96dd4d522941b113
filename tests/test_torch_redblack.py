"""K4a, the blocked red-black sweep: its plain PyTorch version against
beom_tpu's red-black sweeps at f64 (forward, and reverse through a grid
rolled by one column, which swaps the colours), and the port's blocked
solve against beom_tpu's solve_pallas in interpret mode and against CG,
as tests/unit/test_rb_pallas.py holds the reference's.  The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.core.config import Config as JConfig
from beom_tpu.core.grid import make_grid as j_make_grid
from beom_tpu.solvers import elliptic as jel
from beom_tpu.stencils.redblack_pallas import solve_pallas

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_grid
from beom_tpu_torch.solvers import elliptic as el
from beom_tpu_torch.stencils import redblack

from tests.torch_parity import assert_close


def _setup(nx=128, ny=64):
    """tests/unit/test_rb_pallas.py's problem, for both packages."""
    kw = dict(nx=nx, ny=ny, dx=1e3, dy=1e3, solver_tol=1e-10,
              solver_maxiter=4000, sor_omega=1.7, dtype="float64")
    jcfg, cfg = JConfig(**kw), Config(**kw)
    H = np.full((ny, nx), 100.0)
    H += 40.0 * np.sin(np.arange(nx) / 5.0)[None, :]
    jgrid, grid = j_make_grid(jcfg, H), make_grid(cfg, H, device="cpu")
    rng = np.random.default_rng(7)
    b = rng.normal(size=(ny, nx)) * np.asarray(jgrid.mask)
    return jcfg, jgrid, cfg, grid, b


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lam", [0.0, 1e-4])
def test_plain_sweep_matches_reference_sweeps(lam, reverse):
    """k = 8 sweeps of the plain version = 8 sweeps of beom_tpu's
    redblack_solve from the same x0, within 1e-13 relative."""
    jcfg, jgrid, cfg, grid, b = _setup(nx=48, ny=40)
    x0 = np.random.default_rng(1).normal(size=b.shape) \
        * np.asarray(jgrid.mask)
    shift = 1 if reverse else 0       # even nx: the roll swaps the colours
    jg = dataclasses.replace(jgrid, **{
        f.name: jnp.roll(getattr(jgrid, f.name), shift, -1)
        for f in dataclasses.fields(jgrid)})
    ref = jel.redblack_solve(jnp.roll(b, shift, -1), jg, jcfg,
                             x0=jnp.roll(x0, shift, -1), lam=lam, sweeps=8)
    ref = np.roll(np.asarray(ref), -shift, -1)
    Hu, Hv = el.face_depths(grid)
    out = redblack.rb_sweep_plain(
        torch.tensor(x0), torch.tensor(b), Hu, Hv, grid.mask, cfg.dx,
        cfg.dy, lam=lam, k=8, omega=cfg.sor_omega, reverse=reverse)
    assert_close(out, ref, 1e-13)


def test_wrapper_takes_plain_version_on_cpu():
    _, _, cfg, grid, b = _setup(nx=40, ny=24)
    Hu, Hv = el.face_depths(grid)
    x = torch.tensor(b[::-1].copy())
    before = redblack.LAUNCHES
    sweep = redblack.make_level_sweep(Hu, Hv, grid.mask, cfg.dx, cfg.dy,
                                      k=3, omega=1.2)
    out = sweep(x, torch.tensor(b))
    ref = el.rb_sweeps(x, torch.tensor(b), Hu, Hv, grid.mask, cfg.dx,
                       cfg.dy, omega=1.2, sweeps=3)
    assert torch.equal(out, ref)
    assert redblack.LAUNCHES == before        # no kernel ran


def test_blocked_solve_matches_reference_and_cg_helmholtz():
    jcfg, jgrid, cfg, grid, b = _setup(nx=64, ny=32)
    lam = 1e-4
    x_ref = solve_pallas(jnp.asarray(b), jgrid, jcfg, lam=lam, k=4,
                         interpret=True, max_passes=3000)
    passes = redblack.PASSES
    x = redblack.solve_fused(torch.tensor(b), grid, cfg, lam=lam, k=4,
                             max_passes=3000)
    assert 0 < redblack.PASSES - passes < 3000
    x_cg = jel.cg_solve(jnp.asarray(b), jgrid, jcfg, lam=lam).x
    np.testing.assert_allclose(x.numpy(), np.asarray(x_cg), atol=1e-6)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-6)


def test_blocked_solve_neumann_residual():
    jcfg, jgrid, cfg, grid, b = _setup(nx=64, ny=32)
    m = np.asarray(jgrid.mask)
    b = b - m * (b.sum() / m.sum())        # compatible RHS
    x_ref = solve_pallas(jnp.asarray(b), jgrid, jcfg, k=4, tol=1e-8,
                         interpret=True, max_passes=3000)
    x = redblack.solve_fused(torch.tensor(b), grid, cfg, k=4, tol=1e-8,
                             max_passes=3000)
    Hu, Hv = el.face_depths(grid)
    bt = torch.tensor(b)
    r = (bt - el.laplacian_H(x, Hu, Hv, grid, cfg)) * grid.mask
    assert float(r.norm() / bt.norm()) < 1e-7
    # the Neumann solution is fixed up to a constant on the wet cells
    d = (x.numpy() - np.asarray(x_ref)) * m
    d = (d - m * d.sum() / m.sum()) * m
    assert np.abs(d).max() < 1e-5 * np.abs(np.asarray(x_ref)).max()
