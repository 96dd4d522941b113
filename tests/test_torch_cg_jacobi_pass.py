"""K6 with Jacobi (csrc/cg_jacobi.cu): the host emulation of its one-pass
schedule, `cg_solve_tiled` (tiles with a recomputed one-cell halo, r, w
and s in two alternating banks, u never stored), against the plain CG
`cg_solve_plain` and against beom_tpu's whole-solve kernel
make_vmem_cg_solve(precond='jacobi') in interpret mode, at f64 on the
rigid-lid gyre (64 x 64), on an odd 29 x 37 grid wet everywhere (the
periodic seams inside the operator) and on the coastal_wetdry mask, with
lam = 0 (the deflated Neumann problem) and lam = 1 / (g dt^2).  Bounds:
iterations within 1, x within 1e-6 x scale, the true residual within
20 tol |b|.  Also: u' recomputed in a tile's halo equals the owner's u'
bit for bit at every tile edge; the tile plan covers the grid and fits
the kernel's shared memory.  The CUDA kernel itself is held against the
plain CG on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.core.config import Config as JConfig
from beom_tpu.core.grid import make_grid as j_make_grid
from beom_tpu.stencils.cg_vmem import make_vmem_cg_solve

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_grid
from beom_tpu_torch.solvers import elliptic as el
from beom_tpu_torch.stencils import cg_fused

from tests.torch_parity import to_port

# uneven tiles: heights and widths that differ by one, edges inside
# the seams' neighbourhood
TILES = (3, 4)


def _case(name):
    """(reference cfg, reference grid, cfg, grid, b) at f64."""
    if name == "wet_odd":
        ny, nx = 29, 37
        kw = dict(nx=nx, ny=ny, dx=1e3, dy=1e3, dt=60.0, solver_tol=1e-10,
                  solver_maxiter=4000, dtype="float64")
        jcfg, cfg = JConfig(**kw), Config(**kw)
        H = np.full((ny, nx), 100.0)
        H += 40.0 * np.sin(np.arange(nx) / 5.0)[None, :]
        H += 10.0 * np.cos(np.arange(ny) / 3.0)[:, None]
        jgrid = j_make_grid(jcfg, H, np.ones((ny, nx)))
        grid = make_grid(cfg, H, np.ones((ny, nx)), device="cpu")
    else:
        case = "rigid_lid" if name == "gyre" else "coastal_wetdry"
        jcase = jax_make_case(case, nx=64, ny=64, dtype="float64")
        jcfg, jgrid = jcase[0], jcase[1]
        cfg, grid, _, _ = to_port(*jcase)
    m = np.asarray(jgrid.mask)
    rng = np.random.default_rng(12)
    b = (rng.standard_normal(m.shape)
         + np.sin(np.linspace(0, 4 * np.pi, m.shape[0]))[:, None]) * m
    return jcfg, jgrid, cfg, grid, b


@pytest.fixture(scope="module", params=["gyre", "wet_odd", "coastal"])
def case(request):
    return _case(request.param)


def _lam(cfg, kind):
    return 0.0 if kind == "neumann" else 1.0 / (cfg.g * cfg.dt ** 2)


@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_tiled_schedule_matches_plain_and_reference(case, kind):
    jcfg, jgrid, cfg, grid, b = case
    lam = _lam(cfg, kind)
    bt = torch.tensor(b)
    res = cg_fused.cg_solve_tiled(bt, grid, cfg, lam=lam, tiles=TILES)
    plain = cg_fused.cg_solve_plain(bt, grid, cfg, lam=lam)
    ref = make_vmem_cg_solve(jgrid, jcfg, lam=lam, precond="jacobi",
                             interpret=True)(jnp.asarray(b))
    assert res.iters > 0
    assert abs(res.iters - plain.iters) <= 1
    assert abs(res.iters - int(ref.iters)) <= 1
    Hu, Hv = el.face_depths(grid)
    r = (bt - el.laplacian_H(res.x, Hu, Hv, grid, cfg, lam=lam)) * grid.mask
    if lam == 0.0:      # the residual of the compatible (deflated) system
        r = (r - grid.mask * r.sum() / grid.mask.sum()) * grid.mask
    assert float(r.norm()) <= 20 * cfg.solver_tol * float(bt.norm())
    for x_ref in (plain.x.numpy(), np.asarray(ref.x)):
        np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=0,
                                   atol=1e-6 * np.abs(x_ref).max())


def test_warm_start_and_iteration_limit(case):
    """A warm start from the solution stops within one iteration, as the
    plain CG does; maxiter caps the passes."""
    _, _, cfg, grid, b = case
    lam = _lam(cfg, "helmholtz")
    bt = torch.tensor(b)
    cold = cg_fused.cg_solve_tiled(bt, grid, cfg, lam=lam, tiles=TILES)
    warm = cg_fused.cg_solve_tiled(bt, grid, cfg, x0=cold.x, lam=lam,
                                   tiles=TILES)
    plain = cg_fused.cg_solve_plain(bt, grid, cfg, x0=cold.x, lam=lam)
    assert abs(warm.iters - plain.iters) <= 1 and warm.iters <= 1
    capped = cg_fused.cg_solve_tiled(bt, grid, cfg, lam=lam, maxiter=3,
                                     tiles=TILES)
    assert capped.iters == 3


@pytest.mark.parametrize("tiles", [TILES, (5, 2), (1, 1)])
def test_halo_u_equals_owned_u(case, tiles):
    """Every tile's u' at each point of its one-cell halo is the owning
    tile's u' at that point, bit for bit, on the first three passes."""
    _, _, cfg, grid, b = case
    seen = {}

    def record(pas, tile, rows, cols, u_ext):
        if pas < 3:
            seen.setdefault(pas, []).append((rows, cols, u_ext))

    cg_fused.cg_solve_tiled(torch.tensor(b), grid, cfg, maxiter=2,
                            lam=_lam(cfg, "helmholtz"), tiles=tiles,
                            record=record)
    ny, nx = b.shape
    assert sorted(seen) == [0, 1, 2]
    for pas, tiles_seen in seen.items():
        owned = torch.full((ny, nx), float("nan"), dtype=torch.float64)
        for rows, cols, u in tiles_seen:
            owned[rows[1:-1][:, None], cols[1:-1][None, :]] = u[1:-1, 1:-1]
        assert not bool(owned.isnan().any())
        for rows, cols, u in tiles_seen:
            ring = torch.ones_like(u, dtype=torch.bool)
            ring[1:-1, 1:-1] = False
            want = owned[rows[:, None], cols[None, :]]
            assert torch.equal(u[ring], want[ring]), f"pass {pas}"


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape,ctas", [
    ((2048, 2048), 132), ((2048, 2048), 264), ((136, 200), 132),
    ((137, 201), 396), ((29, 37), 4), ((1, 5000), 132), ((3000, 1), 132)])
def test_tile_plan_covers_and_fits(shape, ctas, itemsize):
    """The plan's tiles partition the grid into tiles of two sizes at
    most per axis, each staged with its halo within the kernel's shared
    memory and rows."""
    ny, nx = shape
    nty, ntx = cg_fused.tile_plan(ny, nx, ctas, itemsize)
    assert 1 <= nty <= ny and 1 <= ntx <= nx
    hs = [b - a for a, b in (cg_fused.tile_bounds(ny, nty, t)
                             for t in range(nty))]
    ws = [b - a for a, b in (cg_fused.tile_bounds(nx, ntx, t)
                             for t in range(ntx))]
    assert sum(hs) == ny and sum(ws) == nx and min(hs) >= 1
    assert min(ws) >= 1 and max(hs) - min(hs) <= 1 and max(ws) - min(ws) <= 1
    assert max(hs) + 2 <= cg_fused.MAX_EXT_ROWS
    assert cg_fused.NPLANE * (max(hs) + 2) * itemsize \
        * cg_fused.row_stride(max(ws), itemsize) <= cg_fused.SMEM_TILE


def test_jacobi_operands_refuse_a_fractional_mask(case):
    """The kernel reads the mask as pm != 0: exact for a 0/1 mask, so
    any other mask is refused."""
    _, _, cfg, grid, _ = case
    _, _, pm = cg_fused.jacobi_operands(grid, cfg, 0.0)
    assert torch.equal(pm != 0, grid.mask != 0)
    bad = dataclasses.replace(grid, mask=grid.mask * 0.5)
    with pytest.raises(ValueError, match="0/1 mask"):
        cg_fused.jacobi_operands(bad, cfg, 0.0)
