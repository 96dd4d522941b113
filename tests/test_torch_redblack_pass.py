"""The blocked red-black solve's pass and its loop (K4a's solve mode): the
plain pass against beom_tpu's red-black sweeps and laplacian_H on the XLA
path at f64, at odd and even sizes with cells wet across the periodic
seams; make_fused_rb_solve, which reads its test on the host once per
batch of passes, against the plain per-pass loop (x and the pass count)
and against beom_tpu's make_pallas_rb_solve in interpret mode, as
tests/unit/test_rb_pallas.py runs it.  The CUDA kernel itself is held
against the plain pass on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.core.config import Config as JConfig
from beom_tpu.core.grid import make_grid as j_make_grid
from beom_tpu.solvers import elliptic as jel
from beom_tpu.stencils.redblack_pallas import make_pallas_rb_solve

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_grid
from beom_tpu_torch.solvers import elliptic as el
from beom_tpu_torch.stencils import redblack

from tests.torch_parity import assert_close


def _setup(nx, ny, seed=7, wet_seams=False):
    """tests/unit/test_rb_pallas.py's problem for both packages; with
    `wet_seams` every cell is wet (no ring of land), so the periodic seams
    join wet cells, of one colour at an odd size."""
    kw = dict(nx=nx, ny=ny, dx=1e3, dy=1e3, solver_tol=1e-10,
              solver_maxiter=4000, sor_omega=1.7, dtype="float64")
    jcfg, cfg = JConfig(**kw), Config(**kw)
    H = np.full((ny, nx), 100.0)
    H += 40.0 * np.sin(np.arange(nx) / 5.0)[None, :]
    H += 10.0 * np.cos(np.arange(ny) / 3.0)[:, None]
    mask = np.ones((ny, nx)) if wet_seams else None
    jgrid = j_make_grid(jcfg, H, mask)
    grid = make_grid(cfg, H, mask, device="cpu")
    rng = np.random.default_rng(seed)
    m = np.asarray(jgrid.mask)
    b = rng.normal(size=(ny, nx)) * m
    x0 = rng.normal(size=(ny, nx)) * m
    return jcfg, jgrid, cfg, grid, b, x0


@pytest.mark.parametrize("k", [0, 1, 2, 8])
@pytest.mark.parametrize("lam", [0.0, 1e-4])
@pytest.mark.parametrize("shape,wet_seams", [
    ((24, 40), False), ((24, 40), True), ((21, 19), True), ((17, 30), True),
])
def test_plain_pass_matches_reference(shape, wet_seams, lam, k):
    """rb_pass_plain = beom_tpu's redblack_solve (k sweeps from x0), then
    (b - laplacian_H(x)) mask and its sum of squares, within 1e-13 of the
    field scale (1e-12 relative for the sum)."""
    ny, nx = shape
    jcfg, jgrid, cfg, grid, b, x0 = _setup(nx, ny, wet_seams=wet_seams)
    x_ref = jel.redblack_solve(jnp.asarray(b), jgrid, jcfg,
                               x0=jnp.asarray(x0), lam=lam, sweeps=k)
    jHu, jHv = jel.face_depths(jgrid)
    r_ref = (jnp.asarray(b) - jel.laplacian_H(x_ref, jHu, jHv, jgrid, jcfg,
                                              lam=lam)) * jgrid.mask
    s_ref = float(jnp.sum(r_ref * r_ref))
    Hu, Hv = el.face_depths(grid)
    x, r, s = redblack.rb_pass_plain(
        torch.tensor(x0), torch.tensor(b), Hu, Hv, grid.mask, cfg.dx,
        cfg.dy, lam=lam, k=k, omega=cfg.sor_omega)
    assert_close(x, x_ref, 1e-13, "x")
    assert_close(r, r_ref, 1e-13, "r")
    assert abs(float(s) - s_ref) <= 1e-12 * s_ref


def _rhs(grid, cfg, lam, seed=3):
    """b = A x for a seeded wet x: a right-hand side the Neumann problem
    (lam = 0) can meet."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=tuple(grid.mask.shape))) * grid.mask
    Hu, Hv = el.face_depths(grid)
    return el.laplacian_H(x, Hu, Hv, grid, cfg, lam=lam)


# (max_passes, start): a solve that converges, one that stops at
# max_passes, one whose initial x already meets the test
CASES = {"converges": (1000, None), "max_passes": (3, None),
         "converged": (1000, "solution")}


def _counters():
    return (redblack.PASSES, redblack.IDLE, redblack.SOLVES, redblack.READS,
            redblack.LAUNCHES)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("lam", [0.0, 1e-4])
@pytest.mark.parametrize("k", [2, 8])
def test_batched_solve_matches_per_pass_loop(k, lam, case):
    """make_fused_rb_solve (the test on the device state, read once per
    batch) returns the plain per-pass loop's x bit for bit and does its
    number of passes; the host reads fewer tests than there are passes."""
    max_passes, start = CASES[case]
    _, _, cfg, grid, _, _ = _setup(48, 40, wet_seams=True)
    b = _rhs(grid, cfg, lam)
    kw = dict(lam=lam, k=k, tol=1e-6, max_passes=max_passes)
    x0 = None
    if start == "solution":
        x0, n0 = redblack.rb_solve_plain(b, grid, cfg, **kw)
        assert n0 < max_passes
    ref, n_ref = redblack.rb_solve_plain(b, grid, cfg, x0=x0, **kw)
    solve = redblack.make_fused_rb_solve(grid, cfg, **kw)
    before = _counters()
    x = solve(b, x0)
    passes, idle, solves, reads, launches = (
        a - c for a, c in zip(_counters(), before))
    assert torch.equal(x, ref)
    assert passes == n_ref and solves == 1 and launches == 0
    assert (n_ref == 0) == (case == "converged")
    assert (n_ref == max_passes) == (case == "max_passes")
    assert reads <= 1 + passes // redblack.READ_EVERY
    # the next solve takes the last pass count (at least 1) as its first
    # batch: one read, and an idle pass only where no pass did work
    before = _counters()
    assert torch.equal(solve(b, x0), ref)
    assert _counters()[3] - before[3] == 1
    assert _counters()[1] - before[1] == (1 if n_ref == 0 else 0)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("lam", [0.0, 1e-4])
@pytest.mark.parametrize("k", [2, 8])
def test_solve_matches_pallas_interpret(k, lam, case):
    """The port's blocked solve against beom_tpu's make_pallas_rb_solve in
    interpret mode on tests/unit/test_rb_pallas.py's problem, 64 rows by
    32 columns (its bands need ny >= by + 2 wy at k = 8): the same x within
    1e-10 of its scale (the reference's bands reload their halo from the
    input each pass, so its passes are exact sweeps too; the XLA and torch
    op orders differ only in rounding), the same stopping pass, and the
    converged start returned as it came."""
    max_passes, start = CASES[case]
    jcfg, jgrid, cfg, grid, _, _ = _setup(32, 64)
    b = _rhs(grid, cfg, lam)
    kw = dict(lam=lam, k=k, tol=1e-6, max_passes=max_passes)
    x0 = None
    if start == "solution":
        x0, n0 = redblack.rb_solve_plain(b, grid, cfg, **kw)
        assert n0 < max_passes
    passes = redblack.PASSES
    x = redblack.make_fused_rb_solve(grid, cfg, **kw)(b, x0)
    n = redblack.PASSES - passes
    ref = make_pallas_rb_solve(jgrid, jcfg, interpret=True, **kw)(
        jnp.asarray(b.numpy()),
        None if x0 is None else jnp.asarray(x0.numpy()))
    assert (n == 0) == (case == "converged")
    assert (n == max_passes) == (case == "max_passes")
    if case == "converged":
        assert torch.equal(x, x0 * grid.mask)
        np.testing.assert_array_equal(np.asarray(ref), (x0 * grid.mask))
    assert_close(x, ref, 1e-10, "x")
