"""K6, the fused CG: its plain PyTorch version (what the wrapper runs on
CPU tensors) with Jacobi against beom_tpu's whole-solve kernel
make_vmem_cg_solve(precond='jacobi') in interpret mode, with
tests/unit/test_cg_vmem.py's bounds: the true residual within 20 x tol
|b|, x within 1e-6 x scale, and a warm start from the solution cutting
the iterations at least fourfold; and the preconditioner the wrapper
picks.  The multigrid preconditioner's parity is in
tests/test_torch_mg_kernels.py.  The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.stencils.cg_vmem import make_vmem_cg_solve

from beom_tpu_torch.solvers import elliptic as el
from beom_tpu_torch.stencils import cg_fused

from tests.torch_parity import to_port


@pytest.fixture(scope="module")
def case():
    jcase = jax_make_case("rigid_lid", nx=64, ny=64, dtype="float64")
    cfg, grid, _, _ = to_port(*jcase)
    m = np.asarray(jcase[1].mask)
    rng = np.random.default_rng(12)
    b = (rng.standard_normal(m.shape)
         + np.sin(np.linspace(0, 4 * np.pi, m.shape[0]))[:, None]) * m
    return jcase[0], jcase[1], cfg, grid, b


def _lam(cfg, kind):
    return 0.0 if kind == "neumann" else 1.0 / (cfg.g * cfg.dt ** 2)


@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_plain_matches_vmem_kernel(case, kind):
    jcfg, jgrid, cfg, grid, b = case
    lam = _lam(cfg, kind)
    ref = make_vmem_cg_solve(jgrid, jcfg, lam=lam, precond="jacobi",
                             interpret=True)(jnp.asarray(b))
    before = cg_fused.LAUNCHES
    res = cg_fused.make_cg_solve(grid, cfg, lam=lam,
                                 precond="jacobi")(torch.tensor(b))
    assert cg_fused.LAUNCHES == before       # CPU tensors: plain version
    assert isinstance(res.iters, int) and res.iters > 0
    assert abs(res.iters - int(ref.iters)) <= 1
    bt = torch.tensor(b)
    Hu, Hv = el.face_depths(grid)
    r = (bt - el.laplacian_H(res.x, Hu, Hv, grid, cfg, lam=lam)) * grid.mask
    if lam == 0.0:      # the residual of the compatible (deflated) system
        r = (r - grid.mask * r.sum() / grid.mask.sum()) * grid.mask
    assert float(r.norm()) <= 20 * cfg.solver_tol * float(bt.norm())
    x_ref = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=0,
                               atol=1e-6 * np.abs(x_ref).max())


def test_warm_start_cuts_iterations(case):
    _, _, cfg, grid, b = case
    solve = cg_fused.make_cg_solve(grid, cfg, lam=_lam(cfg, "helmholtz"),
                                   precond="jacobi")
    cold = solve(torch.tensor(b))
    warm = solve(torch.tensor(b), x0=cold.x)
    assert warm.iters <= max(cold.iters // 4, 1)


@pytest.mark.parametrize("precond,lam,uses_mg", [
    ("auto", 0.0, True), ("auto", 1e-3, False), ("mg", 1e-3, True),
    ("ssor", 0.0, False), ("jacobi", 0.0, False)])
def test_precond_choice(case, precond, lam, uses_mg):
    """'auto' is multigrid for lam = 0 and Jacobi otherwise; 'ssor' is
    not offered in the kernel and becomes Jacobi, as in the reference.
    solve.steps is the multigrid cycle the kernel walks, or empty."""
    _, _, cfg, grid, b = case
    solve = cg_fused.make_cg_solve(grid, cfg, lam=lam, precond=precond)
    assert bool(solve.steps) == uses_mg
    res = solve(torch.tensor(b))
    ref = cg_fused.cg_solve_plain(torch.tensor(b), grid, cfg, lam=lam,
                                  precond="mg" if uses_mg else "jacobi")
    assert res.iters == ref.iters
    np.testing.assert_array_equal(res.x.numpy(), ref.x.numpy())


def test_unknown_precond_raises(case):
    _, _, cfg, grid, _ = case
    with pytest.raises(ValueError, match="precond"):
        cg_fused.make_cg_solve(grid, cfg, precond="ilu")
