"""K6, the fused Jacobi CG: its plain PyTorch version (what the wrapper
runs on CPU tensors) against beom_tpu's whole-solve kernel
make_vmem_cg_solve(precond='jacobi') in interpret mode, with
tests/unit/test_cg_vmem.py's bounds: the true residual within 20 x tol
|b|, x within 1e-6 x scale, and a warm start from the solution cutting
the iterations at least fourfold.  The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and
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


def test_mg_preconditioner_raises(case):
    _, _, cfg, grid, _ = case
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        cg_fused.make_cg_solve(grid, cfg, lam=0.0)        # auto -> mg
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        cg_fused.make_cg_solve(grid, cfg, lam=1e-3, precond="mg")
