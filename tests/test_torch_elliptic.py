"""The port's elliptic solvers (beom_tpu_torch/solvers/elliptic.py)
against beom_tpu.solvers.elliptic on the 64x48 rigid-lid grid at f64,
with seeded right-hand sides.  Operators and fixed sweep counts: 1e-13
relative to the reference's scale.  CG to solver_tol=1e-12: x within
1e-9 x scale, and the iteration counts within one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.solvers import elliptic as jel

from beom_tpu_torch.solvers import elliptic as el

from tests.torch_parity import assert_close, to_port

REL = 1e-13


@pytest.fixture(scope="module")
def grids():
    jcase = jax_make_case("rigid_lid", nx=64, ny=48, dtype="float64",
                          solver_tol=1e-12, solver_maxiter=2000)
    cfg, grid, _, _ = to_port(*jcase)
    return jcase[0], jcase[1], cfg, grid


def _field(seed, jgrid):
    """A seeded wet-masked field, for the reference and for the port."""
    m = np.asarray(jgrid.mask)
    a = np.random.default_rng(seed).standard_normal(m.shape) * m
    return jnp.asarray(a), torch.tensor(a)


def _lam(jcfg, kind):
    return 0.0 if kind == "neumann" else 1.0 / (jcfg.g * jcfg.dt ** 2)


def test_face_depths(grids):
    jcfg, jgrid, cfg, grid = grids
    for a, b in zip(el.face_depths(grid), jel.face_depths(jgrid)):
        assert_close(a, b, REL)


@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_laplacian_H(grids, kind):
    jcfg, jgrid, cfg, grid = grids
    lam = _lam(jcfg, kind)
    jp, p = _field(1, jgrid)
    ref = jel.laplacian_H(jp, *jel.face_depths(jgrid), jgrid, jcfg, lam=lam)
    out = el.laplacian_H(p, *el.face_depths(grid), grid, cfg, lam=lam)
    assert_close(out, ref, REL)


@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_jacobi_diag(grids, kind):
    jcfg, jgrid, cfg, grid = grids
    lam = _lam(jcfg, kind)
    for a, b in zip(el.jacobi_diag(grid, cfg, lam),
                    jel.jacobi_diag(jgrid, jcfg, lam)):
        assert_close(a, b, REL)


@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_ssor_precond(grids, kind):
    jcfg, jgrid, cfg, grid = grids
    lam = _lam(jcfg, kind)
    jr, r = _field(2, jgrid)
    ref = jel.make_ssor_precond(jgrid, jcfg, lam=lam, sweeps=2)(jr)
    out = el.make_ssor_precond(grid, cfg, lam=lam, sweeps=2)(r)
    assert_close(out, ref, REL)


@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_redblack_fixed_sweeps(grids, kind):
    jcfg, jgrid, cfg, grid = grids
    lam = _lam(jcfg, kind)
    jb, b = _field(3, jgrid)
    jx0, x0 = _field(4, jgrid)
    ref = jel.redblack_solve(jb, jgrid, jcfg, x0=jx0, lam=lam, sweeps=25)
    out = el.redblack_solve(b, grid, cfg, x0=x0, lam=lam, sweeps=25)
    assert_close(out, ref, REL)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("precond", ["jacobi", "ssor"])
@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_cg_solve(grids, kind, precond, warm):
    """lam = 0 runs the deflated single-reduction CG, lam > 0 the plain
    one; the warm start is a perturbed converged solution."""
    jcfg, jgrid, cfg, grid = grids
    lam = _lam(jcfg, kind)
    jb, b = _field(5, jgrid)
    jx0 = x0 = None
    if warm:
        x = np.asarray(jel.cg_solve(jb, jgrid, jcfg, lam=lam).x)
        x = x + 1e-3 * np.abs(x).max() * np.asarray(_field(6, jgrid)[0])
        jx0, x0 = jnp.asarray(x), torch.tensor(x)
    jkw, kw = {}, {}
    if precond == "ssor":
        jkw["precond"] = jel.make_ssor_precond(jgrid, jcfg, lam=lam)
        kw["precond"] = el.make_ssor_precond(grid, cfg, lam=lam)
    ref = jel.cg_solve(jb, jgrid, jcfg, x0=jx0, lam=lam, **jkw)
    out = el.cg_solve(b, grid, cfg, x0=x0, lam=lam, **kw)
    assert isinstance(out.iters, int) and out.iters > 0
    assert abs(out.iters - int(ref.iters)) <= 1
    assert_close(out.x, ref.x, 1e-9, "x")
    assert float(out.resnorm) <= 1e-24 * float(jnp.sum(jb * jb)) * 10
