"""The port's multigrid (beom_tpu_torch/solvers/multigrid.py) against
beom_tpu/solvers/multigrid.py at f64 on CPU: the level hierarchy, the
transfers, the operator and half-sweep, one cycle in each form, the
preconditioner's symmetry, the standalone solver at a matched cycle count
and CG + multigrid; and the eager rigid-lid steps with the default solve
and with solver='mg' against beom_tpu's.

The standalone solver's stopping rule differs from the reference's on
purpose: the reference takes a new best iterate only on a 25 % gain in
|r|^2 (its multigrid.py:671) and can return the initial guess under slow
steady convergence; the port takes any improvement and uses the 25 % only
for the patience counter.  The comparisons run where every cycle gains
more than 25 %, so both return the last iterate."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.solvers import elliptic as jel
from beom_tpu.solvers import multigrid as jmg
from beom_tpu.stepping import get_step as j_get_step
from beom_tpu.stepping import prepare_state as j_prepare_state

from beom_tpu_torch.solvers import elliptic as el
from beom_tpu_torch.solvers import multigrid as mg
from beom_tpu_torch.stepping import get_step

from tests.torch_parity import assert_close, perturb, to_port

FIELDS = ("mask", "Hu", "Hv", "Hu_w", "Hv_s", "inv_diag", "red", "black")


def _problem(nx, ny, seed=7, **kw):
    """(JAX cfg, JAX grid, port cfg, port grid, de-meaned wet RHS)."""
    jcase = jax_make_case("rigid_lid", nx=nx, ny=ny, dtype="float64", **kw)
    cfg, grid, _, _ = to_port(*jcase)
    m = np.asarray(jcase[1].mask)
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(m.shape) * m
    b = (b - m * b.sum() / m.sum()) * m
    return jcase[0], jcase[1], cfg, grid, b


@pytest.fixture(scope="module")
def sq():
    return _problem(64, 64, solver_tol=1e-11, solver_maxiter=200)


@pytest.fixture(scope="module")
def levels(sq):
    jcfg, jgrid, cfg, grid, _ = sq
    return (jmg.build_levels(jgrid, jcfg, 0.0),
            mg.build_levels(grid, cfg, 0.0))


@pytest.mark.parametrize("nx,ny,lam", [(64, 64, 0.0), (64, 64, 1e-9),
                                       (200, 136, 0.0)])
def test_build_levels_match(nx, ny, lam):
    """Every level's fields bit for bit; 200x136 ends on an odd 25x17."""
    jcfg, jgrid, cfg, grid, _ = _problem(nx, ny)
    jl = jmg.build_levels(jgrid, jcfg, lam)
    tl = mg.build_levels(grid, cfg, lam)
    assert [tuple(lv.mask.shape) for lv in tl] == \
        [tuple(lv.mask.shape) for lv in jl]
    if nx == 200:
        assert tuple(tl[-1].mask.shape) == (17, 25)
    for j, (a, b) in enumerate(zip(jl, tl)):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)),
                                          err_msg=f"level {j} {f}")
        assert (b.rdx2, b.rdy2) == (a.rdx2, a.rdy2)
        assert float(b.nwet) == float(a.nwet)


def test_transfers_operator_halfsweep_match(levels):
    """_restrict2, _prolong2, _apply_A and _halfsweep (both colours) on
    every level, bit for bit."""
    jl, tl = levels
    rng = np.random.default_rng(1)
    for j, (a, b) in enumerate(zip(jl, tl)):
        x = rng.standard_normal(tuple(b.mask.shape))
        rhs = rng.standard_normal(tuple(b.mask.shape))
        pairs = [(jmg._apply_A(a, jnp.asarray(x), 0.0),
                  mg._apply_A(b, torch.tensor(x), 0.0)),
                 (jmg._apply_A(a, jnp.asarray(x), 1e-9),
                  mg._apply_A(b, torch.tensor(x), 1e-9)),
                 (jmg._prolong2(jnp.asarray(x)), mg._prolong2(torch.tensor(x)))]
        for colour in ("red", "black"):
            pairs.append((jmg._halfsweep(a, jnp.asarray(x), jnp.asarray(rhs),
                                         getattr(a, colour)),
                          mg._halfsweep(b, torch.tensor(x), torch.tensor(rhs),
                                        getattr(b, colour))))
        if j + 1 < len(tl):
            pairs.append((jmg._restrict2(jnp.asarray(x)),
                          mg._restrict2(torch.tensor(x))))
        for k, (ref, port) in enumerate(pairs):
            np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                          err_msg=f"level {j} pair {k}")


@pytest.mark.parametrize("gamma,krylov,demean", [
    (1, 0, True), (2, 0, True), (2, 0, False), ("fused", 0, False),
    (2, 2, True)])
def test_vcycle_matches(levels, sq, gamma, krylov, demean):
    """One cycle (V, W, the fused schedule, the K-cycle) from the same
    RHS: within 1e-13 x scale (the de-mean's and the K-cycle's sums run
    in torch.sum's order, not XLA's)."""
    jl, tl = levels
    b = sq[4]
    g_j = jmg._pallas_gamma_schedule(jl, 2) if gamma == "fused" else gamma
    g_t = mg.fused_gamma_schedule(tl, 2) if gamma == "fused" else gamma
    assert g_j == g_t
    ref = jmg._vcycle(jl, 0, jnp.asarray(b), 0.0, 2, 24, demean=demean,
                      gamma=g_j, krylov=krylov)
    out = mg._vcycle(tl, 0, torch.tensor(b), 0.0, 2, 24, demean=demean,
                     gamma=g_t, krylov=krylov)
    assert_close(out, ref, 1e-13, f"gamma={gamma} krylov={krylov}")


@pytest.mark.parametrize("smoother", ["eager", "fused"])
def test_mg_precond_symmetric(sq, smoother):
    """z1'r2 == z2'r1 to 1e-10 (tests/unit/test_multigrid.py's check): on
    CPU tensors the fused tier runs its kernels' plain versions, which
    are as symmetric as the eager cycle."""
    _, _, cfg, grid, b = sq
    M = mg.make_mg_precond(grid, cfg, smoother=smoother)
    rng = np.random.default_rng(3)
    r1 = torch.tensor(rng.normal(size=b.shape)) * grid.mask
    r2 = torch.tensor(rng.normal(size=b.shape)) * grid.mask
    a, c = float(torch.sum(M(r1) * r2)), float(torch.sum(M(r2) * r1))
    assert abs(a - c) < 1e-10 * max(abs(a), abs(c))


@pytest.mark.parametrize("cycles", [1, 2, 4])
@pytest.mark.parametrize("lam", [0.0, 1e-9])
def test_mg_solve_matches_at_matched_cycles(sq, cycles, lam):
    """mg_solve with maxiter = `cycles` and a tolerance it cannot reach,
    against beom_tpu's: within 1e-11 x scale.  Neither is converged after
    a few cycles (ROADMAP fault 3d), so they are held at a matched cycle
    count; every cycle here gains > 25 %, where the two stopping rules
    agree."""
    jcfg, jgrid, cfg, grid, b = sq
    ref = jmg.mg_solve(jnp.asarray(b), jgrid, jcfg, lam=lam, tol=1e-30,
                       maxiter=cycles)
    out = mg.mg_solve(torch.tensor(b), grid, cfg, lam=lam, tol=1e-30,
                      maxiter=cycles)
    assert_close(out, ref, 1e-11, f"{cycles} cycles")


def test_mg_solver_converges(sq):
    """The eager and fused (plain versions on CPU) solvers both reach
    the tolerance, and agree with CG + multigrid on the gauge-fixed
    solution (tests/unit/test_multigrid.py)."""
    _, _, cfg, grid, b = sq
    bt = torch.tensor(b)
    Hu, Hv = el.face_depths(grid)
    nwet = grid.mask.sum()
    xs = []
    for smoother in ("eager", "fused"):
        x = mg.make_mg_solver(grid, cfg, smoother=smoother)(bt)
        r = (bt - el.laplacian_H(x, Hu, Hv, grid, cfg)) * grid.mask
        assert float(r.norm() / bt.norm()) < 1e-9, smoother
        xs.append(x - grid.mask * x.sum() / nwet)
    x_cg = el.cg_solve(bt, grid, cfg,
                       precond=mg.make_mg_precond(grid, cfg)).x
    x_cg = x_cg - grid.mask * x_cg.sum() / nwet
    for x in xs:
        assert float((x - x_cg).abs().max()) < 1e-7 * (
            float(x_cg.abs().max()) + 1.0)


def test_cg_with_mg_matches(sq):
    """elliptic.cg_solve preconditioned by make_mg_precond against
    beom_tpu's: the iteration counts within 1, x within 1e-9 x scale."""
    jcfg, jgrid, cfg, grid, b = sq
    ref = jel.cg_solve(jnp.asarray(b), jgrid, jcfg,
                       precond=jmg.make_mg_precond(jgrid, jcfg))
    out = el.cg_solve(torch.tensor(b), grid, cfg,
                      precond=mg.make_mg_precond(grid, cfg))
    assert 0 < out.iters <= 25
    assert abs(out.iters - int(ref.iters)) <= 1
    assert_close(out.x, ref.x, 1e-9, "x")


def _reference_rule(seq):
    """The reference's bookkeeping (multigrid.py:658-683) over |r|^2 of
    the initial guess then of each cycle: the index it returns."""
    best_i, best, since = 0, seq[0], 0
    for i, rr in enumerate(seq[1:], 1):
        if since >= mg.PATIENCE:
            break
        if rr < 0.75 * best:
            best_i, best, since = i, rr, 0
        else:
            since += 1
    return best_i


def _port_rule(seq):
    best_i, best, ref, since = 0, seq[0], seq[0], 0
    for i, rr in enumerate(seq[1:], 1):
        if since >= mg.PATIENCE:
            break
        better, best, ref, since = mg.track_best(rr, best, ref, since)
        if better:
            best_i = i
    return best_i


@pytest.mark.parametrize("seq,ref_i,port_i", [
    # slow steady convergence: the reference returns the initial guess
    ([1.0, 0.9, 0.85, 0.8, 0.78, 0.76], 0, 3),
    # a transient rise, then fast convergence: both take the last
    ([1.0, 2.0, 0.5, 0.1, 0.01], 4, 4),
    # a small gain after a big one: the port keeps the better iterate
    ([1.0, 0.5, 0.45, 0.44, 0.6, 0.7], 1, 3),
])
def test_stopping_rule_takes_any_improvement(seq, ref_i, port_i):
    """ROADMAP fault 3b: the index of the iterate each rule returns."""
    assert _reference_rule(seq) == ref_i
    assert _port_rule(seq) == port_i


def _steps_pair(name, seed=5):
    jcfg, jgrid, jforcing, jst = jax_make_case(
        "rigid_lid", nx=32, ny=32, dtype="float64", solver_tol=1e-13,
        solver_maxiter=200, **({"solver": "mg"} if name == "mg" else {}))
    jst = j_prepare_state(perturb(jcfg, jgrid, jst, seed), jcfg)
    return (jcfg, jgrid, jforcing, jst), to_port(jcfg, jgrid, jforcing, jst)


@pytest.mark.parametrize("name", ["cg-auto", "mg"])
def test_eager_rigid_lid_steps_match(name):
    """3 eager rigid-lid steps at f64 with the default solve (CG + the
    multigrid preconditioner) and with solver='mg', against beom_tpu's
    XLA steps: 1e-10 x each field's scale (the solver tolerance
    amplifying the ulp-level differences of the reductions)."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _steps_pair(name)
    assert (cfg.solver, cfg.precond) == (jcfg.solver, "auto")
    jstep = jax.jit(lambda s: j_get_step(jcfg)(s, jgrid, jforcing, jcfg))
    step = get_step(cfg)
    for _ in range(3):
        jst = jstep(jst)
        st = step(st, grid, forcing, cfg)
    for f in ("h", "u", "v", "phi", "phi_prev"):
        assert_close(getattr(st, f), getattr(jst, f), 1e-10, f)


def test_mg_solver_rejects_unknown_smoother(sq):
    _, _, cfg, grid, _ = sq
    with pytest.raises(ValueError, match="smoother"):
        mg.make_mg_solver(grid, dataclasses.replace(cfg), smoother="xla")
    with pytest.raises(ValueError, match="smoother"):
        mg.make_mg_precond(grid, cfg, smoother="pallas")
