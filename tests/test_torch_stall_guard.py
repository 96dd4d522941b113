"""The rigid lid's solve on shelf_forced (ROADMAP fault 3h): the fused
tier's cycle schedule against beom_tpu's, where it converges and where it
stalls CG in both packages, and the fused stepper's stall guard, which
redoes a stalled solve with the W-cycle as the reference's stepper does.

Inputs come from beom_tpu's case through convert.py; everything runs on
the CPU, where the fused stepper takes the kernels' plain versions.
"""

import dataclasses

import jax
import numpy as np

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.stepping import prepare_state as j_prepare_state

from beom_tpu_torch.stencils import cg_fused, fused_projection
from beom_tpu_torch.stepping import make_stepper, prepare_state

from tests.torch_parity import assert_close, perturb, to_port


def test_shelf_rigid_lid_mg_solves_match_reference():
    """The rigid lid's solve on shelf_forced (open faces, the tide, two
    layers) at f64 with the multigrid preconditioner, against beom_tpu's
    cg_solve on the same right-hand side: the eager tier's W-cycle and the
    fused tier's schedule (V on the deepest two transitions) each take the
    reference's iteration count and reach its solution within 1e-10 x
    scale, and both converge at this size."""
    from beom_tpu.solvers import elliptic as jell
    from beom_tpu.solvers import multigrid as jmg
    from beom_tpu_torch.solvers import elliptic, multigrid
    from beom_tpu_torch.stepping import projection

    jcfg, jgrid, jforcing, jst = jax_make_case(
        "shelf_forced", nx=128, ny=96, dtype="float64", scheme="rigid_lid")
    jst = j_prepare_state(perturb(jcfg, jgrid, jst, 5), jcfg)
    cfg, grid, forcing, st = to_port(jcfg, jgrid, jforcing, jst)
    _, _, div = fused_projection.proj_a_plain(st.h, st.u, st.v,
                                              (grid, forcing), 0, cfg)
    rhs = projection.rigid_rhs(st.h, div, grid, cfg)
    jrhs = jax.numpy.asarray(rhs.numpy())
    b2 = float((rhs * rhs).sum())
    jlevels = jmg.build_levels(jgrid, jcfg, 0.0, min_size=16)
    schedule = jmg._pallas_gamma_schedule(jlevels, 2)
    assert schedule == multigrid.fused_gamma_schedule(
        multigrid.build_levels(grid, cfg, 0.0), 2) == (1, 1)
    pairs = [
        (elliptic.cg_solve(rhs, grid, cfg,
                           precond=multigrid.make_mg_precond(grid, cfg)),
         jell.cg_solve(jrhs, jgrid, jcfg,
                       precond=jmg.make_mg_precond(jgrid, jcfg))),
        (cg_fused.cg_solve_plain(rhs, grid, cfg, precond="mg"),
         jell.cg_solve(jrhs, jgrid, jcfg, precond=jmg.make_mg_precond(
             jgrid, jcfg, gamma=schedule)))]
    for res, ref in pairs:
        assert res.iters == int(ref.iters) < cfg.solver_maxiter
        assert float(res.resnorm) <= cfg.solver_tol ** 2 * b2
        assert_close(res.x, ref.x, 1e-10, "x")


def test_stall_guard_redoes_the_solve_with_the_w_cycle():
    """A multigrid-preconditioned fused solve that ends far above its
    tolerance (here: cut after 3 iterations) is redone with the W-cycle at
    every transition, the eager tier's preconditioner, as the reference's
    stepper does: the step then equals the eager step bit for bit, and the
    guard counts one redone solve per step.  A solve that converges is
    left alone."""
    from beom_tpu_torch.cases import make_case

    cfg, grid, forcing, st = make_case(
        "shelf_forced", nx=64, ny=48, device="cpu", dtype="float64",
        scheme="rigid_lid", backend="fused", solver_maxiter=3)
    st = prepare_state(st, cfg)
    fused = make_stepper(grid, forcing, cfg)
    eager = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="eager"))
    before = fused_projection.COUNTS["stalled"]
    a = b = st
    for _ in range(2):
        a, b = fused(a), eager(b)
    assert fused_projection.COUNTS["stalled"] == before + 2
    for f in ("h", "u", "v", "phi"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)
    converging = make_stepper(grid, forcing, dataclasses.replace(
        cfg, solver_maxiter=500))
    converging(st)
    assert fused_projection.COUNTS["stalled"] == before + 2


def test_fused_cycle_schedule_stalls_on_the_shelf_in_both_packages():
    """Fault 3h: on shelf_forced under the rigid lid at 512^2 f32 (the
    first step's right-hand side, from rest) CG preconditioned with the
    fused tier's cycle schedule, V on the deepest two transitions, stalls
    in beom_tpu as in the port: after 40 iterations |r|^2 is still above
    1e-4 |b|^2 in both, where the W-cycle at every transition has
    converged to the float32 tolerance in both with the same iteration
    count.  This is what the fused stepper's stall guard is for."""
    from beom_tpu.solvers import elliptic as jell
    from beom_tpu.solvers import multigrid as jmg
    from beom_tpu_torch.solvers import elliptic, multigrid
    from beom_tpu_torch.stepping import projection

    jcfg, jgrid, jforcing, jst = jax_make_case(
        "shelf_forced", nx=512, ny=512, dtype="float32", scheme="rigid_lid",
        solver_maxiter=40)
    cfg, grid, forcing, st = to_port(jcfg, jgrid, jforcing, jst)
    _, _, div = fused_projection.proj_a_plain(st.h, st.u, st.v,
                                              (grid, forcing), 0, cfg)
    rhs = projection.rigid_rhs(st.h, div, grid, cfg)
    jrhs = jax.numpy.asarray(rhs.numpy())
    b2 = float((rhs * rhs).sum())
    schedule = jmg._pallas_gamma_schedule(
        jmg.build_levels(jgrid, jcfg, 0.0, min_size=16), 2)
    assert schedule == (2, 2, 2, 1, 1)
    stalled = (
        cg_fused.cg_solve_plain(rhs, grid, cfg, precond="mg"),
        jell.cg_solve(jrhs, jgrid, jcfg, precond=jmg.make_mg_precond(
            jgrid, jcfg, gamma=schedule)))
    for res in stalled:
        assert int(res.iters) == 40 and float(res.resnorm) > 1e-4 * b2
    w_cycle = (
        elliptic.cg_solve(rhs, grid, cfg,
                          precond=multigrid.make_mg_precond(grid, cfg)),
        jell.cg_solve(jrhs, jgrid, jcfg,
                      precond=jmg.make_mg_precond(jgrid, jcfg)))
    tol = 30.0 * float(np.finfo(np.float32).eps)
    for res in w_cycle:
        assert int(res.iters) < 40 and float(res.resnorm) <= tol ** 2 * b2
    assert int(w_cycle[0].iters) == int(w_cycle[1].iters)
