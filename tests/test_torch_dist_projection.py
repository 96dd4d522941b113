"""The port's distributed projection steps and their solvers
(beom_tpu_torch/parallel/dist.py with the hooks of solvers/elliptic.py and
solvers/multigrid.py): the rigid lid with CG + multigrid, CG + SSOR and
red-black, and the implicit free surface, on a mesh of CPU shards against
the port on one device and against beom_tpu's make_dist_stepper on the 8
virtual devices, at the tolerances tests/dist/test_equivalence.py pins
(1e-8 for the CG solves, whose iteration counts may differ through the
order of the mesh sums; 1e-10 for red-black, which has no reduction)."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.parallel import dist as jdist
from beom_tpu.parallel import halo as jhalo
from beom_tpu.parallel.mesh import make_mesh as j_make_mesh
from beom_tpu.parallel.mesh import shard_state as j_shard_state
from beom_tpu.parallel.mesh import spec_for
from beom_tpu.solvers import multigrid as jmg
from beom_tpu.stepping import prepare_state as j_prepare_state

from beom_tpu_torch.parallel import dist, halo
from beom_tpu_torch.parallel.mesh import (gather, gather_state, make_mesh,
                                          shard, shard_state)
from beom_tpu_torch.solvers import elliptic, multigrid
from beom_tpu_torch.stepping import prepare_state, run_steps

from tests.torch_parity import perturb, to_port

CONFIGS = {
    "rigid_lid-cg-mg": (dict(), 1e-8),
    "rigid_lid-cg-ssor": (dict(precond="ssor"), 1e-8),
    "rigid_lid-redblack": (dict(solver="redblack", solver_maxiter=150),
                           1e-10),
    "implicit_fs-cg": (dict(scheme="implicit_fs"), 1e-8),
}


def _cases(seed=11, nx=64, ny=64, **kw):
    jcfg, jgrid, jforcing, jst = jax_make_case("rigid_lid", nx=nx, ny=ny,
                                               dtype="float64", **kw)
    jst = j_prepare_state(perturb(jcfg, jgrid, jst, seed), jcfg)
    return (jcfg, jgrid, jforcing, jst), to_port(jcfg, jgrid, jforcing, jst)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_projection_matches_single_device_and_reference(name):
    kw, atol = CONFIGS[name]
    n = 3
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _cases(**kw)
    ref = run_steps(st, grid, forcing, cfg, n)
    mesh = make_mesh(2, 4, devices=["cpu"])
    out = gather_state(dist.make_dist_stepper(
        grid, forcing, cfg, mesh, n_inner=n)(shard_state(st, mesh)))
    jmesh = j_make_mesh(2, 4)
    jout = jdist.make_dist_stepper(jgrid, jforcing, jcfg, jmesh, n_inner=n)(
        j_shard_state(jst, jmesh))
    assert out.n == n and out.phi is not None
    for f in ("h", "u", "v", "phi"):
        a = getattr(out, f).numpy()
        np.testing.assert_allclose(a, getattr(ref, f).numpy(), rtol=0,
                                   atol=atol, err_msg=f"{f}: 1 vs N")
        np.testing.assert_allclose(a, np.asarray(getattr(jout, f)), rtol=0,
                                   atol=atol, err_msg=f"{f}: vs beom_tpu")
    assert float(ref.u.abs().max()) > 0


def _solve_inputs(scheme, **kw):
    """The pieces of one distributed solve on a 2 x 2 mesh: the local and
    the 1-halo statics, a right-hand side, and lam."""
    _, (cfg, grid, forcing, st) = _cases(scheme=scheme, **kw)
    mesh = make_mesh(2, 2, devices=["cpu"])
    pgrid, _ = dist.pad_statics(grid, forcing, cfg, mesh, 1)
    grid_l = dist._crop_tree(pgrid, 1)
    lam = 0.0 if scheme == "rigid_lid" else 1.0 / (cfg.g * cfg.dt ** 2)
    b = shard((st.h[0] - grid.H) * grid.mask, mesh)
    return cfg, grid, grid_l, pgrid, b, lam


@pytest.mark.parametrize("precond", ["auto", "jacobi"])
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
def test_one_reduction_per_cg_iteration(scheme, precond):
    """The counter of mesh reductions grows by exactly one per CG
    iteration, with the multigrid cycle (no de-mean) as with Jacobi: what
    tests/dist/test_single_reduction.py reads off the compiled loop."""
    import dataclasses

    cfg, _, grid_l, pgrid, b, lam = _solve_inputs(scheme, precond=precond,
                                                  solver_tol=1e-30)
    counts = []
    for maxiter in (2, 5):
        halo.reset_counts()
        dist._dist_solve(b, grid_l, pgrid, dataclasses.replace(
            cfg, solver_maxiter=maxiter), lam=lam)
        counts.append(halo.COUNTS["reductions"])
    assert counts[1] - counts[0] == 3


@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
def test_matvec_moves_thin_slices_only(scheme):
    """The halo-pipelined matvec exchanges four 1-wide edge strips per
    shard and no block: 2 (ly + lx) values per shard and application; and
    it equals the single-device operator."""
    cfg, grid, grid_l, pgrid, b, lam = _solve_inputs(scheme)
    ly, lx = b.shape
    halo.reset_counts()
    q = dist._cg_matvec(b, pgrid, cfg, lam)
    assert halo.COUNTS == {"reductions": 0,
                           "moved": b.mesh.n * 2 * (ly + lx)}
    Hu, Hv = elliptic.face_depths(grid)
    ref = elliptic.laplacian_H(gather(b), Hu, Hv, grid, cfg, lam=lam)
    np.testing.assert_allclose(gather(q).numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 * float(ref.abs().max()))


def test_build_dist_levels_match_reference():
    """The shard-local hierarchy level for level against beom_tpu's, built
    under shard_map on the same mesh.  nwet is left out: the reference
    hands the mesh psum the mask itself and gets a per-position count,
    which nothing reads (the distributed cycle runs without the de-mean);
    the port computes the scalar count."""
    (jcfg, jgrid, jforcing, _), (cfg, grid, forcing, _) = _cases()
    fields = ("mask", "Hu", "Hv", "Hu_w", "Hv_s", "inv_diag", "red", "black")
    jmesh = j_make_mesh(2, 4)
    jpg1, _ = jdist.pad_statics(jgrid, jforcing, jcfg, jmesh, 1)

    def body(pg):
        lv = jmg.build_dist_levels(pg, jcfg, 0.0, jhalo.pad2d, jhalo.crop2d,
                                   jhalo.psum2, jdist._global_checkerboard)
        return [[getattr(level, f) for f in fields] for level in lv]

    # blocks of (32, 16) coarsen once: (16, 8) is at min_local = 8
    specs = jax.tree.map(spec_for, jpg1)
    jlv = jax.jit(shard_map(
        body, mesh=jmesh, in_specs=(specs,),
        out_specs=[[P("y", "x")] * len(fields)] * 2))(jpg1)

    mesh = make_mesh(2, 4, devices=["cpu"])
    pgrid, _ = dist.pad_statics(grid, forcing, cfg, mesh, 1)
    levels = multigrid.build_dist_levels(
        pgrid, cfg, 0.0, halo.pad2d, halo.crop2d,
        lambda a: halo.psum2(torch.sum(a)),
        functools.partial(dist._global_checkerboard, mesh=mesh))
    assert len(levels) == len(jlv) == 2
    for k, (lv, jl) in enumerate(zip(levels, jlv)):
        assert lv.mask.shape == (32 >> k, 16 >> k)
        for f, ref in zip(fields, jl):
            np.testing.assert_allclose(
                gather(getattr(lv, f)).numpy(), np.asarray(ref), rtol=1e-15,
                atol=0, err_msg=f"level {k} {f}")
        assert float(lv.nwet) == float(np.asarray(jl[0]).sum())


def test_dist_mg_precond_is_the_single_device_cycle():
    """The distributed cycle with its exchange hooks equals the
    single-device cycle on the gathered field when the hierarchies have
    the same depth (min_size = 8 x the mesh extent)."""
    _, (cfg, grid, forcing, st) = _cases()
    mesh = make_mesh(2, 2, devices=["cpu"])
    pgrid, _ = dist.pad_statics(grid, forcing, cfg, mesh, 1)
    r = (st.h[0] - grid.H) * grid.mask
    pre = multigrid.make_dist_mg_precond(
        pgrid, cfg, 0.0, pad=halo.pad2d, crop=halo.crop2d,
        gsum=lambda a: halo.psum2(torch.sum(a)),
        red_fn=functools.partial(dist._global_checkerboard, mesh=mesh),
        nbr=dist._make_mg_nbr())
    halo.reset_counts()
    z = gather(pre(shard(r, mesh)))
    assert halo.COUNTS["reductions"] == 0       # no de-mean: no mesh sum
    levels = multigrid.build_levels(grid, cfg, 0.0, min_size=16)
    ref = multigrid.cycle_precond(levels, 0.0)(r)
    np.testing.assert_allclose(z.numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 * float(ref.abs().max()))


def test_dist_solve_refuses_standalone_multigrid():
    import dataclasses

    cfg, _, grid_l, pgrid, b, lam = _solve_inputs("rigid_lid")
    # Config refuses solver='mg' with a mesh; the solve refuses it too
    with pytest.raises(NotImplementedError, match="single-device"):
        dist._dist_solve(b, grid_l, pgrid, dataclasses.replace(
            cfg, solver="mg"), lam=lam)
    with pytest.raises(ValueError, match="single-device"):
        dataclasses.replace(cfg, solver="mg", mesh_x=2)


def test_prepare_state_attaches_sharded_carry():
    _, (cfg, grid, forcing, st) = _cases(nx=32, ny=32)
    mesh = make_mesh(2, 2, devices=["cpu"])
    bare = shard_state(st.replace(phi=None, phi_prev=None), mesh)
    s = prepare_state(bare, cfg)
    assert s.phi.shape == (16, 16) and float(gather(s.phi).abs().max()) == 0
