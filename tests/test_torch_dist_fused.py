"""The split step and the projection phases on the shards of a mesh (K7
around the split body and around the projection phases,
beom_tpu_torch/stencils/dist_band.py) on CPU blocks, where they run their
plain versions: each kernel's plain version per shard equal to the
single-device eager phase; make_dist_stepper with backend='fused' against
beom_tpu's make_dist_pallas_stepper / make_dist_pallas_projection_stepper in
interpret mode at the sizes and tolerances of
tests/dist/test_pallas_dist.py; one mesh reduction per CG iteration through
the fused projection stepper; and the guard on a block too small for the
subcycle's halo."""

import dataclasses

import numpy as np
import pytest
import torch

from beom_tpu.parallel.dist import make_dist_stepper as j_make_dist_stepper
from beom_tpu.parallel.mesh import make_mesh as j_make_mesh
from beom_tpu.parallel.mesh import shard_state as j_shard_state

from beom_tpu_torch.parallel import halo
from beom_tpu_torch.parallel.dist import make_dist_stepper
from beom_tpu_torch.parallel.mesh import (gather, gather_state, make_mesh,
                                          shard, shard_state)
from beom_tpu_torch.stencils import dist_band, fused_fb, fused_projection
from beom_tpu_torch.stepping import prepare_state, run_steps, split

from tests.test_torch_dist_band import CASES, _port_case

MESHES = ((2, 4), (4, 1))


def _equal(label, outs, refs):
    for i, (a, b) in enumerate(zip(outs, refs)):
        assert torch.equal(gather(a), b), (label, i)


@pytest.mark.parametrize("nsub", [2, 8, 12])
@pytest.mark.parametrize("case", list(CASES))
def test_split_plain_equals_single_device_phases(case, nsub):
    """The slow phase (halo 2), the subcycle (halo nsub: one ring of error
    per substep from the unknown rim) and the recomposition with finalize
    (halo 2, 3 under wet/dry), each as pad2d, the eager phase on the padded
    blocks and crop2d, from the same inputs: bit for bit the single-device
    eager phases at f64, from a time at which the tides are on."""
    _, (cfg, grid, forcing, st) = _port_case(case, nx=96, ny=64,
                                             scheme="split", nsub=nsub,
                                             **CASES[case])
    st = st.replace(t=cfg.npdtype.type(5 * cfg.dt))
    sp = split.slow_phase(st, grid, forcing, cfg)
    sub_ref = split.subcycle_phase(sp, grid, cfg)
    rec_ref = fused_fb.split_recompose(sp, sub_ref, st.h, st.u, st.v,
                                       (grid, forcing), st.t, cfg)
    assert dist_band.shard_halo(cfg) == fused_fb.tail_halo(cfg) \
        == nsub + (2 if cfg.wetdry else 1) + int(cfg.wetdry or cfg.obc)
    before = dict(dist_band.LAUNCHES)
    for mesh_shape in MESHES:
        mesh = make_mesh(*mesh_shape, devices=["cpu"])
        pstat = dist_band.pad_statics(grid, forcing, cfg, mesh)
        sh = [shard(a, mesh) for a in (st.h, st.u, st.v)]
        slow = dist_band.shard_split_slow(*sh, pstat, cfg, kernels=None)
        _equal(f"slow {mesh_shape}", slow, fused_fb._slow_fields(sp, cfg))
        sub = dist_band.shard_split_subcycle(slow, pstat, cfg,
                                               kernels=None)
        _equal(f"subcycle {mesh_shape}", sub, sub_ref)
        rec = dist_band.shard_split_recompose(slow, sub, sh[0], pstat, st.t,
                                              cfg, kernels=None)
        _equal(f"recompose {mesh_shape}", rec, rec_ref)
    assert dist_band.LAUNCHES == before       # CPU blocks launch nothing


@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("case", list(CASES))
def test_projection_plain_equals_single_device_phases(case, scheme):
    """Phase A (halo 4) and phase B (halo 1 to 3 by build) as pad2d, the
    plain phase on the padded blocks and crop2d: bit for bit the
    single-device plain phases at f64, at both sweep parities."""
    _, (cfg, grid, forcing, st) = _port_case(case, nx=96, ny=64,
                                             scheme=scheme, **CASES[case])
    st = st.replace(t=cfg.npdtype.type(5 * cfg.dt))
    statics = (grid, forcing)
    rng = np.random.default_rng(31)
    p = torch.tensor(0.1 * rng.standard_normal((cfg.ny, cfg.nx))) \
        * grid.mask
    assert dist_band.shard_halo(cfg) == 4
    for mesh_shape in MESHES:
        mesh = make_mesh(*mesh_shape, devices=["cpu"])
        pstat = dist_band.pad_statics(grid, forcing, cfg, mesh)
        sh = [shard(a, mesh) for a in (st.h, st.u, st.v)]
        for n in (0, 1):
            a = dist_band.shard_proj_a(*sh, pstat, n, cfg, kernels=None)
            a_ref = fused_projection.proj_a_plain(st.h, st.u, st.v, statics,
                                                  n, cfg)
            _equal(f"A {mesh_shape} n={n}", a, a_ref)
            b = dist_band.shard_proj_b(sh[0], a[0], a[1], shard(p, mesh),
                                       pstat, st.t, cfg, kernels=None)
            _equal(f"B {mesh_shape} n={n}", b, fused_projection.proj_b_plain(
                st.h, a_ref[0], a_ref[1], p, statics, st.t, cfg))


@pytest.mark.parametrize("case,mesh_shape,nx,ny,kw,n,atol", [
    ("double_gyre", (2, 2), 64, 192, dict(scheme="split", nsub=2), 6,
     1e-11),
    ("double_gyre", (2, 1), 64, 256, dict(scheme="split", nsub=8), 6,
     1e-11),
    ("rigid_lid", (2, 2), 64, 192, {}, 6, 1e-8),
    ("double_gyre", (2, 2), 64, 192, dict(scheme="implicit_fs"), 6, 1e-8),
])
def test_fused_mesh_stepper_matches_pallas_interpret(case, mesh_shape, nx,
                                                     ny, kw, n, atol):
    """make_dist_stepper with backend='fused' against the TPU kernels it
    replaces, run as tests/dist/test_pallas_dist.py runs them (the Pallas
    TPU interpreter on the virtual mesh), at its sizes and tolerances:
    split 1e-11; the rigid lid (CG + multigrid) and the implicit free
    surface (CG + Jacobi) 1e-8, the bar of an iterative solve whose mesh
    sums run in another order; the split step also bit for bit the
    single-device step."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _port_case(
        case, nx=nx, ny=ny, backend="pallas", **kw)
    assert cfg.backend == "fused"
    jmesh = j_make_mesh(*mesh_shape)
    jout = j_make_dist_stepper(jgrid, jforcing, jcfg, jmesh, n_inner=n)(
        j_shard_state(jst, jmesh))
    mesh = make_mesh(*mesh_shape, devices=["cpu"])
    out = gather_state(make_dist_stepper(grid, forcing, cfg, mesh,
                                         n_inner=n)(shard_state(st, mesh)))
    assert out.n == int(jout.n) == n
    ref = run_steps(st, grid, forcing, cfg, n)
    for f in "huv":
        a = getattr(out, f).numpy()
        np.testing.assert_allclose(a, np.asarray(getattr(jout, f)), rtol=0,
                                   atol=atol, err_msg=f"{f}: vs beom_tpu")
        b = getattr(ref, f).numpy()
        if cfg.scheme == "split":
            np.testing.assert_array_equal(a, b, err_msg=f"{f}: 1 vs N")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=f"{f}: 1 vs N")
    if cfg.scheme != "split":
        assert out.phi is not None and out.phi_prev is not None
    assert float(ref.u.abs().max()) > 0


@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
def test_fused_projection_stepper_equals_eager_mesh_step(scheme):
    """The fused projection stepper runs the eager mesh step's right-hand
    side and solve (parallel/dist.py::solve_pressure), and its phases
    equal the eager mesh step's on CPU blocks: 3 steps bit for bit."""
    _, (cfg, grid, forcing, st) = _port_case("rigid_lid", nx=64, ny=96,
                                             scheme=scheme,
                                             precond="jacobi")
    mesh = make_mesh(2, 2, devices=["cpu"])
    fused = dataclasses.replace(cfg, backend="fused")
    eager = dataclasses.replace(cfg, backend="eager")
    a = gather_state(make_dist_stepper(grid, forcing, fused, mesh,
                                       n_inner=3)(shard_state(st, mesh)))
    b = gather_state(make_dist_stepper(grid, forcing, eager, mesh,
                                       n_inner=3)(shard_state(st, mesh)))
    for f in ("h", "u", "v", "phi", "phi_prev"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.n == b.n == 3 and a.t == b.t


@pytest.mark.parametrize("precond", ["auto", "jacobi"])
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
def test_one_reduction_per_cg_iteration_through_the_fused_step(scheme,
                                                               precond):
    """Through the fused projection stepper, the counter of mesh
    reductions grows by exactly one per CG iteration (the rigid lid's
    de-mean adds two per step, the same at any iteration count), with the
    multigrid cycle as with Jacobi."""
    _, (cfg, grid, forcing, st) = _port_case(
        "rigid_lid", nx=64, ny=64, scheme=scheme, precond=precond,
        backend="pallas", solver_tol=1e-30)
    mesh = make_mesh(2, 2, devices=["cpu"])
    counts = []
    for maxiter in (2, 5):
        step = make_dist_stepper(grid, forcing, dataclasses.replace(
            cfg, solver_maxiter=maxiter), mesh)
        state = shard_state(prepare_state(st, cfg), mesh)
        halo.reset_counts()
        step(state)
        counts.append(halo.COUNTS["reductions"])
    assert counts[1] - counts[0] == 3


@pytest.mark.parametrize("scheme,nx", [("split", 64), ("rigid_lid", 24)])
def test_block_smaller_than_the_halo_raises(scheme, nx):
    """A shard's block must hold the widest halo its kernels read: the
    subcycle's nsub for split (12 > a 64 / 8 block), phase A's 4 for the
    projection schemes (24 / 8 = 3)."""
    _, (cfg, grid, forcing, st) = _port_case(
        "double_gyre", nx=nx, ny=64, scheme=scheme, nsub=12,
        backend="pallas")
    mesh = make_mesh(1, 8, devices=["cpu"])
    with pytest.raises(ValueError, match="cannot hold the"):
        make_dist_stepper(grid, forcing, cfg, mesh)
    with pytest.raises(ValueError, match="cannot hold the"):
        dist_band.check_mesh(cfg, mesh)
    wide = dataclasses.replace(cfg, nx=128, ny=64)
    assert dist_band.check_mesh(wide, mesh) == (64, 16)

