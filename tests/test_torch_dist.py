"""The port's distributed tier (beom_tpu_torch/parallel/dist.py, diag.py,
the mesh route of run.py) for the explicit schemes: twins of
tests/dist/test_equivalence.py, test_resume.py and test_fault.py.  The
same numpy inputs go through the port on a mesh of CPU shards, the port on
one device and beom_tpu's make_dist_stepper on the 8 virtual devices, at
f64, 6 steps, atol 1e-11 (the reference's 1-vs-N bar)."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.parallel import dist as jdist
from beom_tpu.parallel.mesh import make_mesh as j_make_mesh
from beom_tpu.parallel.mesh import shard_state as j_shard_state

from beom_tpu_torch import convert
from beom_tpu_torch.diag import diagnostics
from beom_tpu_torch.io import snapshots
from beom_tpu_torch.parallel import halo
from beom_tpu_torch.parallel.diag import make_dist_diagnostics
from beom_tpu_torch.parallel.dist import make_dist_stepper, required_halo
from beom_tpu_torch.parallel.mesh import (Sharded, gather_state, make_mesh,
                                          shard_state)
from beom_tpu_torch.run import InstabilityError, run
from beom_tpu_torch.stepping import run_steps

from tests.torch_parity import perturb, to_port

N_STEPS = 6
ATOL = 1e-11


def _three_ways(case, mesh_shape=(2, 4), n=N_STEPS, atol=ATOL, **kw):
    """The port on the mesh against the port on one device and against
    beom_tpu on the same mesh, from one perturbed state."""
    jcfg, jgrid, jforcing, jst = jax_make_case(case, dtype="float64", **kw)
    jst = perturb(jcfg, jgrid, jst, 7)
    cfg, grid, forcing, st = to_port(jcfg, jgrid, jforcing, jst)
    ref = run_steps(st, grid, forcing, cfg, n)

    mesh = make_mesh(*mesh_shape, devices=["cpu"])
    step = make_dist_stepper(grid, forcing, cfg, mesh, n_inner=n)
    out = step(shard_state(st, mesh))
    assert isinstance(out.h, Sharded) and out.n == n and out.t == ref.t
    got = gather_state(out)

    jmesh = j_make_mesh(*mesh_shape)
    jout = jdist.make_dist_stepper(jgrid, jforcing, jcfg, jmesh, n_inner=n)(
        j_shard_state(jst, jmesh))
    for f in "huv":
        a = getattr(got, f).numpy()
        np.testing.assert_allclose(a, getattr(ref, f).numpy(), rtol=0,
                                   atol=atol, err_msg=f"{f}: 1 vs N")
        np.testing.assert_allclose(a, np.asarray(getattr(jout, f)), rtol=0,
                                   atol=atol, err_msg=f"{f}: vs beom_tpu")
    assert float(ref.u.abs().max()) > 0     # the run did something


@pytest.mark.parametrize("case,nx", [
    ("double_gyre", 64), ("two_layer", 64), ("coastal_wetdry", 96),
    ("shelf_forced", 96)])
def test_fb_matches_single_device_and_reference(case, nx):
    _three_ways(case, nx=nx, ny=64)


@pytest.mark.parametrize("nsub", [2, 12])
def test_split_matches_single_device_and_reference(nsub):
    """One 1-halo exchange per substep: the halo does not grow with
    nsub."""
    _three_ways("double_gyre", nx=64, ny=64, scheme="split", nsub=nsub)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (8, 1)])
def test_mesh_1xN_and_Nx1(mesh_shape):
    _three_ways("double_gyre", mesh_shape=mesh_shape, nx=128, ny=128)


@pytest.mark.parametrize("case", ["double_gyre", "two_layer", "rigid_lid",
                                  "coastal_wetdry", "shelf_forced"])
def test_required_halo_is_the_references(case):
    jcfg, jgrid, jforcing, jst = jax_make_case(case, nx=32, ny=32)
    cfg, *_ = to_port(jcfg, jgrid, jforcing, jst)
    assert required_halo(cfg) == jdist.required_halo(jcfg) >= 4
    both = dataclasses.replace(cfg, nu4=1e9)
    assert required_halo(both) == required_halo(cfg) + 2


def _port_case(case="double_gyre", **kw):
    jcfg, jgrid, jforcing, jst = jax_make_case(case, dtype="float64", **kw)
    return to_port(jcfg, jgrid, jforcing, perturb(jcfg, jgrid, jst, 8))


@pytest.mark.parametrize("scheme,kw", [
    ("fb", {}), ("split", dict(nsub=4)),
    ("rigid_lid", dict(precond="jacobi")), ("implicit_fs", {})])
def test_run_under_a_mesh_every_scheme(scheme, kw):
    """run() with mesh_y * mesh_x > 1 on the eager tier: the sharded state
    it returns, gathered, is the single-device run's (the projection
    schemes to the solver tolerance), with the same diagnostics lines."""
    cfg, grid, forcing, st = _port_case(nx=32, ny=32, scheme=scheme,
                                        diag_every=2, **kw)
    log1, logn = io.StringIO(), io.StringIO()
    ref = run(cfg, grid, forcing, st, 4, log=log1)
    out = run(dataclasses.replace(cfg, mesh_y=2, mesh_x=2), grid, forcing,
              st, 4, log=logn)
    assert isinstance(out.h, Sharded) and out.n == 4
    got = gather_state(out)
    atol = ATOL if scheme in ("fb", "split") else 1e-8
    for f in "huv":
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(ref, f).numpy(), rtol=0,
                                   atol=atol, err_msg=f)
    assert len(logn.getvalue().splitlines()) == 2
    if scheme in ("fb", "split"):
        assert logn.getvalue() == log1.getvalue()


def test_rdma_halo_impl_equals_ppermute_on_cpu():
    """halo_impl='rdma' routes every pad2d of the step through the
    halo-pad wrapper (its plain version on CPU blocks): the same run."""
    cfg, grid, forcing, st = _port_case(nx=64, ny=64)
    mesh = make_mesh(2, 4, devices=["cpu"])
    a = make_dist_stepper(grid, forcing, cfg, mesh, n_inner=3)(
        shard_state(st, mesh))
    b = make_dist_stepper(grid, forcing, dataclasses.replace(
        cfg, halo_impl="rdma"), mesh, n_inner=3)(shard_state(st, mesh))
    for f in "huv":
        for x, y in zip(getattr(a, f).blocks, getattr(b, f).blocks):
            assert torch.equal(x, y)
    assert halo._PAD_IMPL == "ppermute"


def test_dist_resume_matches_uninterrupted(tmp_path):
    """A snapshot written mid-run under a mesh is the global npz, and the
    run resumed from it (before sharding) is the uninterrupted one."""
    cfg, grid, forcing, st = _port_case(nx=64, ny=64, mesh_y=2, mesh_x=4,
                                        snap_every=8)
    quiet = io.StringIO()
    full = run(cfg, grid, forcing, st, 16, log=quiet, chunk=8)
    rd = str(tmp_path / "dist_run")
    run(cfg, grid, forcing, st, 8, run_dir=rd, log=quiet, chunk=8)
    snap = snapshots.latest_snapshot(rd)
    assert snap is not None
    with np.load(snap) as z:
        assert z["h"].shape == (cfg.nz, cfg.ny, cfg.nx)
    log = io.StringIO()
    resumed = run(cfg, grid, forcing, st, 8, run_dir=rd, log=log, chunk=8)
    assert "resumed from" in log.getvalue()
    assert resumed.n == full.n == 16
    a, b = gather_state(resumed), gather_state(full)
    for f in "huv":
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_dist_diagnostics_match_local():
    cfg, grid, forcing, st = _port_case(nx=64, ny=64)
    out = run_steps(st, grid, forcing, cfg, 10)
    mesh = make_mesh(2, 4, devices=["cpu"])
    d = make_dist_diagnostics(grid, cfg, mesh)(shard_state(out, mesh))
    ref = diagnostics(out, grid, cfg)
    for k in ("t", "n", "mass", "ke", "max_speed", "cfl", "eta_rms",
              "finite"):
        np.testing.assert_allclose(d[k], ref[k], rtol=1e-12, err_msg=k)


def test_corrupted_shard_trips_guard():
    """A NaN in one interior cell of one shard's block: the distributed
    diagnostics' `finite` drops to 0 and run() aborts."""
    cfg, grid, forcing, st = _port_case(nx=64, ny=64)
    h = st.h.clone()
    h[0, 40, 50] = float("nan")
    bad = st.replace(h=h)
    mesh = make_mesh(2, 4, devices=["cpu"])
    out = make_dist_stepper(grid, forcing, cfg, mesh, n_inner=2)(
        shard_state(bad, mesh))
    assert make_dist_diagnostics(grid, cfg, mesh)(out)["finite"] == 0.0
    with pytest.raises(InstabilityError, match="non-finite"):
        run(dataclasses.replace(cfg, mesh_y=2, mesh_x=4), grid, forcing,
            bad, 2, log=io.StringIO())


def test_convert_shards_and_gathers():
    """from_reference with a mesh cuts the reference's global arrays into
    the mesh's blocks; to_numpy gathers them back bit for bit."""
    jcfg, jgrid, jforcing, jst = jax_make_case("two_layer", nx=32, ny=32,
                                               dtype="float64")
    jmesh = j_make_mesh(2, 4)
    jsh = j_shard_state(perturb(jcfg, jgrid, jst, 9), jmesh)
    mesh = make_mesh(2, 4, devices=["cpu"])
    cfg, grid, forcing, st = convert.from_reference(
        dataclasses.asdict(jcfg), jgrid, jforcing, jsh, "cpu", mesh=mesh)
    assert isinstance(st.h, Sharded) and st.h.shape == (2, 16, 8)
    assert isinstance(grid.mask, Sharded)
    # shard (1, 2) of the port is the block the reference holds there
    blk = np.asarray(jsh.h)[:, 16:32, 16:24]
    np.testing.assert_array_equal(st.h.blocks[mesh.index(1, 2)].numpy(), blk)
    _, g, f, s = convert.to_numpy(cfg, grid, forcing, st)
    np.testing.assert_array_equal(s["h"], np.asarray(jsh.h))
    np.testing.assert_array_equal(g["mask"], np.asarray(jgrid.mask))
    np.testing.assert_array_equal(f["taux"], np.asarray(jforcing.taux))
