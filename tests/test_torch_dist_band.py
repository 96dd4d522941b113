"""The shard step (K7, beom_tpu_torch/stencils/dist_band.py) on CPU
blocks, where it runs its plain version: per shard equal to the
single-device eager step for every fb case, and against beom_tpu's
make_dist_pallas_stepper in interpret mode at the sizes of
tests/dist/test_pallas_dist.py; the mesh route of run() with
backend='fused'; and the schemes it once refused, which now step through
the split and projection shard kernels (tests/test_torch_dist_fused.py)."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.parallel.dist import make_dist_stepper as j_make_dist_stepper
from beom_tpu.parallel.mesh import make_mesh as j_make_mesh
from beom_tpu.parallel.mesh import shard_state as j_shard_state

from beom_tpu_torch.parallel.dist import make_dist_stepper
from beom_tpu_torch.parallel.mesh import (Sharded, gather, gather_state,
                                          make_mesh, shard, shard_state)
from beom_tpu_torch.run import run
from beom_tpu_torch.stencils import dist_band, fused_fb
from beom_tpu_torch.stepping import run_steps

from tests.torch_parity import perturb, to_port

CASES = {"double_gyre": {}, "two_layer": {}, "coastal_wetdry": {},
         "shelf_forced": dict(nu4=1e6, r_int=1e-4)}


def _port_case(case, seed=21, **kw):
    jcfg, jgrid, jforcing, jst = jax_make_case(case, dtype="float64", **kw)
    jst = perturb(jcfg, jgrid, jst, seed)
    return (jcfg, jgrid, jforcing, jst), to_port(jcfg, jgrid, jforcing, jst)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_shard_step_plain_equals_single_device_step(case, k):
    """The halo of the fused step's tile (4, 5 under wet/dry) around each
    shard's block, padded statics, the eager step, the crop: bit for bit
    the single-device step, at both parities, from a time at which the
    tides are on."""
    _, (cfg, grid, forcing, st) = _port_case(case, nx=96, ny=64,
                                             **CASES[case])
    st = st.replace(t=cfg.npdtype.type(5 * cfg.dt))
    mesh = make_mesh(2, 4, devices=["cpu"])
    pstat = dist_band.pad_statics(grid, forcing, cfg, mesh)
    w = dist_band.shard_halo(cfg)
    assert w == (5 if cfg.wetdry else 4)
    assert pstat[0].mask.shape == (32 + 2 * w, 24 + 2 * w)
    sh, su, sv = (shard(a, mesh) for a in (st.h, st.u, st.v))
    before = dict(dist_band.LAUNCHES)
    for n in (0, 1):
        out = dist_band.shard_step(sh, su, sv, pstat, n, st.t, cfg, k,
                                   kernels=None)
        ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v,
                                           (grid, forcing), n, st.t, cfg, k)
        for f, a, b in zip("huv", out, ref):
            assert isinstance(a, Sharded)
            assert torch.equal(gather(a), b), (f, n)
    assert dist_band.LAUNCHES == before      # CPU blocks launch nothing


@pytest.mark.parametrize("case,mesh_shape,nx,ny,kw", [
    ("double_gyre", (4, 1), 64, 192, {}),
    ("double_gyre", (2, 4), 128, 96, {}),
    ("two_layer", (2, 2), 64, 96, {}),
    ("coastal_wetdry", (2, 2), 64, 192, {}),
    ("shelf_forced", (2, 2), 64, 192, {}),
    ("double_gyre", (2, 2), 64, 192, dict(steps_per_pass=2)),
])
def test_fused_mesh_stepper_matches_pallas_interpret(case, mesh_shape, nx,
                                                     ny, kw):
    """make_dist_stepper with backend='fused' against the TPU kernel it
    replaces, run as tests/dist/test_pallas_dist.py runs it (the Pallas
    TPU interpreter on the virtual mesh): 6 steps, f64, atol 1e-11."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _port_case(
        case, nx=nx, ny=ny, backend="pallas", **kw)
    assert cfg.backend == "fused"
    n_pass = 6 // cfg.steps_per_pass
    jmesh = j_make_mesh(*mesh_shape)
    jout = j_make_dist_stepper(jgrid, jforcing, jcfg, jmesh,
                               n_inner=n_pass)(j_shard_state(jst, jmesh))
    mesh = make_mesh(*mesh_shape, devices=["cpu"])
    out = make_dist_stepper(grid, forcing, cfg, mesh, n_inner=n_pass)(
        shard_state(st, mesh))
    assert out.n == int(jout.n) == 6
    got = gather_state(out)
    ref = run_steps(st, grid, forcing, cfg, 6)
    for f in "huv":
        a = getattr(got, f).numpy()
        np.testing.assert_allclose(a, np.asarray(getattr(jout, f)), rtol=0,
                                   atol=1e-11, err_msg=f"{f}: vs beom_tpu")
        np.testing.assert_array_equal(a, getattr(ref, f).numpy(),
                                      err_msg=f"{f}: 1 vs N")
    assert float(ref.u.abs().max()) > 0


def test_run_fused_mesh_equals_single_device():
    """run() on a 2 x 4 mesh with backend='fused' and steps_per_pass=4,
    with a 1-step tail: the gathered state and the diagnostics lines are
    the single-device run's."""
    from beom_tpu_torch.cases import make_case

    cfg, grid, forcing, st = make_case(
        "double_gyre", nx=64, ny=64, device="cpu", dtype="float64",
        backend="fused", steps_per_pass=4, diag_every=5)
    log1, logn = io.StringIO(), io.StringIO()
    ref = run(cfg, grid, forcing, st, 11, log=log1)
    out = run(dataclasses.replace(cfg, mesh_y=2, mesh_x=4), grid, forcing,
              st, 11, log=logn)
    assert out.n == ref.n == 11 and out.t == ref.t
    got = gather_state(out)
    for f in "huv":
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert logn.getvalue() == log1.getvalue()


@pytest.mark.parametrize("scheme,item", [
    ("split", "14a"), ("rigid_lid", "14b"), ("implicit_fs", "14b")])
def test_fused_mesh_refuses_other_schemes(scheme, item):
    """The schemes backend='fused' under a mesh once refused (ROADMAP items
    14a and 14b, now done) build a fused mesh stepper and step a CPU mesh
    once through the shard kernels' plain versions; build_spec names the
    kernel's source."""
    _, (cfg, grid, forcing, st) = _port_case("double_gyre", nx=32, ny=32,
                                             scheme=scheme)
    cfg = dataclasses.replace(cfg, backend="fused", precond="jacobi")
    mesh = make_mesh(2, 2, devices=["cpu"])
    out = make_dist_stepper(grid, forcing, cfg, mesh)(shard_state(st, mesh))
    assert out.n == 1 and isinstance(out.h, Sharded)
    ref = run_steps(st, grid, forcing, cfg, 1)
    err = float((gather_state(out).u - ref.u).abs().max())
    assert err <= 1e-8 * max(float(ref.u.abs().max()), 1.0), (item, err)
    want = {"split": "shard_split", "rigid_lid": "shard_projection",
            "implicit_fs": "shard_projection"}[scheme]
    assert dist_band.build_spec(cfg)[0] == want


def test_shard_step_build_spec_and_interior():
    """The shard step builds csrc/shard_step.cu with the switches and the
    tile of the single-device fused step (at kb > 1 those of its pass
    kernel); the mesh plan launches every shard of the card at once, with
    the single-device plan's steps per launch where a block holds their
    halo, fewer where it does not."""
    _, (cfg, *_) = _port_case("shelf_forced", nx=48, ny=32)
    name, defines = dist_band.build_spec(cfg)
    assert name == "shard_step"
    assert defines == fused_fb.build_spec(cfg)[1]
    assert "BEOM_OBC=1" in defines and "BEOM_NZ=2" in defines
    _, (gyre, *_) = _port_case("double_gyre", nx=48, ny=32)
    gyre = dataclasses.replace(gyre, nx=2048, ny=2048, steps_per_pass=4,
                               dtype="float32")
    assert dist_band.build_spec(gyre, torch.float32, kb=2) \
        == ("shard_step", fused_fb.build_spec(gyre, torch.float32, 2)[1])
    one = fused_fb.plan(gyre, torch.float32, 4)
    pl = dist_band.mesh_plan(gyre, torch.float32, make_mesh(2, 4,
                                                            devices=["cpu"]))
    assert (pl.ly, pl.lx) == (1024, 512)
    assert pl.kb(4) == one.kb and pl.fb_launches(4) == one.launches(4)
    assert pl.launches() == {"fb": len(one.launches(4)),
                             "fb_pass": sum(m > 1 for m in one.launches(4))}
    small = dist_band.mesh_plan(dataclasses.replace(gyre, nx=64, ny=56),
                                torch.float32, make_mesh(4, 8,
                                                         devices=["cpu"]))
    assert (small.ly, small.lx, small.max_kb) == (14, 8, 2)
    assert small.kb(4) == min(one.kb, 2)
