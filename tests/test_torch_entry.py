"""The port's entry module (beom_tpu_torch/entry.py), twin of
__graft_entry__.py: entry()'s step against the reference's, one step from
one perturbed state within 4 ulp of field scale; the dry run's seven legs
on meshes of 8, 4 and 1 shards of the CPU, each printing its OK line; its
eager legs (1 and 6) against beom_tpu's XLA make_dist_stepper on the 8
virtual devices and its fused legs against the port's single-device eager
run of the same steps, at f64 (1e-11 for fb and split, 1e-10 for the
red-black solve, 1e-8 for the CG solves, whose mesh sums add in another
order, as tests/dist/test_equivalence.py pins them); the shard kernels'
launches at the dry run's sizes, as the card's f32 plans take them,
emulated on the host bit for bit the single-device plain step; and entry
points that raise without a card."""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.parallel import dist as jdist
from beom_tpu.parallel.mesh import make_mesh as j_make_mesh
from beom_tpu.parallel.mesh import shard_state as j_shard_state

from beom_tpu_torch import entry as port_entry
from beom_tpu_torch.parallel.dist import make_dist_stepper
from beom_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state
from beom_tpu_torch.stencils import dist_band, fused_fb, fused_projection
from beom_tpu_torch.stepping import run_steps

from tests.test_torch_shard_pass import _equal
from tests.torch_parity import perturb, to_port

LEGS = {leg.label: leg for leg in port_entry.LEGS}
FUSED = [label for label, leg in LEGS.items()
         if dict(leg.kw).get("backend") == "fused"]


def test_entry_step_matches_reference():
    """One step of entry()'s fn (K1's plain version on the CPU) from a
    perturbed state, against one step of __graft_entry__.entry()'s fn."""
    jfn, _ = graft.entry()
    fn, (st0,) = port_entry.entry(device="cpu")
    jcfg, jgrid, jforcing, jst = jax_make_case("double_gyre", nx=256,
                                               ny=256)
    jst = perturb(jcfg, jgrid, jst, 11, amp_h=0.05, amp_uv=0.01)
    st = to_port(jcfg, jgrid, jforcing, jst)[3]
    assert st.h.dtype == st0.h.dtype == torch.float32
    assert st.h.shape == st0.h.shape == (1, 256, 256)
    jout, out = jfn(jst), fn(st)
    assert out.n == int(jout.n) == 1 and out.t == np.asarray(jout.t)
    ulp = float(np.finfo(np.float32).eps)
    for f in "huv":
        ref = np.asarray(getattr(jout, f))
        err = float(np.abs(getattr(out, f).numpy() - ref).max())
        assert err <= 4 * ulp * float(np.abs(ref).max()), (f, err)


def test_entry_runs_the_fused_single_step():
    """entry() is the fused backend at one step per call, so on the card
    one call is one launch of K1's single-step kernel; on the CPU it is
    K1's plain version and launches nothing."""
    from beom_tpu_torch.cases import make_case

    cfg = make_case("double_gyre", nx=256, ny=256, backend="fused",
                    device="cpu")[0]
    assert cfg.backend == "fused" and cfg.steps_per_pass == 1
    assert fused_fb.plan(cfg, torch.float32).launches(1) == [1]
    fn, (st,) = port_entry.entry(device="cpu")
    before = fused_fb.LAUNCHES
    assert fn(st).n == 1
    assert fused_fb.LAUNCHES == before


@pytest.mark.parametrize("n,shape", [(8, (2, 4)), (4, (2, 2)), (1, (1, 1))])
def test_dryrun_prints_seven_ok_lines(n, shape, capsys):
    records = port_entry.dryrun_multichip(n, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(records) == 7
    assert port_entry.mesh_shape(n) == shape
    for line, rec, leg in zip(lines, records, port_entry.LEGS):
        cfg = rec["cfg"]
        assert line == (f"dryrun_multichip: {leg.label} mesh=({shape[0]},"
                        f"{shape[1]}) grid=({cfg.ny},{cfg.nx}) steps=2 OK")
        assert (cfg.nx, cfg.ny) == (32 * shape[1], leg.rows * shape[0])
        assert rec["out"].n == 2 and rec["launches"] == {}
        assert (rec["plan"] is None) == (cfg.backend == "eager")


def _jax_leg(leg, my, mx):
    """The leg's case from beom_tpu at f64, on its XLA backend."""
    kw = dict(leg.kw, dtype="float64")
    kw.pop("backend", None)
    if leg.config_mesh:
        kw.update(mesh_y=my, mesh_x=mx)
    return jax_make_case(leg.case, nx=32 * mx, ny=leg.rows * my, **kw)


@pytest.mark.parametrize("label,atol", [
    ("eager", 1e-11), ("implicit_fs eager+dist-redblack", 1e-10)])
def test_eager_legs_match_reference_dist_stepper(label, atol):
    """Legs 1 and 6 from one perturbed state through the port's mesh on
    the CPU and beom_tpu's make_dist_stepper on its 8 devices."""
    leg = LEGS[label]
    my, mx = 2, 4
    jcase = _jax_leg(leg, my, mx)
    jcfg, jgrid, jforcing, jst = jcase
    jst = perturb(jcfg, jgrid, jst, 13)
    cfg, grid, forcing, st = to_port(jcfg, jgrid, jforcing, jst)
    assert leg.build(my, mx, "cpu", dtype="float64")[0] == cfg
    mesh = make_mesh(my, mx, devices=["cpu"])
    out = make_dist_stepper(grid, forcing, cfg, mesh, n_inner=leg.n_inner)(
        shard_state(st, mesh))
    jmesh = j_make_mesh(my, mx)
    jout = jdist.make_dist_stepper(jgrid, jforcing, jcfg, jmesh,
                                   n_inner=leg.n_inner)(
        j_shard_state(jst, jmesh))
    got = gather_state(out)
    assert got.n == int(jout.n) == 2
    for f in "huv":
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(jout, f)), rtol=0,
                                   atol=atol, err_msg=f)
    assert float(got.u.abs().max()) > 0


@pytest.mark.parametrize("label", FUSED)
def test_fused_legs_match_single_device_eager(label):
    """Legs 2-5 and 7 at f64 on the (2, 4) mesh of CPU shards (the shard
    kernels' plain versions) against the same steps on one device through
    the eager step."""
    leg = LEGS[label]
    mesh = make_mesh(2, 4, devices=["cpu"])
    rec = port_entry.run_leg(leg, mesh, "cpu", dtype="float64")
    cfg = rec["cfg"]
    one = dataclasses.replace(cfg, backend="eager", mesh_y=1, mesh_x=1)
    ref = run_steps(rec["state"], rec["grid"], rec["forcing"], one, 2)
    got = gather_state(rec["out"])
    atol = 1e-8 if cfg.scheme in ("rigid_lid", "implicit_fs") else 1e-11
    assert got.n == ref.n == 2
    for f in "huv":
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(ref, f).numpy(), rtol=0,
                                   atol=atol, err_msg=f"{label}: {f}")
    assert float(ref.u.abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("label", FUSED)
def test_fused_legs_one_device_twins(label, dtype):
    """Each fused leg on the (2, 4) mesh of CPU shards from a perturbed
    state, against one device through entry.one_device_twins (the pairs
    that the card's tests hold bit for bit): equal bit for bit on the
    CPU too, the plain versions on both sides."""
    leg = LEGS[label]
    mesh = make_mesh(2, 4, devices=["cpu"])
    rec = port_entry.run_leg(leg, mesh, "cpu", seed=19, dtype=dtype)
    pairs = port_entry.one_device_twins(rec, seed=23)
    projection = rec["cfg"].scheme in ("rigid_lid", "implicit_fs")
    assert len(pairs) == (4 if projection else 1)
    for what, got, ref in pairs:
        assert len(got) == len(ref) == 3
        for j, (a, b) in enumerate(zip(got, ref)):
            assert a.dtype == b.dtype == getattr(torch, dtype)
            assert torch.equal(a, b), f"{what}: field {j}"
            assert float(b.abs().max()) > 0, f"{what}: field {j}"


@pytest.mark.parametrize("n", [8, 1])
@pytest.mark.parametrize("label", FUSED)
def test_fused_legs_plans_emulated_at_dry_run_sizes(label, n):
    """The shard kernels at the dry run's blocks (48 x 32), as the card's
    f32 mesh plan launches them (its kb, tiles, tail and phase
    geometries, tiles wider than a block included), emulated on the host
    at f64 from a perturbed state: bit for bit the single-device plain
    step or phases."""
    leg = LEGS[label]
    my, mx = port_entry.mesh_shape(n)
    cfg, grid, forcing, st = leg.build(my, mx, "cpu", dtype="float64")
    rng = np.random.default_rng(17)
    st = st.replace(**{f: getattr(st, f) + amp * torch.tensor(
        rng.standard_normal(tuple(st.h.shape))) * m for f, amp, m in (
            ("h", 0.5, grid.mask), ("u", 0.05, grid.mask_u),
            ("v", 0.05, grid.mask_v))})
    mesh = make_mesh(my, mx, devices=["cpu"])
    plan = dist_band.mesh_plan(cfg, torch.float32, mesh)
    assert (plan.ly, plan.lx) == (48, 32)
    # the host schedule cuts blocks of its own out of the grid
    cfg = dataclasses.replace(cfg, mesh_y=1, mesh_x=1)
    f = [dist_band.stack_global(a, mesh) for a in (st.h, st.u, st.v)]
    statics = dist_band.stack_statics(grid, forcing, mesh)
    defines = dict(d.split("=") for d in dist_band.build_spec(
        cfg, torch.float32)[1])
    tile = (int(defines["BEOM_TX"]), int(defines["BEOM_TY"]))
    statics1 = (grid, forcing)
    if cfg.scheme == "fb":
        k = cfg.steps_per_pass
        kb = plan.kb(k)
        assert plan.fb_launches(k) == [k]
        pl = fused_fb.launch_plan(cfg, torch.float32, kb)
        out = dist_band.fb_launch_tiled(*f, statics, 0, st.t, cfg, mesh, kb,
                                        pl.tile)
        ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, statics1, 0,
                                           st.t, cfg, kb)
        _equal(label, out, ref, mesh)
    elif cfg.scheme == "split":
        sp = plan.split
        assert sp.route == 2
        out = dist_band.split_launch_tiled(*f, statics, st.t, cfg, mesh,
                                           tile, (sp.qx, sp.qy))
        ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, statics1, 0,
                                           st.t, cfg, 1)
        _equal(label, out, ref, mesh)
    else:
        ph = plan.phases
        assert ph.a is not None and ph.b is not None
        dm = fused_projection.derived_masks(grid)
        p = (st.h.sum(0) - grid.H) * grid.mask
        a = dist_band.proj_a_launch_tiled(*f, statics, 0, cfg, mesh,
                                          (ph.a.tx, ph.a.ty), dm)
        ra = fused_projection.proj_a_plain(st.h, st.u, st.v, statics1, 0,
                                           cfg)
        _equal(f"{label} A", a, ra, mesh)
        b = dist_band.proj_b_launch_tiled(
            f[0], a[0], a[1], dist_band.stack_global(p, mesh), statics,
            st.t, cfg, mesh, (ph.b.tx, ph.b.ty), dm)
        rb = fused_projection.proj_b_plain(st.h, ra[0], ra[1], p, statics1,
                                           st.t, cfg)
        _equal(f"{label} B", b, rb, mesh)


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        port_entry.dryrun_multichip(8)
