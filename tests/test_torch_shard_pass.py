"""The shard kernels' one launch for every shard of a card (K7 and K8,
beom_tpu_torch/stencils/dist_band.py and halo_pad.py), held on the CPU
through their schedules on the host, at f64: each tile of each shard
builds its haloed block through the stacked layout's row and column
tables (the kernels' csrc/shard_addr.cuh: Stack), runs the eager steps,
the split tail or the staged phase on the block as a grid of its own, and
the interiors join into the stacked outputs.  Each must equal the
single-device plain step or phase bit for bit, on the gyre, two_layer,
coastal_wetdry and shelf_forced, on meshes (1, 1), (2, 2), (4, 1) and (2,
4), with tiles that divide neither block size.  Also: the tables are
pad2d's indices, K8's gather is pad2d, the stacked layout round-trips, and
the mesh plan is the one the stepper launches by."""

import dataclasses

import pytest
import torch

from beom_tpu_torch.parallel import halo
from beom_tpu_torch.parallel.dist import make_dist_stepper
from beom_tpu_torch.parallel.mesh import (Sharded, gather, make_mesh,
                                          shard)
from beom_tpu_torch.stencils import dist_band, fused_fb, fused_projection
from beom_tpu_torch.stencils.halo_pad import halo_pad_gather

from tests.test_torch_dist_band import CASES, _port_case

MESHES = [(1, 1), (2, 2), (4, 1), (2, 4)]
NY, NX = 48, 64
# tiles that divide neither block size of any mesh: blocks of 48 x 64,
# 24 x 32, 12 x 64 and 24 x 16
TILE, TAIL_TILE, PHASE_TILE = (10, 7), (11, 5), (12, 5)


def _setup(case, mesh_shape, **kw):
    _, (cfg, grid, forcing, st) = _port_case(case, nx=NX, ny=NY,
                                             **CASES[case], **kw)
    st = st.replace(t=cfg.npdtype.type(5 * cfg.dt))
    mesh = make_mesh(*mesh_shape, devices=["cpu"])
    stacked = [dist_band.stack_global(a, mesh) for a in (st.h, st.u, st.v)]
    return cfg, grid, forcing, st, mesh, stacked, dist_band.stack_statics(
        grid, forcing, mesh)


def _equal(label, outs, refs, mesh):
    for i, (a, b) in enumerate(zip(outs, refs)):
        got = gather(dist_band.unstack(a, mesh))
        assert torch.equal(got, b), (label, i,
                                     float((got - b).abs().max()))


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_fb_launch_emulation_equals_single_device(case, mesh_shape):
    """The fb launch of kb = 1 and 2 steps over every shard, both
    parities, from a time at which the tides are on: bit for bit kb
    single-device plain steps."""
    cfg, grid, forcing, st, mesh, f, statics = _setup(case, mesh_shape)
    for kb, n in ((1, 0), (1, 1), (2, 0), (2, 1)):
        out = dist_band.fb_launch_tiled(*f, statics, n, st.t, cfg, mesh, kb,
                                        TILE)
        ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v,
                                           (grid, forcing), n, st.t, cfg, kb)
        _equal(f"{case} {mesh_shape} kb={kb} n={n}", out, ref, mesh)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_split_launches_emulation_equals_single_device(case, mesh_shape):
    """Route 2's two launches over every shard (the tendencies, then the
    tail in a ring of NaN at the halo nsub + LO + E) at nsub 4: bit for bit
    the single-device plain split step."""
    cfg, grid, forcing, st, mesh, f, statics = _setup(
        case, mesh_shape, scheme="split", nsub=4)
    out = dist_band.split_launch_tiled(*f, statics, st.t, cfg, mesh, TILE,
                                       TAIL_TILE)
    ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, (grid, forcing), 0,
                                       st.t, cfg, 1)
    _equal(f"{case} {mesh_shape} split", out, ref, mesh)


@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_staged_phases_emulation_equals_single_device(case, mesh_shape,
                                                      scheme):
    """The staged phases A and B over every shard, both parities, with the
    staggered masks staged and rebuilt: bit for bit the single-device plain
    phases."""
    cfg, grid, forcing, st, mesh, f, statics = _setup(case, mesh_shape,
                                                      scheme=scheme)
    dmask = fused_projection.derived_masks(grid)
    p = (st.h.sum(0) - grid.H) * grid.mask
    ps = dist_band.stack_global(p, mesh)
    for n in (0, 1):
        for dm in {False, dmask}:
            a = dist_band.proj_a_launch_tiled(*f, statics, n, cfg, mesh,
                                              PHASE_TILE, dm)
            ra = fused_projection.proj_a_plain(st.h, st.u, st.v,
                                               (grid, forcing), n, cfg)
            _equal(f"{case} {mesh_shape} A n={n} dmask={dm}", a, ra, mesh)
            b = dist_band.proj_b_launch_tiled(f[0], a[0], a[1], ps, statics,
                                              st.t, cfg, mesh, PHASE_TILE,
                                              dm)
            rb = fused_projection.proj_b_plain(st.h, ra[0], ra[1], p,
                                               (grid, forcing), st.t, cfg)
            _equal(f"{case} {mesh_shape} B n={n} dmask={dm}", b, rb, mesh)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("case", list(CASES))
def test_single_step_phases_emulation_equals_single_device(case,
                                                           mesh_shape):
    """The single-step phases A and B over every shard (where no staged
    geometry fits a CTA), both parities, each haloed point read from the
    shard it falls into: bit for bit the single-device plain phases."""
    cfg, grid, forcing, st, mesh, f, statics = _setup(case, mesh_shape,
                                                      scheme="rigid_lid")
    p = (st.h.sum(0) - grid.H) * grid.mask
    ps = dist_band.stack_global(p, mesh)
    tile = fused_fb._TILES[0]
    for n in (0, 1):
        a = dist_band.proj_a_launch_tiled(*f, statics, n, cfg, mesh, tile,
                                          False, staged=False)
        ra = fused_projection.proj_a_plain(st.h, st.u, st.v, (grid, forcing),
                                           n, cfg)
        _equal(f"{case} {mesh_shape} A n={n}", a, ra, mesh)
        b = dist_band.proj_b_launch_tiled(f[0], a[0], a[1], ps, statics,
                                          st.t, cfg, mesh, tile, False,
                                          staged=False)
        rb = fused_projection.proj_b_plain(st.h, ra[0], ra[1], p,
                                           (grid, forcing), st.t, cfg)
        _equal(f"{case} {mesh_shape} B n={n}", b, rb, mesh)


def test_mesh_plan_keeps_single_step_phases_where_no_staged_one_fits():
    """Three layers at f64: no staged K3a fits a CTA, so the mesh's phase A
    is the single-step kernel, as on one device, and the mesh stepper
    still builds (on the card it launches shard_projection.cu's single-step
    entry)."""
    _, (cfg, grid, forcing, st) = _port_case("two_layer", nx=NX, ny=NY,
                                             scheme="rigid_lid")
    cfg = dataclasses.replace(cfg, nz=3, rho=tuple(cfg.rho) + (
        cfg.rho[-1] + 1.0,), backend="fused", precond="jacobi")
    mesh = make_mesh(2, 2, devices=["cpu"])
    plan = dist_band.mesh_plan(cfg, torch.float64, mesh)
    assert plan.phases == fused_projection.plan(cfg, torch.float64)
    assert plan.phases.a is None
    assert "K3a single-step" in plan.describe()
    assert plan.launches() == {"proj_a": 1, "proj_b": 1}
    name, defines = dist_band.build_spec(cfg, torch.float64)
    assert name == "shard_projection"
    # the build's shared memory per kernel: single-step A and B, then the
    # staged ones, as the single-device kernels count them
    want = dist_band._want_smem(cfg, name, defines, 8, 1)
    tile = tuple(int(d.split("=")[1]) for d in defines
                 if d.split("=")[0] in ("BEOM_TX", "BEOM_TY"))
    single = fused_projection.smem_bytes(cfg, tile, 8)
    assert want[:2] == [single["proj_a"], single["proj_b"]]
    assert want[2] > fused_fb._MAX_SMEM >= max(want[:2])


@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_stack_tables_are_pad2d_indices(mesh_shape, w):
    """The row and column tables of the stacked layout, read at a shard's
    padded block, give the points pad2d puts there: a field whose value is
    its own grid index, stacked, read through the tables, equals pad2d of
    the sharded field."""
    mesh = make_mesh(*mesh_shape, devices=["cpu"])
    ny, nx = 24, 40
    ly, lx = ny // mesh_shape[0], nx // mesh_shape[1]
    index = torch.arange(ny * nx, dtype=torch.float64).reshape(ny, nx)
    flat = dist_band.stack_global(index, mesh).reshape(-1)
    padded = halo.pad2d(shard(index, mesh), w)
    for s in range(mesh.n):
        j, i = divmod(s, mesh_shape[1])
        gy = (j * ly - w + torch.arange(ly + 2 * w)) % ny
        gx = (i * lx - w + torch.arange(lx + 2 * w)) % nx
        roff, coff = dist_band.stack_offsets(gy, gx, ly, lx, mesh_shape[1])
        got = flat[roff[:, None] + coff[None, :]]
        assert torch.equal(got, padded.blocks[s]), s
        assert torch.equal(got, index[gy][:, gx]), s


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("w", [1, 3, 5])
@pytest.mark.parametrize("mesh_shape", MESHES + [(1, 3), (3, 1)])
def test_halo_pad_gather_equals_pad2d(mesh_shape, w, lead):
    """K8's index arithmetic (one launch: the shards on its z blocks, each
    output row's and column's source shard and point) on the host, into one
    allocation: pad2d bit for bit, 2-D and layered."""
    mesh = make_mesh(*mesh_shape, devices=["cpu"])
    g = torch.Generator().manual_seed(7)
    a = shard(torch.randn(lead + (24, 36), generator=g,
                          dtype=torch.float64), mesh)
    got = halo_pad_gather(a, w)
    ref = halo.pad2d(a, w)
    assert len({b.untyped_storage().data_ptr() for b in got.blocks}) == 1
    for x, y in zip(got.blocks, ref.blocks):
        assert torch.equal(x, y)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_stack_keeps_views_and_copies_the_rest(lead):
    """stack returns the allocation a stacked field's blocks are views of,
    without a copy, and stacks any other sharded field; unstack gives views
    whose gather is the field."""
    mesh = make_mesh(2, 4, devices=["cpu"])
    a = torch.randn(lead + (16, 32), dtype=torch.float64)
    base = dist_band.stack_global(a, mesh)
    assert base.shape == lead + (8, 8, 8)
    sh = dist_band.unstack(base, mesh)
    assert isinstance(sh, Sharded) and torch.equal(gather(sh), a)
    again = dist_band.stack(sh)
    assert again.data_ptr() == base.data_ptr() and torch.equal(again, base)
    copied = dist_band.stack(shard(a, mesh))
    assert copied.data_ptr() != base.data_ptr()
    assert torch.equal(copied, base)
    # views of the first shards' slices of a larger allocation
    big = torch.cat([base, base], dim=-3)
    other = Sharded([big.select(-3, s) for s in range(mesh.n)], mesh)
    assert torch.equal(dist_band.stack(other), base)
    with pytest.raises(ValueError, match="8 shards"):
        dist_band.unstack(big, mesh)


@pytest.mark.parametrize("scheme,kw", [
    ("fb", dict(steps_per_pass=2, backend="pallas")), ("split", dict(nsub=8)),
    ("split", dict(nsub=12)), ("implicit_fs", {}), ("rigid_lid", {})])
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_plan_is_the_steppers(case, scheme, kw):
    """The fused mesh stepper launches by mesh_plan: the single-device
    plans' kb (at most what a block's halo allows), route and phase
    geometry, and its launches per call."""
    _, (cfg, grid, forcing, st) = _port_case(case, nx=NX, ny=NY,
                                             scheme=scheme, **CASES[case],
                                             **kw)
    cfg = dataclasses.replace(cfg, backend="fused", precond="jacobi")
    for mesh_shape in ((2, 4), (4, 1)):
        mesh = make_mesh(*mesh_shape, devices=["cpu"])
        if scheme == "split" and min(NY // mesh_shape[0],
                                     NX // mesh_shape[1]) \
                < fused_fb.tail_halo(cfg):
            with pytest.raises(ValueError, match="cannot hold the"):
                dist_band.mesh_plan(cfg, None, mesh)
            continue
        plan = dist_band.mesh_plan(cfg, None, mesh)
        step = dist_band.make_dist_fused_projection_stepper \
            if scheme in ("rigid_lid", "implicit_fs") \
            else dist_band.make_dist_fused_stepper
        assert step(grid, forcing, cfg, mesh).plan == plan
        assert (plan.ly, plan.lx) == (NY // mesh_shape[0],
                                      NX // mesh_shape[1])
        launches = plan.launches()
        if scheme == "fb":
            k = cfg.steps_per_pass
            kb = min(fused_fb.plan(cfg, cfg.tdtype, k).kb,
                     min(plan.ly, plan.lx) // fused_fb.halo_width(cfg))
            assert plan.kb(k) == max(kb, 1)
            assert plan.fb_launches(k) == fused_fb.launch_steps(k, plan.kb(k))
            assert launches["fb"] == len(plan.fb_launches(k))
        elif scheme == "split":
            route = fused_fb.split_plan(cfg, cfg.tdtype).route
            assert plan.split.route == route
            assert launches == ({"split_tend": 1, "split_tail": 1}
                                if route == 2 else
                                {"split_slow": 1, "split_subcycle": 1,
                                 "split_recompose": 1})
        else:
            assert plan.phases == fused_projection.plan(cfg, cfg.tdtype)
            assert launches == {"proj_a": 1, "proj_b": 1}
        assert plan.describe().startswith(f"blocks of {plan.ly} x "
                                          f"{plan.lx}")
    # the CPU stepper steps through the plain versions and launches nothing
    before = dict(dist_band.LAUNCHES)
    from beom_tpu_torch.parallel.mesh import shard_state
    mesh = make_mesh(2, 4, devices=["cpu"])
    if scheme != "split" or min(NY // 2, NX // 4) >= fused_fb.tail_halo(cfg):
        out = make_dist_stepper(grid, forcing, cfg, mesh)(
            shard_state(st, mesh))
        assert out.n == st.n + cfg.steps_per_pass
    assert dist_band.LAUNCHES == before
