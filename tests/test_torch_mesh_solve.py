"""The mesh's elliptic solve on the gathered grid of the shards
(beom_tpu_torch/stencils/mesh_solve.py) on meshes of CPU shards, f64:
its multigrid hierarchy (multigrid.mesh_levels) bit for bit the gathered
levels of build_dist_levels; its plain version (K6's, cg_fused.
cg_solve_plain with the mesh's hierarchy and gamma 2, and K4a's plain
sweeps) through the gather and the scatter against the eager mesh solve
(parallel/dist.py::_dist_solve) and against beom_tpu's _dist_solve under
shard_map, within 1e-8 relative (the CG's sums run in another order, so
its iterations agree within 2); K6 with no hierarchy given keeps its own;
describe() names each route."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from beom_tpu.parallel import dist as jdist
from beom_tpu.parallel.mesh import make_mesh as j_make_mesh
from beom_tpu.parallel.mesh import spec_for

from beom_tpu_torch.parallel import dist, halo
from beom_tpu_torch.parallel.mesh import card_groups, gather, make_mesh, shard
from beom_tpu_torch.solvers import multigrid
from beom_tpu_torch.stencils import cg_fused, dist_band, mesh_solve
from beom_tpu_torch.stencils import mg_coarse

from tests.test_torch_dist_projection import _cases

# (mesh shape, ny, nx): square and non-square blocks, and a grid whose
# global levels are not square
MESHES = {"2x2": ((2, 2), 64, 64), "2x4": ((2, 4), 64, 64),
          "2x4-32x64": ((2, 4), 32, 64), "2x2-32": ((2, 2), 32, 32)}
SOLVES = {
    "implicit_fs-jacobi": dict(scheme="implicit_fs"),
    "rigid_lid-mg": dict(),
    "rigid_lid-jacobi": dict(precond="jacobi"),
}
RTOL = 1e-8


def _pieces(mesh_name, seed=5, **kw):
    """(jax case, cfg, grid, mesh, local and 1-halo statics, lam, b, x0):
    one solve's inputs on a mesh of CPU shards, b and x0 seeded."""
    mesh_shape, ny, nx = MESHES[mesh_name]
    jcase, (cfg, grid, forcing, _) = _cases(nx=nx, ny=ny, **kw)
    mesh = make_mesh(*mesh_shape, devices=["cpu"])
    pgrid, _ = dist.pad_statics(grid, forcing, cfg, mesh, 1)
    grid_l = dist._crop_tree(pgrid, 1)
    lam = dist.pressure_lam(cfg)
    rng = np.random.default_rng(seed)
    b = torch.tensor(rng.standard_normal((ny, nx))) * grid.mask
    x0 = torch.tensor(0.1 * rng.standard_normal((ny, nx))) * grid.mask
    return jcase, cfg, grid, mesh, grid_l, pgrid, lam, b, x0


def _close(got, ref, what):
    scale = float(ref.abs().max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("lam", ["poisson", "helmholtz"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_levels_are_the_gathered_dist_levels(mesh_name, lam):
    """multigrid.mesh_levels on the global grid is build_dist_levels'
    hierarchy gathered, level for level and field for field, bit for bit
    (on 2 x 4 the local blocks are not square and the depth follows the
    smaller side)."""
    _, cfg, grid, mesh, _, pgrid, _, _, _ = _pieces(mesh_name)
    lam = 0.0 if lam == "poisson" else 1.0 / (cfg.g * cfg.dt ** 2)
    dist_lv = multigrid.build_dist_levels(
        pgrid, cfg, lam, halo.pad2d, halo.crop2d,
        lambda a: halo.psum2(torch.sum(a)),
        functools.partial(dist._global_checkerboard, mesh=mesh))
    levels = multigrid.mesh_levels(grid, cfg, lam, (mesh.shape["y"],
                                                   mesh.shape["x"]))
    assert len(levels) == len(dist_lv) >= 2
    assert [tuple(lv.mask.shape) for lv in levels] == multigrid.level_shapes(
        (cfg.ny, cfg.nx), mesh_solve.MIN_LOCAL,
        (mesh.shape["y"], mesh.shape["x"]))
    for k, (lv, dl) in enumerate(zip(levels, dist_lv)):
        for f in dataclasses.fields(multigrid.Level):
            a, d = getattr(lv, f.name), getattr(dl, f.name)
            if f.name == "nwet":
                assert float(a) == float(d), k
            elif isinstance(a, torch.Tensor):
                assert torch.equal(a, gather(d)), (k, f.name)
            else:
                assert a == d, (k, f.name)


@pytest.mark.parametrize("name,mesh_name,starts", [
    ("implicit_fs-jacobi", "2x2", "cold, warm"),
    ("implicit_fs-jacobi", "2x4", "cold, warm"),
    ("rigid_lid-mg", "2x2", "warm"),
    ("rigid_lid-mg", "2x4", "cold"),
    ("rigid_lid-jacobi", "2x2", "cold, warm")])
def test_gathered_plain_solve_matches_eager_mesh_solve(name, mesh_name,
                                                       starts):
    """K6's plain version on the gathered grid, with the mesh's hierarchy
    and gamma 2 for multigrid, against the eager mesh solve (_dist_cg): x
    within 1e-8 relative, the iterations within 2; the same through
    make_gathered_solve's gather and scatter."""
    _, cfg, grid, mesh, grid_l, pgrid, lam, b, x0 = _pieces(
        mesh_name, **SOLVES[name])
    route = mesh_solve.route(cfg, lam)
    hierarchy = (multigrid.mesh_levels(
        grid, cfg, lam, (mesh.shape["y"], mesh.shape["x"])), 2) \
        if route == "mg" else None
    solve = mesh_solve.make_gathered_solve(grid_l, cfg, mesh, lam)
    assert solve.route == route
    for warm in [{"cold": None, "warm": x0}[s] for s in starts.split(", ")]:
        eager = dist._dist_cg(shard(b, mesh), grid_l, pgrid, cfg, lam=lam,
                              x0=None if warm is None else shard(warm, mesh))
        plain = cg_fused.cg_solve_plain(b, grid, cfg, x0=warm, lam=lam,
                                        precond=route, hierarchy=hierarchy)
        ref = gather(eager.x)
        _close(plain.x, ref, f"{name} plain vs eager mesh")
        assert abs(plain.iters - eager.iters) <= 2, (plain.iters,
                                                     eager.iters)
        got = solve(shard(b, mesh), None if warm is None
                    else shard(warm, mesh))
        assert got.mesh is mesh and tuple(got.blocks[0].shape) == (
            b.shape[0] // mesh.shape["y"], b.shape[1] // mesh.shape["x"])
        _close(gather(got), ref, f"{name} gathered route vs eager mesh")


def _jax_dist_solve(jcase, mesh_shape, lam, b, x0):
    """beom_tpu's _dist_solve under shard_map on the virtual devices."""
    jcfg, jgrid, jforcing, _ = jcase
    jmesh = j_make_mesh(*mesh_shape)
    jpg1, _ = jdist.pad_statics(jgrid, jforcing, jcfg, jmesh, 1)

    def body(pg, b, x0):
        return jdist._dist_solve(b, jdist._crop_tree(pg, 1), pg, jcfg,
                                 lam=lam, x0=x0)

    fn = jax.jit(shard_map(body, mesh=jmesh, in_specs=(
        jax.tree.map(spec_for, jpg1), P("y", "x"), P("y", "x")),
        out_specs=P("y", "x")))
    return np.asarray(fn(jpg1, b.numpy(), x0.numpy()))


@pytest.mark.parametrize("name,mesh_name", [
    ("rigid_lid-mg", "2x2-32"), ("implicit_fs-jacobi", "2x4-32x64")])
def test_gathered_route_matches_reference_dist_solve(name, mesh_name):
    """The gathered route's plain version against beom_tpu's distributed
    solve on the same mesh, warm-started: within 1e-8 relative."""
    jcase, cfg, grid, mesh, grid_l, _, lam, b, x0 = _pieces(mesh_name,
                                                            **SOLVES[name])
    solve = mesh_solve.make_gathered_solve(grid_l, cfg, mesh, lam)
    got = gather(solve(shard(b, mesh), shard(x0, mesh)))
    ref = _jax_dist_solve(jcase, MESHES[mesh_name][0], lam, b, x0)
    _close(got, torch.tensor(ref), f"{name} vs beom_tpu")


@pytest.mark.parametrize("scheme,mesh_name", [
    ("rigid_lid", "2x2"), ("rigid_lid", "2x4"),
    ("implicit_fs", "2x4-32x64")])
def test_redblack_route_matches_dist_redblack(scheme, mesh_name):
    """K4a's plain sweeps on the gathered grid, solver_maxiter of them in
    passes of RB_SWEEPS (150: 18 passes and one of 6), against the eager
    mesh's _dist_redblack, cold and warm."""
    _, cfg, grid, mesh, grid_l, pgrid, lam, b, x0 = _pieces(
        mesh_name, scheme=scheme, solver="redblack", solver_maxiter=150)
    assert mesh_solve.rb_passes(150) == [8] * 18 + [6]
    solve = mesh_solve.make_gathered_solve(grid_l, cfg, mesh, lam)
    assert solve.route == "redblack"
    for warm in (None, x0):
        w = None if warm is None else shard(warm, mesh)
        ref = gather(dist._dist_redblack(shard(b, mesh), grid_l, pgrid, cfg,
                                         lam=lam, x0=w))
        _close(gather(solve(shard(b, mesh), w)), ref,
               f"{scheme} red-black vs _dist_redblack")


def test_cg_solve_keeps_its_own_hierarchy_by_default():
    """make_cg_solve and cg_solve_plain with no hierarchy build mg_levels'
    levels (min_size 16) and the fused gamma schedule, as before; the
    mesh's hierarchy gives the W-cycle at every transition, the coarsest
    level visited 2^(levels - 1) times, in the tier as above it."""
    _, cfg, grid, mesh, _, _, lam, b, _ = _pieces("2x2")
    own = cg_fused.make_cg_solve(grid, cfg, lam=lam, precond="mg")
    levels, gamma = cg_fused.mg_levels(grid, cfg, lam)
    assert gamma == multigrid.fused_gamma_schedule(levels, 2)
    tier, steps = mg_coarse.plan(levels, lam, cg_fused.MG_NU,
                                 cg_fused.MG_NU_COARSE, gamma, False,
                                 mg_coarse.H100_SMEM)
    assert own.steps == steps
    x_own = own(b).x
    assert torch.equal(x_own, cg_fused.cg_solve_plain(
        b, grid, cfg, lam=lam, precond="mg", hierarchy=(levels, gamma)).x)
    assert torch.equal(x_own, cg_fused.cg_solve_plain(b, grid, cfg, lam=lam,
                                                      precond="mg").x)
    # the mesh's hierarchy on 2 x 4 at 64^2: two levels, W on its one
    # transition; on a grid of five levels the W-cycle visits the last
    # one 16 times (each visit two runs of sweeps, forward and reversed)
    for shape, blocks in (((64, 64), (2, 4)), ((256, 256), (2, 2))):
        g = grid if shape == (64, 64) else _cases(nx=256, ny=256)[1][1]
        mesh_lv = multigrid.mesh_levels(g, cfg, lam, blocks)
        n = len(mesh_lv)
        solve = cg_fused.make_cg_solve(g, dataclasses.replace(
            cfg, ny=shape[0], nx=shape[1]), lam=lam, precond="mg",
            hierarchy=(mesh_lv, 2))
        last = [st for st in solve.steps if st[1] == n - 1
                and st[0] == mg_coarse.OP_SWEEPS]
        assert len(last) == 2 * 2 ** (n - 1), (shape, n, len(last))
        assert solve.steps != mg_coarse.plan(
            mesh_lv, lam, 2, 24, multigrid.fused_gamma_schedule(mesh_lv, 2),
            False, mg_coarse.H100_SMEM)[1]


def test_two_cards_gather_and_scatter():
    """The gathered route over two cards' stacks (the 2 x 4 mesh split
    along x and along y, on CPU shards): the gather puts every block in
    its place, the scatter hands back each card's stacked part (the
    layout the shard kernels read), and the solve equals one card's."""
    _, cfg, grid, mesh, grid_l, _, lam, b, x0 = _pieces("2x4")
    one = mesh_solve.make_gathered_solve(grid_l, cfg, mesh, lam)(
        shard(b, mesh), shard(x0, mesh))
    for labels in (["a", "a", "b", "b"] * 2, ["a"] * 4 + ["b"] * 4):
        cards = [dataclasses.replace(c, device=torch.device("cpu"))
                 for c in card_groups(labels, 2, 4)]
        out = mesh_solve.gather_field(shard(b, mesh), cards,
                                      torch.empty_like(b))
        assert torch.equal(out, b)
        back = mesh_solve.scatter_field(b, mesh, cards)
        assert torch.equal(gather(back), b)
        for c in cards:
            assert dist_band.stack_part(back, c.shards) is \
                back.stacked[c.shards]
        two = mesh_solve.make_gathered_solve(grid_l, cfg, mesh, lam,
                                             cards)(shard(b, mesh),
                                                    shard(x0, mesh))
        assert torch.equal(gather(two), gather(one))


@pytest.mark.parametrize("kw,want", [
    (dict(scheme="implicit_fs"), "K6-Jacobi"),
    (dict(scheme="implicit_fs", precond="mg"), "K6-mg"),
    (dict(), "K6-mg"),
    (dict(precond="jacobi"), "K6-Jacobi"),
    (dict(solver="redblack", solver_maxiter=150), "K4a's sweep mode"),
    (dict(precond="ssor"), "eager mesh solve"),
    (dict(scheme="implicit_fs", precond="ssor"), "eager mesh solve")])
def test_describe_names_the_route(kw, want):
    """The fused mesh stepper's plan names its solve's route and kernel;
    'ssor' names the eager mesh solve, which the gathered route refuses;
    on CPU shards the stepper's solve is the eager one."""
    _, (cfg, grid, forcing, _) = _cases(nx=64, ny=64, backend="pallas",
                                        **kw)
    mesh = make_mesh(2, 2, devices=["cpu"])
    text = dist_band.mesh_plan(cfg, torch.float64, mesh).describe()
    solve_text = text.split("; solve: ")[1]
    assert want in solve_text, solve_text
    assert "K3a's epilogue" not in text
    if "K6-mg" in want:
        assert "gamma 2 at every transition" in solve_text
        assert "3 levels (64, 64) to (16, 16)" in solve_text
    pgrid, _ = dist.pad_statics(grid, forcing, cfg, mesh, 1)
    grid_l = dist._crop_tree(pgrid, 1)
    lam = dist.pressure_lam(cfg)
    solve = mesh_solve.make_mesh_solve(grid_l, pgrid, cfg, mesh, lam)
    assert solve.route == "eager" and solve.describe() == solve_text
    if want == "eager mesh solve":
        with pytest.raises(ValueError, match="ssor"):
            mesh_solve.make_gathered_solve(grid_l, cfg, mesh, lam)
    else:
        assert mesh_solve.make_gathered_solve(grid_l, cfg, mesh,
                                              lam).route != "eager"
    with pytest.raises(NotImplementedError, match="single-device"):
        mesh_solve.route(dataclasses.replace(cfg, solver="mg"), lam)
