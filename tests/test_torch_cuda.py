"""The CUDA kernels against their plain PyTorch versions, on the card:
K1 (fused fb step, every case), K1s (the split step's three kernels),
K3a/K3b (projection phases, every case; the staged kernels at every
candidate geometry, K3a's epilogue, the fused step without a read-back),
K4a (blocked red-black
sweep, with and without its residual), K4b (operator pass), K5 (coarse
multigrid stack), K6 (fused CG, Jacobi and multigrid), K7 (the shard step
on a mesh of shards on the one card, around the fb and split bodies and
the projection phases) and K8 (the halo pad); and run() of the rigid lid's
two multigrid solves and of the mesh paths through them.  Also the
I/O and entry modules on the card: raw snapshots through the async writer,
entry() (one K1 launch, bit for bit its plain version) and
dryrun_multichip(8) (K7's launches by each fused leg's plan).

Skips where torch.cuda.is_available() is false.  It imports no jax, so
on a machine with a card and no jax it runs without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from beom_tpu_torch.cases import make_case
from beom_tpu_torch.solvers import elliptic
from beom_tpu_torch.solvers import multigrid as mg
from beom_tpu_torch.stencils import (cg_fused, fused_fb, fused_projection,
                                     mg_coarse, redblack)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda")


def _perturbed(device, seed, case="double_gyre", **kw):
    """A case plus a seeded perturbation of h, u and v."""
    cfg, grid, forcing, st = make_case(case, device=device, **kw)
    rng = np.random.default_rng(seed)

    def noise(amp, m):
        a = amp * rng.standard_normal((cfg.nz, cfg.ny, cfg.nx))
        return torch.tensor(a.astype(cfg.npdtype), device=device) * m

    st = st.replace(h=st.h + noise(0.5, grid.mask),
                    u=st.u + noise(0.05, grid.mask_u),
                    v=st.v + noise(0.05, grid.mask_v))
    return cfg, grid, forcing, st


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n_steps,rel,variant", [
    ("float64", 20, 1e-12, {}),
    ("float64", 20, 1e-12, dict(adv_scheme="linear", slip="no")),
    ("float32", 1, 4 * 2.0 ** -23, {}),
])
def test_kernel_matches_plain(cuda, dtype, n_steps, rel, variant):
    """200x136: sizes that are not multiples of the tile, so the ragged
    tiles and the wrap on both axes are exercised.  The f32 bound is
    4 ulp of each field's scale."""
    cfg, grid, forcing, st = _perturbed(cuda, 8, nx=200, ny=136,
                                        dtype=dtype)
    cfg = dataclasses.replace(cfg, **variant)
    args = (st.h, st.u, st.v, (grid, forcing), st.n, st.t, cfg, n_steps)
    before = fused_fb.LAUNCHES
    out = fused_fb.fused_fb_step(*args)
    torch.cuda.synchronize()
    assert fused_fb.LAUNCHES == before + len(
        fused_fb.plan(cfg, cfg.tdtype, n_steps).launches(n_steps))
    ref = fused_fb.fused_fb_step_plain(*args)
    for f, a, b in zip("huv", out, ref):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= rel * scale, (f, err, scale)


# K1 and K1s per case; the shelf adds nu4 and interfacial drag so that
# every compile-time switch is on in one build
CASE_KW = {
    "double_gyre": {},
    "two_layer": {},
    "coastal_wetdry": {},
    "shelf_forced": dict(nu4=1e6, r_int=1e-4),
}
SIZES = [("float32", 128, 128, 4 * 2.0 ** -23),
         ("float64", 200, 136, 1e-12)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nx,ny,rel", SIZES)
@pytest.mark.parametrize("name", list(CASE_KW))
def test_fb_kernel_matches_plain_per_case(cuda, name, dtype, nx, ny, rel):
    """K1 on each case at both sweep parities and over a 4-step pass (the
    plan's launches: ceil(4 / kb)): 4 ulp of the field's scale at f32,
    1e-12 x scale at f64 (the kernel mirrors the eager arithmetic, so 0.0
    is what the card gives)."""
    cfg, grid, forcing, st = _perturbed(cuda, 50, name, nx=nx, ny=ny,
                                        dtype=dtype, **CASE_KW[name])
    statics = (grid, forcing)
    for n, k in ((0, 1), (1, 1), (0, 4)):
        args = (st.h, st.u, st.v, statics, n, st.t, cfg, k)
        before = fused_fb.LAUNCHES
        out = fused_fb.fused_fb_step(*args)
        torch.cuda.synchronize()
        assert fused_fb.LAUNCHES == before + len(
            fused_fb.plan(cfg, cfg.tdtype, k).launches(k))
        ref = fused_fb.fused_fb_step_plain(*args)
        for f, a, b in zip("huv", out, ref):
            err = float((a - b).abs().max())
            assert err <= rel * float(b.abs().max()), (f, n, k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,nx,ny", [
    (name, dtype, nx, ny) for name in CASE_KW
    for dtype, nx, ny in (("float32", 128, 128), ("float64", 200, 136))]
    + [("double_gyre", "float32", 2048, 2048)])
def test_fb_pass_equals_single_steps(cuda, name, dtype, nx, ny):
    """One launch of the pass kernel of kb steps is bitwise kb launches of
    the single-step kernel, for every kb whose block fits a CTA, from both
    sweep parities (2048^2: the main path's case)."""
    cfg, grid, forcing, st = _perturbed(cuda, 52, name, nx=nx, ny=ny,
                                        dtype=dtype, **CASE_KW[name])
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))     # the tide is on
    statics = (grid, forcing)
    kbs = [m for m in range(2, 5)
           if fused_fb.launch_plan(cfg, cfg.tdtype, m) is not None]
    for kb in kbs:
        ts = fused_fb._times(st.t, cfg, kb)
        for n in (0, 1):
            before = fused_fb.LAUNCHES
            out = fused_fb._launch_fb(st.h, st.u, st.v, statics, n % 2, ts,
                                      cfg)
            assert fused_fb.LAUNCHES == before + 1
            h, u, v = st.h, st.u, st.v
            for i in range(kb):
                h, u, v = fused_fb._launch_fb(h, u, v, statics, (n + i) % 2,
                                              ts[i:i + 1], cfg)
            torch.cuda.synchronize()
            for f, a, b in zip("huv", out, (h, u, v)):
                assert torch.equal(a, b), (f, kb, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nx,ny,rel", SIZES)
@pytest.mark.parametrize("name,nsub", [
    ("double_gyre", 4), ("two_layer", 8), ("coastal_wetdry", 8),
    ("shelf_forced", 12)])
def test_split_kernels_match_plain(cuda, name, nsub, dtype, nx, ny, rel):
    """K1s: each of the three kernels against its eager phase from the
    same inputs, and the chained step over 3 steps, within the bounds of
    K1; one launch of each kernel per step."""
    from beom_tpu_torch.core.state import State
    from beom_tpu_torch.stepping import fb, split

    cfg, grid, forcing, st = _perturbed(
        cuda, 51, name, nx=nx, ny=ny, dtype=dtype, scheme="split",
        nsub=nsub, **CASE_KW[name])
    statics = (grid, forcing)

    def close(names, outs, refs):
        for f, a, b in zip(names, outs, refs):
            err = float((a - b).abs().max())
            assert err <= rel * float(b.abs().max()), (f, err)

    sp_ref = split.slow_phase(st, grid, forcing, cfg)
    close(sp_ref._fields,
          fused_fb.split_slow(st.h, st.u, st.v, statics, cfg), sp_ref)
    sub_ref = split.subcycle_phase(sp_ref, grid, cfg)
    close("eta ub vb ua va".split(), fused_fb.split_subcycle(
        sp_ref, st.h, st.u, st.v, statics, cfg), sub_ref)
    h1, u1, v1 = split.recompose(sp_ref, *sub_ref, st.h, grid, cfg)
    s1 = fb.finalize(h1, u1, v1, State(h=st.h, u=st.u, v=st.v, t=st.t, n=0),
                     grid, forcing, cfg)
    close("huv", fused_fb.split_recompose(
        sp_ref, sub_ref, st.h, st.u, st.v, statics, st.t, cfg),
        (s1.h, s1.u, s1.v))
    before = dict(fused_fb.SPLIT_LAUNCHES)
    args = (st.h, st.u, st.v, statics, 0, st.t, cfg, 3)
    out = fused_fb.fused_fb_step(*args)
    torch.cuda.synchronize()
    route = ("tend", "tail") if fused_fb.split_plan(cfg).route == 2 \
        else ("slow", "subcycle", "recompose")
    assert fused_fb.SPLIT_LAUNCHES == {
        k: v + 3 * (k in route) for k, v in before.items()}
    close("huv", out, fused_fb.fused_fb_step_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nx,ny,rel", SIZES + [
    ("float32", 201, 137, 0.0), ("float64", 37, 29, 0.0)])
@pytest.mark.parametrize("name,nsub", [
    ("double_gyre", 4), ("double_gyre", 12), ("two_layer", 8),
    ("coastal_wetdry", 8), ("shelf_forced", 8)])
def test_split_two_launches_match_plain_and_three(cuda, name, nsub, dtype,
                                                  nx, ny, rel):
    """K1s's two-launch step (the slow phase's tendencies, then the tail):
    the tendencies bit for bit the plain ones, and two steps bit for bit
    the plain split step and the three kernels, at odd sizes too, at the
    plan's tail geometry also where the plan keeps the three kernels; two
    launches per step."""
    from beom_tpu_torch.stepping import split

    cfg, grid, forcing, st = _perturbed(
        cuda, 52, name, nx=nx, ny=ny, dtype=dtype, scheme="split",
        nsub=nsub, **CASE_KW[name])
    statics = (grid, forcing)
    assert fused_fb.tail_geometries(cfg)
    tend = fused_fb._launch_tend(st.h, st.u, st.v, statics, cfg)
    for a, b in zip(tend, split.slow_tendencies(st, grid, forcing, cfg)):
        assert torch.equal(a, b)
    h, u, v, t = st.h, st.u, st.v, st.t
    three = (h, u, v)
    before = dict(fused_fb.SPLIT_LAUNCHES)
    for _ in range(2):
        t1 = t + cfg.npdtype.type(cfg.dt)
        tend = fused_fb._launch_tend(h, u, v, statics, cfg)
        h, u, v = fused_fb._launch_tail(tend, h, u, v, statics, t1, cfg)
        slow = fused_fb._launch_slow(*three, statics, cfg)
        sub = fused_fb._launch_subcycle(slow, *three, statics, cfg)
        three = fused_fb._launch_recompose(slow, sub, *three, statics, t1,
                                           cfg)
        t = t1
    torch.cuda.synchronize()
    assert fused_fb.SPLIT_LAUNCHES["tend"] == before["tend"] + 2
    assert fused_fb.SPLIT_LAUNCHES["tail"] == before["tail"] + 2
    ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, statics, 0, st.t,
                                       cfg, 2)
    for f, a, b, c in zip("huv", (h, u, v), three, ref):
        assert torch.equal(a, b), (f, float((a - b).abs().max()))
        assert torch.equal(a, c), (f, float((a - c).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name,nsub", [
    ("double_gyre", 8), ("two_layer", 8), ("coastal_wetdry", 4)])
def test_shard_split_equals_two_launch_step(cuda, name, nsub):
    """K7-split's 2-step pass on (2, 4) shards bit for bit two steps of
    the two-launch route on one device."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band

    cfg, grid, forcing, st = _perturbed(cuda, 57, name, nx=512, ny=256,
                                        scheme="split", nsub=nsub,
                                        **CASE_KW[name])
    assert fused_fb.split_plan(cfg).route == 2
    statics = (grid, forcing)
    m = pmesh.make_mesh(2, 4, devices=[cuda])
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    before = fused_fb.SPLIT_LAUNCHES["tail"]
    out = dist_band.shard_step(*sh, pstat, 0, st.t, cfg, 2,
                               kernels=dist_band.MeshKernels(statics, cfg, m))
    ref = fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0, st.t, cfg, 2)
    torch.cuda.synchronize()
    assert fused_fb.SPLIT_LAUNCHES["tail"] == before + 2
    for a, b in zip(out, ref):
        assert torch.equal(pmesh.gather(a), b)


@pytest.mark.cuda
def test_kernel_refuses_projection_scheme(cuda):
    cfg, grid, forcing, st = _perturbed(cuda, 9, nx=64, ny=48)
    cfg = dataclasses.replace(cfg, scheme="implicit_fs")
    with pytest.raises(NotImplementedError, match="fused_projection"):
        fused_fb.fused_fb_step(st.h, st.u, st.v, (grid, forcing), st.n,
                               st.t, cfg, 1)


def _max_err(out, ref):
    return max(float((a - b).abs().max()) for a, b in zip(out, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
def test_projection_phases_match_plain(cuda, scheme, n):
    """K3a and K3b on a 200x136 f64 grid: bit for bit."""
    cfg, grid, forcing, st = _perturbed(cuda, 10, "rigid_lid", nx=200,
                                        ny=136, dtype="float64",
                                        scheme=scheme, precond="jacobi")
    statics = (grid, forcing)
    before = dict(fused_projection.LAUNCHES)
    a = fused_projection.proj_a(st.h, st.u, st.v, statics, n, cfg)
    a_ref = fused_projection.proj_a_plain(st.h, st.u, st.v, statics, n, cfg)
    p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=cuda) \
        * grid.mask
    b = fused_projection.proj_b(st.h, a_ref[0], a_ref[1], p, statics, st.t,
                                cfg)
    b_ref = fused_projection.proj_b_plain(st.h, a_ref[0], a_ref[1], p,
                                          statics, st.t, cfg)
    torch.cuda.synchronize()
    assert fused_projection.LAUNCHES == {
        k: v + 1 for k, v in before.items()}
    assert _max_err(a, a_ref) == 0.0 and _max_err(b, b_ref) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lam", [0.0, 1e-9])
def test_rb_sweep_matches_plain(cuda, lam, reverse):
    """One k = 8 pass on a 200x136 f64 grid: bit for bit."""
    cfg, grid, _, st = _perturbed(cuda, 11, "rigid_lid", nx=200, ny=136,
                                  dtype="float64")
    Hu, Hv = elliptic.face_depths(grid)
    b = st.h[0] - grid.H
    x = torch.randn_like(b) * grid.mask
    kw = dict(lam=lam, k=8, omega=cfg.sor_omega, reverse=reverse)
    before = redblack.LAUNCHES
    out = redblack.rb_sweep(x, b, Hu, Hv, grid.mask, cfg.dx, cfg.dy, **kw)
    torch.cuda.synchronize()
    assert redblack.LAUNCHES == before + 1
    ref = redblack.rb_sweep_plain(x, b, Hu, Hv, grid.mask, cfg.dx, cfg.dy,
                                  **kw)
    assert float((out - ref).abs().max()) == 0.0


def _wet_seams(device, ny, nx, seed, dtype=torch.float64):
    """Face depths of seeded positive depths, an all-wet mask and seeded x
    and b on a periodic (ny, nx) grid: at odd sizes the periodic seams
    join wet cells of one colour."""
    from beom_tpu_torch.core import ops

    rng = np.random.default_rng(seed)

    def field(amp, base=0.0):
        a = base + amp * rng.standard_normal((ny, nx))
        return torch.tensor(a, dtype=dtype, device=device)

    H = field(50.0, 400.0)
    Hu, Hv = ops.a_xp(H).contiguous(), ops.a_yp(H).contiguous()
    return Hu, Hv, torch.ones_like(H), field(1.0), field(1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("reverse", [False, True])
def test_rb_sweep_odd_size_wet_seams(cuda, reverse, k, residual):
    """A K4a pass on a 201x137 f64 grid wet on both sides of both periodic
    seams, where two cells of one colour are neighbours: bit for bit."""
    Hu, Hv, m, x, b = _wet_seams(cuda, 137, 201, 17)
    kw = dict(lam=1e-9, k=k, omega=1.0 if residual else 1.7,
              reverse=reverse, residual=residual)
    out = redblack.rb_sweep(x, b, Hu, Hv, m, 1e4, 9e3, **kw)
    ref = redblack.rb_sweep_plain(x, b, Hu, Hv, m, 1e4, 9e3, **kw)
    torch.cuda.synchronize()
    for a, r in zip(out if residual else [out], ref if residual else [ref]):
        assert float((a - r).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 2, 8])
@pytest.mark.parametrize("lam", [0.0, 1e-9])
@pytest.mark.parametrize("shape,dtype,rel", [
    ((137, 201), torch.float64, 1e-12),
    ((256, 256), torch.float32, 1e-5),
])
def test_rb_pass_matches_plain(cuda, shape, dtype, rel, lam, k):
    """The blocked solve's pass (k sweeps, r in laplacian_H's order, the
    device's sum of r^2): x and r bit for bit, the sum within `rel` of
    torch.sum's (another order of the same terms)."""
    Hu, Hv, m, x, b = _wet_seams(cuda, *shape, 19, dtype)
    kw = dict(lam=lam, k=k, omega=1.7)
    before = redblack.LAUNCHES
    out, r, s = redblack.rb_pass(x, b, Hu, Hv, m, 1e4, 9e3, **kw)
    ref, r_ref, s_ref = redblack.rb_pass_plain(x, b, Hu, Hv, m, 1e4, 9e3,
                                               **kw)
    torch.cuda.synchronize()
    assert redblack.LAUNCHES == before + 1
    assert torch.equal(out, ref) and torch.equal(r, r_ref)
    assert abs(float(s) - float(s_ref)) <= rel * float(s_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["converges", "max_passes", "converged"])
@pytest.mark.parametrize("helmholtz", [False, True])
def test_fused_rb_solve_matches_plain_loop(cuda, helmholtz, case):
    """make_fused_rb_solve on a 200x136 f64 rigid lid, lam = 0 and
    1/(g dt^2), b = A x for a perturbation x: the plain per-pass loop's x
    bit for bit and its pass count, with the test read once per batch of
    passes; one residual launch and the passes of the batches."""
    cfg, grid, _, st = _perturbed(cuda, 12, "rigid_lid", nx=200, ny=136,
                                  dtype="float64")
    lam = 1.0 / (cfg.g * cfg.dt ** 2) if helmholtz else 0.0
    Hu, Hv = elliptic.face_depths(grid)
    b = elliptic.laplacian_H((st.h[0] - grid.H) * grid.mask, Hu, Hv, grid,
                             cfg, lam=lam)
    kw = dict(lam=lam, k=2, tol=1e-3, max_passes=3 if case == "max_passes"
              else 400)
    x0 = None
    if case == "converged":
        x0 = redblack.rb_solve_plain(b, grid, cfg, **kw)[0]
    ref, n_ref = redblack.rb_solve_plain(b, grid, cfg, x0=x0, **kw)
    solve = redblack.make_fused_rb_solve(grid, cfg, **kw)
    before = (redblack.LAUNCHES, redblack.PASSES, redblack.IDLE,
              redblack.SOLVES)
    x = solve(b, x0)
    torch.cuda.synchronize()
    launches, passes, idle, solves = (
        u - v for u, v in zip((redblack.LAUNCHES, redblack.PASSES,
                               redblack.IDLE, redblack.SOLVES), before))
    assert passes == n_ref and solves == 1
    assert launches == 1 + passes + idle
    assert torch.equal(x, ref)
    assert (n_ref == 0) == (case == "converged")
    assert (n_ref == 3) == (case == "max_passes")


def _cg_case(device, name, ny, nx):
    """(cfg, grid, b) at f64: the perturbed rigid lid or coastal_wetdry
    (its coast), or ('wet') a grid wet everywhere, where the periodic
    seams join wet cells; b a seeded field on the wet cells."""
    from beom_tpu_torch.core.config import Config
    from beom_tpu_torch.core.grid import make_grid

    if name == "wet":
        cfg = Config(nx=nx, ny=ny, dx=1e4, dy=9e3, solver_maxiter=5000,
                     dtype="float64")
        rng = np.random.default_rng(13)
        H = 400.0 + 50.0 * rng.standard_normal((ny, nx))
        grid = make_grid(cfg, H, np.ones((ny, nx)), device=device)
        b = torch.tensor(rng.standard_normal((ny, nx)), device=device)
        return cfg, grid, b * grid.mask
    cfg, grid, _, st = _perturbed(device, 12, name, nx=nx, ny=ny,
                                  dtype="float64", solver_maxiter=5000)
    return cfg, grid, (st.h[0] - grid.H) * grid.mask


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
@pytest.mark.parametrize("name,ny,nx", [
    ("rigid_lid", 136, 200), ("wet", 137, 201), ("coastal_wetdry", 136, 200),
    ("rigid_lid", 1019, 1021)])
def test_cg_fused_matches_plain(cuda, kind, name, ny, nx):
    """The Jacobi kernel's solve at f64 on the 200x136 rigid lid, 201x137
    wet across the periodic seams, the coastal_wetdry mask and 1021x1019,
    whose prime sizes no tile divides: x within 1e-6 x scale of the plain
    CG, the iteration counts within 1, the true residual within 20 tol
    |b|, two launches bitwise equal, one launch per solve."""
    cfg, grid, b = _cg_case(cuda, name, ny, nx)
    lam = 0.0 if kind == "neumann" else 1.0 / (cfg.g * cfg.dt ** 2)
    solve = cg_fused.make_cg_solve(grid, cfg, lam=lam, precond="jacobi")
    before = cg_fused.LAUNCHES
    res, res2 = solve(b), solve(b)
    assert cg_fused.LAUNCHES == before + 2
    ref = cg_fused.cg_solve_plain(b, grid, cfg, lam=lam)
    assert torch.equal(res.x, res2.x)
    assert abs(res.iters - ref.iters) <= 1, (res.iters, ref.iters)
    scale = float(ref.x.abs().max())
    assert float((res.x - ref.x).abs().max()) <= 1e-6 * scale
    Hu, Hv = elliptic.face_depths(grid)
    r = (b - elliptic.laplacian_H(res.x, Hu, Hv, grid, cfg, lam=lam)) \
        * grid.mask
    if lam == 0.0:      # the residual of the compatible (deflated) system
        r = (r - grid.mask * r.sum() / grid.mask.sum()) * grid.mask
    assert float(r.norm()) <= 20 * cfg.solver_tol * float(b.norm())


@pytest.mark.cuda
def test_cg_jacobi_plan_has_uneven_tiles(cuda):
    """The plan at 1021x1019 on this card splits both axes into tiles of
    two sizes, so test_cg_fused_matches_plain meets uneven tiles."""
    ctas = cg_fused._query("cg_jacobi", "ctas", torch.float64)
    nty, ntx = cg_fused.tile_plan(1019, 1021, ctas, 8)
    assert 1019 % nty and 1021 % ntx, (nty, ntx)


@pytest.mark.cuda
def test_cg_jacobi_one_launch_per_solve(cuda):
    """Through the projection step's solve (fused_projection.make_solve),
    each Jacobi solve is one launch, whatever its iterations."""
    cfg, grid, b = _cg_case(cuda, "rigid_lid", 136, 200)
    lam = 1.0 / (cfg.g * cfg.dt ** 2)
    solve = fused_projection.make_solve(
        grid, dataclasses.replace(cfg, precond="jacobi"), lam)
    before = cg_fused.LAUNCHES
    x = None
    for _ in range(3):
        x = solve(b, x)
    torch.cuda.synchronize()
    assert cg_fused.LAUNCHES == before + 3


@pytest.mark.cuda
def test_cg_mg_unchanged_by_a_jacobi_solve(cuda):
    """K6 with multigrid at 200x136 f64 gives x bit for bit the same
    before and after a Jacobi solve on the same stream: the two kernels
    share no state."""
    cfg, grid, b = _cg_case(cuda, "rigid_lid", 136, 200)
    mg_solve = cg_fused.make_cg_solve(grid, cfg, lam=0.0, precond="mg")
    jacobi = cg_fused.make_cg_solve(grid, cfg, lam=0.0, precond="jacobi")
    first = mg_solve(b)
    jacobi(b)
    again = mg_solve(b)
    torch.cuda.synchronize()
    assert first.iters == again.iters and torch.equal(first.x, again.x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nx,ny,rel", SIZES)
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("name", ["two_layer", "coastal_wetdry",
                                  "shelf_forced"])
def test_projection_phases_match_plain_per_case(cuda, name, scheme, dtype,
                                                nx, ny, rel):
    """K3a and K3b with every term: two layers, wet/dry with dry cells in
    the state, open faces with the tide at t + dt, nu4, quadratic and
    interfacial drag; both parities.  The bounds are K1's (0.0 is what the
    card gives)."""
    kw = dict(CASE_KW[name], cd_bot=2.5e-3) if name == "shelf_forced" \
        else CASE_KW[name]
    cfg, grid, forcing, st = _perturbed(cuda, 52, name, nx=nx, ny=ny,
                                        dtype=dtype, scheme=scheme, **kw)
    if cfg.wetdry:
        st = st.replace(h=torch.where(st.h < 0.3, 0.0, st.h))
    statics = (grid, forcing)
    t = cfg.npdtype.type(7 * cfg.dt)
    p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=cuda) \
        * grid.mask

    def close(names, outs, refs):
        for f, a, b in zip(names, outs, refs):
            err = float((a - b).abs().max())
            assert err <= rel * max(float(b.abs().max()), 1e-30), (f, err)

    for n in (0, 1):
        before = dict(fused_projection.LAUNCHES)
        a = fused_projection.proj_a(st.h, st.u, st.v, statics, n, cfg)
        a_ref = fused_projection.proj_a_plain(st.h, st.u, st.v, statics, n,
                                              cfg)
        b = fused_projection.proj_b(st.h, a_ref[0], a_ref[1], p, statics, t,
                                    cfg)
        b_ref = fused_projection.proj_b_plain(st.h, a_ref[0], a_ref[1], p,
                                              statics, t, cfg)
        torch.cuda.synchronize()
        assert fused_projection.LAUNCHES == {
            k: v + 1 for k, v in before.items()}
        close(("us", "vs", "div"), a, a_ref)
        close("huv", b, b_ref)


PHASE_CASES = {"rigid_lid": {}, "two_layer": {}, "coastal_wetdry": {},
               "shelf_forced": dict(nu4=1e6, r_int=1e-4, cd_bot=2.5e-3)}


def _phase_case(cuda, name, scheme, dtype, nx=201, ny=137, seed=57):
    """A perturbed case at t = 7 dt (the tide on), dry cells under wet/dry,
    and a wet pressure field."""
    cfg, grid, forcing, st = _perturbed(cuda, seed, name, nx=nx, ny=ny,
                                        dtype=dtype, scheme=scheme,
                                        **PHASE_CASES[name])
    if cfg.wetdry:
        st = st.replace(h=torch.where(st.h < 0.3, 0.0, st.h))
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(seed)) \
        * grid.mask
    return cfg, (grid, forcing), st, p


def _equal(outs, refs, what):
    for i, (a, b) in enumerate(zip(outs, refs)):
        assert torch.equal(a, b), (what, i, float((a - b).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("name", list(PHASE_CASES))
def test_staged_phases_match_plain(cuda, name, scheme, dtype):
    """The plan's phase kernels (the staged K3a / K3b where it takes them)
    and the single-step kernels, bit for bit the plain phases on a 201 x
    137 grid, which no tile divides, at both sweep parities; one launch
    of each phase per call."""
    cfg, statics, st, p = _phase_case(cuda, name, scheme, dtype)
    grid, forcing = statics
    single = fused_projection.PhasePlan(None, None, False)
    for ph in (fused_projection.Phases(grid, forcing, cfg),
               fused_projection.Phases(grid, forcing, cfg,
                                       phase_plan=single)):
        for n in (0, 1):
            before = dict(fused_projection.LAUNCHES)
            a = ph.a(st.h, st.u, st.v, n)
            a_ref = fused_projection.proj_a_plain(st.h, st.u, st.v, statics,
                                                  n, cfg)
            b = ph.b(st.h, a_ref[0], a_ref[1], p, st.t)
            b_ref = fused_projection.proj_b_plain(st.h, a_ref[0], a_ref[1],
                                                  p, statics, st.t, cfg)
            torch.cuda.synchronize()
            assert fused_projection.LAUNCHES == {
                k: v + 1 for k, v in before.items()}
            _equal(a, a_ref, (ph.plan, n, "A"))
            _equal(b, b_ref, (ph.plan, n, "B"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("name", list(PHASE_CASES))
def test_phase_a_rhs_matches_plain(cuda, name, scheme, dtype):
    """K3a's epilogue: the solve's right-hand side (implicit_rhs, and
    rigid_rhs from the epilogue's anomaly with its de-mean in torch) and
    warm start (warm_x0; eta^n without carries), bit for bit the eager
    composition, with both carries, with phi alone and with none."""
    cfg, statics, st, p = _phase_case(cuda, name, scheme, dtype)
    grid, forcing = statics
    ph = fused_projection.Phases(grid, forcing, cfg)
    assert ph.plan.rhs == (cfg.nz <= 2)
    phi_prev = 0.5 * p
    for carries in ((p, phi_prev), (p, None), (None, None)):
        for n in (0, 1):
            out = ph.a_rhs(st.h, st.u, st.v, n, *carries)
            u_s, v_s, div = fused_projection.proj_a_plain(
                st.h, st.u, st.v, statics, n, cfg)
            ref = (u_s, v_s) + fused_projection._rhs_plain(
                st.h, div, grid, cfg, ph.lam, *carries)
            torch.cuda.synchronize()
            if ref[3] is None:
                assert out[3] is None
                out, ref = out[:3], ref[:3]
            _equal(out, ref, (carries[0] is None, carries[1] is None, n))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rigid_lid", "shelf_forced"])
def test_staged_candidates_match_plain(cuda, name):
    """Every candidate geometry of the staged kernels (what
    tools/k3_probes.py --sweep times), bit for bit the plain phases at
    f32, both parities."""
    from beom_tpu_torch.stencils import build

    cfg, statics, st, p = _phase_case(cuda, name, "implicit_fs", "float32")
    grid, forcing = statics
    plans = fused_projection.candidates(cfg, torch.float32)
    dmask = fused_projection.derived_masks(grid)
    build.build_all([fused_projection.build_spec(cfg, torch.float32, pl,
                                                 dmask) for pl in plans])
    for pl in plans:
        ph = fused_projection.Phases(grid, forcing, cfg, phase_plan=pl)
        for n in (0, 1):
            a = ph.a(st.h, st.u, st.v, n)
            a_ref = fused_projection.proj_a_plain(st.h, st.u, st.v, statics,
                                                  n, cfg)
            b = ph.b(st.h, a_ref[0], a_ref[1], p, st.t)
            torch.cuda.synchronize()
            _equal(a, a_ref, (pl, n, "A"))
            _equal(b, fused_projection.proj_b_plain(
                st.h, a_ref[0], a_ref[1], p, statics, st.t, cfg),
                (pl, n, "B"))


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
def test_fused_projection_step_waits_for_nothing(cuda, scheme):
    """The fused stepper's step with Jacobi CG: K3a (with the right-hand
    side), the solve and K3b, with no read-back of the solve's count, bit
    for bit the plain phases around the same solve."""
    from beom_tpu_torch.stepping import make_stepper, prepare_state

    cfg, statics, st, _ = _phase_case(cuda, "rigid_lid", scheme, "float32")
    cfg = dataclasses.replace(cfg, backend="fused", precond="jacobi")
    grid, forcing = statics
    st = prepare_state(st, cfg)
    step = make_stepper(grid, forcing, cfg)
    out = step(st)
    lam = 0.0 if scheme == "rigid_lid" else 1.0 / (cfg.g * cfg.dt ** 2)
    u_s, v_s, div = fused_projection.proj_a_plain(st.h, st.u, st.v, statics,
                                                  st.n, cfg)
    rhs, x0 = fused_projection._rhs_plain(st.h, div, grid, cfg, lam, st.phi,
                                          st.phi_prev)
    solve = cg_fused.make_cg_solve(grid, cfg, lam=lam, precond="jacobi")
    p = solve(rhs, x0=x0).x
    ref = fused_projection.proj_b_plain(st.h, u_s, v_s, p, statics, st.t,
                                        cfg)
    torch.cuda.synchronize()
    _equal((out.h, out.u, out.v, out.phi), ref + (p,), scheme)


MESHES = [(2, 4), (1, 8), (8, 1), (1, 1), (4, 1), (2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mesh_shape", MESHES[:4] + [(12, 8)])
def test_halo_pad_matches_plain(cuda, mesh_shape, dtype):
    """K8 against pad2d by slices and concatenations, 2-D and layered
    fields, three widths: a copy, so bit for bit; one launch for every
    shard, the padded blocks views of one allocation; on (12, 8), more
    shards than the launch's parameters hold, the pointer table in device
    memory."""
    from beom_tpu_torch.parallel import halo, mesh as pmesh
    from beom_tpu_torch.stencils import halo_pad

    m = pmesh.make_mesh(*mesh_shape, devices=[cuda])
    g = torch.Generator(device="cpu").manual_seed(53)
    for lead in ((), (3,)):
        a = torch.randn(lead + (192, 128), generator=g,
                        dtype=getattr(torch, dtype)).to(cuda)
        sa = pmesh.shard(a, m)
        for w in (1, 3, 5):
            before = halo_pad.LAUNCHES
            out = halo_pad.halo_pad(sa, w)
            torch.cuda.synchronize()
            assert halo_pad.LAUNCHES == before + 1
            ref = halo_pad.halo_pad_plain(sa, w)
            for x, y in zip(out.blocks, ref.blocks):
                assert torch.equal(x, y)
            assert len({b.untyped_storage().data_ptr()
                        for b in out.blocks}) == 1
    with halo.impl("rdma"):
        before = halo_pad.LAUNCHES
        halo.pad2d(sa, 2)
        assert halo_pad.LAUNCHES == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nx,ny,rel", [
    ("float32", 256, 256, 4 * 2.0 ** -23), ("float64", 192, 128, 1e-12)])
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 4), (2, 2)])
@pytest.mark.parametrize("name", list(CASE_KW))
def test_shard_step_matches_plain_and_single_device(cuda, name, mesh_shape,
                                                    dtype, nx, ny, rel):
    """K7 on every fb case, both parities and a 2-step pass: against its
    plain version per shard and bit for bit single-device K1 on the
    gathered field (the arithmetic per point is K1's); the mesh plan's
    launches, one for every shard."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band

    cfg, grid, forcing, st = _perturbed(cuda, 54, name, nx=nx, ny=ny,
                                        dtype=dtype, **CASE_KW[name])
    cfg = dataclasses.replace(cfg, mesh_y=mesh_shape[0],
                              mesh_x=mesh_shape[1])
    m = pmesh.make_mesh(*mesh_shape, devices=[cuda])
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh, su, sv = (pmesh.shard(a, m) for a in (st.h, st.u, st.v))
    K = dist_band.MeshKernels((grid, forcing), cfg, m)
    for n, k in ((0, 1), (1, 1), (0, 2)):
        before = dict(dist_band.LAUNCHES)
        out = dist_band.shard_step(sh, su, sv, pstat, n, st.t, cfg, k,
                                   kernels=K)
        torch.cuda.synchronize()
        launches = dist_band.mesh_plan(cfg, st.h.dtype, m).fb_launches(k)
        assert dist_band.LAUNCHES["fb"] == before["fb"] + len(launches)
        ref = dist_band.shard_step_plain(sh, su, sv, pstat, n, st.t, cfg, k)
        one = fused_fb.fused_fb_step(st.h, st.u, st.v, (grid, forcing), n,
                                     st.t, cfg, k)
        for f, a, b, c in zip("huv", out, ref, one):
            a, b = pmesh.gather(a), pmesh.gather(b)
            scale = float(c.abs().max())
            assert float((a - b).abs().max()) <= rel * scale, (f, n, k)
            assert torch.equal(a, c), (f, n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 4), (2, 2)])
@pytest.mark.parametrize("name", list(CASE_KW))
def test_shard_pass_equals_k1_pass(cuda, name, mesh_shape, dtype):
    """K7's pass kernel of kb = 2 and 3 steps, one launch for every shard,
    bit for bit K1's pass kernel of the same kb on one device (itself bit
    for bit kb single steps), both parities, from a time at which the
    tides are on; where no pass kernel's block fits a CTA (the f64 shelf),
    the mesh plan keeps the single-step kernel."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band

    cfg, grid, forcing, st = _perturbed(cuda, 59, name, nx=384, ny=256,
                                        dtype=dtype, **CASE_KW[name])
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    m = pmesh.make_mesh(*mesh_shape, devices=[cuda])
    K = dist_band.MeshKernels((grid, forcing), cfg, m)
    fields = [dist_band.stack_global(a, m) for a in (st.h, st.u, st.v)]
    fits = [kb for kb in (2, 3)
            if fused_fb.launch_plan(cfg, st.h.dtype, kb) is not None]
    if not fits:
        assert K.plan.fb_launches(4) == [1, 1, 1, 1]
    ran = 0
    for kb in fits:
        for n in (0, 1):
            before = dist_band.LAUNCHES["fb_pass"]
            with torch.cuda.device(cuda):
                out = K.fb(*fields, n, st.t, kb, kb=kb)
            one = fused_fb._launch_fb(st.h, st.u, st.v, (grid, forcing),
                                      n % 2, fused_fb._times(st.t, cfg, kb),
                                      cfg)
            torch.cuda.synchronize()
            assert dist_band.LAUNCHES["fb_pass"] == before + 1
            for f, a, b in zip("huv", out, one):
                assert torch.equal(pmesh.gather(dist_band.unstack(a, m)),
                                   b), (f, kb, n)
            ran += 1
    assert ran == 2 * len(fits)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["split", "rigid_lid"])
def test_shard_step_refuses_other_schemes(cuda, scheme):
    """The schemes the shard step once refused now build a fused mesh
    stepper on the card and step through their kernels."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.parallel.dist import make_dist_stepper
    from beom_tpu_torch.stencils import dist_band

    cfg, grid, forcing, st = make_case("double_gyre", nx=64, ny=64,
                                       device=cuda, scheme=scheme,
                                       backend="fused", precond="jacobi")
    m = pmesh.make_mesh(2, 2, devices=[cuda])
    kinds = dist_band.mesh_plan(cfg, cfg.tdtype, m).launches()
    before = dict(dist_band.LAUNCHES)
    out = make_dist_stepper(grid, forcing, cfg, m)(pmesh.shard_state(st, m))
    torch.cuda.synchronize()
    assert out.n == 1
    for k in kinds:
        assert dist_band.LAUNCHES[k] > before[k], k
    assert dist_band.build_spec(cfg)[0] == (
        "shard_split" if scheme == "split" else "shard_projection")


def _gathered_close(outs, refs, rel, what):
    """Every gathered field of outs within rel x scale of refs (0.0: bit
    for bit)."""
    from beom_tpu_torch.parallel import mesh as pmesh

    for i, (a, b) in enumerate(zip(outs, refs)):
        a, b = pmesh.gather(a), pmesh.gather(b)
        if rel == 0.0:
            assert torch.equal(a, b), (what, i)
            continue
        err = float((a - b).abs().max())
        assert err <= rel * max(float(b.abs().max()), 1e-30), (what, i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nx,ny,rel", [
    ("float32", 512, 256, 4 * 2.0 ** -23), ("float64", 192, 128, 1e-12)])
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 4), (2, 2)])
@pytest.mark.parametrize("name,nsub", [
    ("double_gyre", 4), ("two_layer", 8), ("coastal_wetdry", 8),
    ("shelf_forced", 12)])
def test_shard_split_matches_plain_and_single_device(cuda, name, nsub,
                                                     mesh_shape, dtype, nx,
                                                     ny, rel):
    """K7 around the split body: each of the five kernels (route 3's
    three, route 2's tendencies and tail) against its plain version per
    shard and bit for bit the single-device kernel (K1s) on the gathered
    field, and the chained 2-step pass bit for bit K1s's by the plan's
    route, one launch of each of its kernels per step for every shard."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band

    cfg, grid, forcing, st = _perturbed(cuda, 55, name, nx=nx, ny=ny,
                                        dtype=dtype, scheme="split",
                                        nsub=nsub, **CASE_KW[name])
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    statics = (grid, forcing)
    m = pmesh.make_mesh(*mesh_shape, devices=[cuda])
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    K = dist_band.MeshKernels(statics, cfg, m)
    slow = dist_band.shard_split_slow(*sh, pstat, cfg, kernels=K)
    one_slow = fused_fb._launch_slow(st.h, st.u, st.v, statics, cfg)
    torch.cuda.synchronize()
    _gathered_close(slow, dist_band.split_slow_plain(*sh, pstat, cfg), rel,
                    "slow vs plain")
    _gathered_close(slow, one_slow, 0.0, "slow vs K1s")
    sub = dist_band.shard_split_subcycle(slow, pstat, cfg, kernels=K)
    one_sub = fused_fb._launch_subcycle(one_slow, st.h, st.u, st.v, statics,
                                        cfg)
    torch.cuda.synchronize()
    _gathered_close(sub, dist_band.split_subcycle_plain(slow, pstat, cfg),
                    rel, "subcycle vs plain")
    _gathered_close(sub, one_sub, 0.0, "subcycle vs K1s")
    rec = dist_band.shard_split_recompose(slow, sub, sh[0], pstat, st.t, cfg,
                                          kernels=K)
    t1 = st.t + cfg.npdtype.type(cfg.dt)
    one_rec = fused_fb._launch_recompose(one_slow, one_sub, st.h, st.u, st.v,
                                         statics, t1, cfg)
    torch.cuda.synchronize()
    _gathered_close(rec, dist_band.split_recompose_plain(
        slow, sub, sh[0], pstat, st.t, cfg), rel, "recompose vs plain")
    _gathered_close(rec, one_rec, 0.0, "recompose vs K1s")
    tend = dist_band.shard_split_tend(*sh, pstat, cfg, kernels=K)
    one_tend = fused_fb._launch_tend(st.h, st.u, st.v, statics, cfg)
    tail = dist_band.shard_split_tail(tend, *sh, pstat, st.t, cfg,
                                      kernels=K)
    one_tail = fused_fb._launch_tail(one_tend, st.h, st.u, st.v, statics,
                                     t1, cfg)
    torch.cuda.synchronize()
    _gathered_close(tend, dist_band.split_tend_plain(*sh, pstat, cfg), rel,
                    "tend vs plain")
    _gathered_close(tend, one_tend, 0.0, "tend vs K1s")
    _gathered_close(tail, dist_band.split_tail_plain(tend, *sh, pstat, st.t,
                                                     cfg), rel,
                    "tail vs plain")
    _gathered_close(tail, one_tail, 0.0, "tail vs K1s")
    before = dict(dist_band.LAUNCHES)
    out = dist_band.shard_step(*sh, pstat, 0, st.t, cfg, 2, kernels=K)
    torch.cuda.synchronize()
    want = dist_band.mesh_plan(cfg, st.h.dtype, m).launches(2)
    assert {k: dist_band.LAUNCHES[k] - before[k] for k in before
            if dist_band.LAUNCHES[k] != before[k]} == want
    _gathered_close(out, fused_fb.fused_fb_step(
        st.h, st.u, st.v, statics, 0, st.t, cfg, 2), 0.0, "step vs K1s")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nx,ny,rel", [
    ("float32", 512, 256, 4 * 2.0 ** -23), ("float64", 192, 128, 1e-12)])
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 4), (2, 2)])
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("name", list(CASE_KW))
def test_shard_projection_matches_plain_and_single_device(
        cuda, name, scheme, mesh_shape, dtype, nx, ny, rel):
    """K7 around the projection bodies: phase A and phase B against their
    plain versions per shard and bit for bit K3a / K3b on the gathered
    field, both parities; one launch per phase for every shard."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band

    cfg, grid, forcing, st = _perturbed(cuda, 56, name, nx=nx, ny=ny,
                                        dtype=dtype, scheme=scheme,
                                        **CASE_KW[name])
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    statics = (grid, forcing)
    m = pmesh.make_mesh(*mesh_shape, devices=[cuda])
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=cuda) \
        * grid.mask
    sp = pmesh.shard(p, m)
    K = dist_band.MeshKernels(statics, cfg, m)
    for n in (0, 1):
        before = dict(dist_band.LAUNCHES)
        a = dist_band.shard_proj_a(*sh, pstat, n, cfg, kernels=K)
        one_a = fused_projection.proj_a(st.h, st.u, st.v, statics, n, cfg)
        b = dist_band.shard_proj_b(sh[0], a[0], a[1], sp, pstat, st.t, cfg,
                                   kernels=K)
        one_b = fused_projection.proj_b(st.h, one_a[0], one_a[1], p, statics,
                                        st.t, cfg)
        torch.cuda.synchronize()
        assert dist_band.LAUNCHES["proj_a"] == before["proj_a"] + 1
        assert dist_band.LAUNCHES["proj_b"] == before["proj_b"] + 1
        _gathered_close(a, dist_band.proj_a_plain(*sh, pstat, n, cfg), rel,
                        "A vs plain")
        _gathered_close(a, one_a, 0.0, "A vs K3a")
        _gathered_close(b, dist_band.proj_b_plain(sh[0], a[0], a[1], sp,
                                                  pstat, st.t, cfg), rel,
                        "B vs plain")
        _gathered_close(b, one_b, 0.0, "B vs K3b")


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("name", list(CASE_KW))
def test_shard_projection_equals_staged_phases(cuda, name, scheme):
    """K7-proj's two phases on (2, 4) shards, gathered, bit for bit the
    plan's staged K3a / K3b (whose stage bodies they run), both parities,
    f32."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band

    cfg, grid, forcing, st = _perturbed(cuda, 58, name, nx=512, ny=256,
                                        scheme=scheme, **CASE_KW[name])
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    statics = (grid, forcing)
    assert fused_projection.plan(cfg, cfg.tdtype).a is not None
    m = pmesh.make_mesh(2, 4, devices=[cuda])
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=cuda) \
        * grid.mask
    K = dist_band.MeshKernels(statics, cfg, m)
    for n in (0, 1):
        a = dist_band.shard_proj_a(*sh, pstat, n, cfg, kernels=K)
        one_a = fused_projection.proj_a(st.h, st.u, st.v, statics, n, cfg)
        b = dist_band.shard_proj_b(sh[0], a[0], a[1], pmesh.shard(p, m),
                                   pstat, st.t, cfg, kernels=K)
        one_b = fused_projection.proj_b(st.h, one_a[0], one_a[1], p, statics,
                                        st.t, cfg)
        torch.cuda.synchronize()
        for x, y in zip(a + b, one_a + one_b):
            assert torch.equal(pmesh.gather(x), y), (name, scheme, n)


def _layered(cfg, forcing, st, nz):
    """cfg, forcing and st with the bottom layer split into equal layers,
    each a little denser, up to nz layers: the same column, more
    layers."""
    parts, top = nz - cfg.nz + 1, cfg.nz - 1
    rho = tuple(cfg.rho[:top]) + tuple(cfg.rho[top] + i
                                       for i in range(parts))

    def split(a, share):
        return torch.cat([a[:top]] + [a[top:] / share] * parts)

    h_ext = split(forcing.h_ext, parts)
    return (dataclasses.replace(cfg, nz=nz, rho=rho),
            dataclasses.replace(forcing, h_ext=h_ext),
            st.replace(h=split(st.h, parts), u=split(st.u, 1),
                       v=split(st.v, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("name,nz", [("two_layer", 3),
                                     ("coastal_wetdry", 5)])
def test_shard_projection_single_step_phases(cuda, name, nz):
    """Where no staged geometry fits a CTA (f64 with nz = 3: phase A; with
    wet/dry and nz = 5: both phases), K7-proj runs the single-step bodies,
    one launch per phase for every shard of (2, 2), bit for bit the
    single-device K3a / K3b of the same plan, both parities; and the fused
    mesh stepper steps through them."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.parallel.dist import make_dist_stepper
    from beom_tpu_torch.stencils import dist_band

    cfg, grid, forcing, st = _perturbed(cuda, 61, name, nx=192, ny=128,
                                        dtype="float64", scheme="rigid_lid",
                                        **CASE_KW[name])
    cfg, forcing, st = _layered(cfg, forcing, st, nz)
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    pl = fused_projection.plan(cfg, torch.float64)
    assert pl.a is None and (pl.b is None) == (name == "coastal_wetdry")
    statics = (grid, forcing)
    m = pmesh.make_mesh(2, 2, devices=[cuda])
    K = dist_band.MeshKernels(statics, cfg, m)
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=cuda) \
        * grid.mask
    sp = pmesh.shard(p, m)
    for n in (0, 1):
        before = dict(dist_band.LAUNCHES)
        a = dist_band.shard_proj_a(*sh, pstat, n, cfg, kernels=K)
        one_a = fused_projection.proj_a(st.h, st.u, st.v, statics, n, cfg)
        b = dist_band.shard_proj_b(sh[0], a[0], a[1], sp, pstat, st.t, cfg,
                                   kernels=K)
        one_b = fused_projection.proj_b(st.h, one_a[0], one_a[1], p, statics,
                                        st.t, cfg)
        torch.cuda.synchronize()
        assert dist_band.LAUNCHES["proj_a"] == before["proj_a"] + 1
        assert dist_band.LAUNCHES["proj_b"] == before["proj_b"] + 1
        _gathered_close(a, dist_band.proj_a_plain(*sh, pstat, n, cfg), 1e-12,
                        "A vs plain")
        _gathered_close(a, one_a, 0.0, "A vs K3a")
        _gathered_close(b, dist_band.proj_b_plain(sh[0], a[0], a[1], sp,
                                                  pstat, st.t, cfg), 1e-12,
                        "B vs plain")
        _gathered_close(b, one_b, 0.0, "B vs K3b")
    fused = dataclasses.replace(cfg, backend="fused", precond="jacobi",
                                mesh_y=2, mesh_x=2)
    before = dict(dist_band.LAUNCHES)
    out = make_dist_stepper(grid, forcing, fused, m)(
        pmesh.shard_state(st, m))
    torch.cuda.synchronize()
    assert out.n == st.n + 1
    assert dist_band.LAUNCHES["proj_a"] == before["proj_a"] + 1
    assert all(bool(torch.isfinite(pmesh.gather(x)).all())
               for x in (out.h, out.u, out.v))


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,kw,pads", [
    ("fb", dict(backend="fused", steps_per_pass=2), 0),
    ("split", dict(backend="fused", nsub=4), 0),
    ("fb", dict(halo_impl="rdma"), 3),
    ("split", dict(halo_impl="rdma", nsub=4), None)])
def test_run_on_a_mesh_of_shards_on_the_card(cuda, scheme, kw, pads):
    """run() with a 2 x 4 mesh on the one card, as the command line starts
    it: the fused tier through K7 (the mesh plan's launches, one per kernel
    for every shard) and the eager tier with halo_impl='rdma' through K8
    (fb: 3 pad2d per step, one launch each), against the single-device run
    of the same backend: fb and split carry no reduction, so state and
    diagnostics are equal bit for bit."""
    import io

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.parallel.mesh import gather_state
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import dist_band, halo_pad

    n = 6
    cfg, grid, forcing, st = make_case(
        "double_gyre", nx=512, ny=512, device=cuda, scheme=scheme,
        diag_every=3, **kw)
    log1, logn = io.StringIO(), io.StringIO()
    ref = run(dataclasses.replace(cfg, halo_impl="ppermute"), grid, forcing,
              st, n, log=log1)
    dist_band.LAUNCHES.update(dict.fromkeys(dist_band.LAUNCHES, 0))
    halo_pad.LAUNCHES = 0
    out = gather_state(run(dataclasses.replace(cfg, mesh_y=2, mesh_x=4),
                           grid, forcing, st, n, log=logn))
    torch.cuda.synchronize()
    if cfg.backend == "fused":
        # the plan's launches: run() steps each chunk of diag_every steps
        # as its passes of steps_per_pass steps and single steps for the
        # remainder
        plan = dist_band.mesh_plan(cfg, st.h.dtype,
                                   pmesh.make_mesh(2, 4, devices=[cuda]))
        passes, rem = divmod(cfg.diag_every, cfg.steps_per_pass)
        want = dict.fromkeys(dist_band.LAUNCHES, 0)
        for k, times in ((cfg.steps_per_pass, passes), (1, rem)):
            for key, c in plan.launches(k).items():
                want[key] += c * times * (n // cfg.diag_every)
        assert dist_band.LAUNCHES == want
        assert halo_pad.LAUNCHES == 0
    elif pads is not None:
        assert halo_pad.LAUNCHES == pads * n
    else:
        assert halo_pad.LAUNCHES > 0
    assert logn.getvalue() == log1.getvalue()
    assert len(logn.getvalue().splitlines()) == 2
    for f in "huv":
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


@pytest.mark.cuda
def test_stall_guard_on_the_card(cuda):
    """The multigrid-preconditioned fused solve cut after 3 iterations is
    redone by the stall guard with the W-cycle through the blocked
    smoother and the coarse-stack kernel: the step is the eager step's
    within the solver's noise, and a converging solve is left alone."""
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import make_stepper, prepare_state

    cfg, grid, forcing, st = make_case(
        "shelf_forced", nx=256, ny=256, device=cuda, dtype="float64",
        scheme="rigid_lid", backend="fused", solver_maxiter=3)
    st = prepare_state(st, cfg)
    before = fp.COUNTS["stalled"]
    a = make_stepper(grid, forcing, cfg)(st)
    b = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="eager"))(st)
    assert fp.COUNTS["stalled"] == before + 1
    for f in "huv":
        x, y = getattr(a, f), getattr(b, f)
        assert float((x - y).abs().max()) <= 1e-12 * float(y.abs().max()), f
    make_stepper(grid, forcing, dataclasses.replace(
        cfg, solver_maxiter=500))(st)
    assert fp.COUNTS["stalled"] == before + 1


def _level_inputs(cuda, seed, lam=0.0):
    """The 200x136 f64 rigid-lid hierarchy and a seeded wet x and b."""
    cfg, grid, _, _ = make_case("rigid_lid", nx=200, ny=136, device=cuda,
                                dtype="float64")
    levels = mg.build_levels(grid, cfg, lam)
    g = torch.Generator(device="cpu").manual_seed(seed)
    m = grid.mask

    def field():
        return torch.randn(m.shape, generator=g, dtype=m.dtype).to(cuda) * m

    return cfg, grid, levels, field(), field()


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lam", [0.0, 1e-9])
def test_rb_sweep_residual_matches_plain(cuda, lam, reverse):
    """K4a with residual=True (k = 2, omega = 1, as the multigrid
    smoother): x and r bit for bit."""
    _, _, levels, x, b = _level_inputs(cuda, 14, lam)
    lv = levels[0]
    kw = dict(lam=lam, k=2, omega=1.0, reverse=reverse, residual=True)
    out = redblack.rb_sweep(x, b, lv.Hu.contiguous(), lv.Hv.contiguous(),
                            lv.mask, lv.dx, lv.dy, **kw)
    ref = redblack.rb_sweep_plain(x, b, lv.Hu, lv.Hv, lv.mask, lv.dx,
                                  lv.dy, **kw)
    torch.cuda.synchronize()
    for a, r in zip(out, ref):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["residual", "matvec"])
def test_apply_op_matches_plain(cuda, mode):
    """K4b, both modes, lam > 0: bit for bit."""
    _, _, levels, x, b = _level_inputs(cuda, 15, 1e-9)
    lv = levels[0]
    before = redblack.APPLY_LAUNCHES
    out = redblack.apply_op(x, b, lv.Hu.contiguous(), lv.Hv.contiguous(),
                            lv.mask, lv.dx, lv.dy, lam=1e-9, mode=mode)
    torch.cuda.synchronize()
    assert redblack.APPLY_LAUNCHES == before + 1
    ref = redblack.apply_op_plain(x, b, lv.Hu, lv.Hv, lv.mask, lv.dx, lv.dy,
                                  lam=1e-9, mode=mode)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("from_end", ["none", "default", 1, 2])
@pytest.mark.parametrize("demean", [False, True])
def test_coarse_stack_matches_plain(cuda, demean, from_end):
    """K5 on the whole ragged hierarchy (down to its odd 25x17 level),
    with the shared-memory tier over no level, the default (the largest
    that fits), the coarsest level and the two coarsest (every tier that
    fits at f64): without the de-mean bit for bit, with it 1e-12 x scale
    (its sums run in another order); two launches bitwise equal."""
    _, _, levels, _, b = _level_inputs(cuda, 16)
    gamma = mg.fused_gamma_schedule(levels, 2)
    if from_end == "none":
        tier = len(levels)
    elif from_end == "default":
        tier = None
    else:
        tier = len(levels) - from_end
    call = mg_coarse.make_coarse_stack_call(levels, 0.0, gamma=gamma,
                                            demean=demean, tier=tier)
    assert call.tier == (2 if from_end == "default" else tier)
    before = mg_coarse.LAUNCHES
    out, again = call(b), call(b)
    torch.cuda.synchronize()
    assert mg_coarse.LAUNCHES == before + 2
    assert torch.equal(out, again)
    ref = mg_coarse.coarse_stack_plain(levels, b, 0.0, gamma=gamma,
                                       demean=demean)
    err = float((out - ref).abs().max())
    assert err <= (1e-12 * float(ref.abs().max()) if demean else 0.0), err


@pytest.mark.cuda
def test_coarse_stack_refuses_a_tier_too_large(cuda):
    """A tier the card's shared memory cannot hold raises; nothing falls
    back to another walk."""
    _, _, levels, _, _ = _level_inputs(cuda, 16)
    with pytest.raises(ValueError, match="does not fit"):
        mg_coarse.make_coarse_stack_call(levels, 0.0, tier=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_cg_mg_matches_plain(cuda, kind):
    """K6 with the multigrid preconditioner at 200x136 f64: iterations
    within 1 of the plain CG's, x within 1e-6 x scale, two launches
    bitwise equal, a warm start from the solution at most 1 iteration."""
    cfg, grid, _, _, b = _level_inputs(cuda, 17)
    lam = 0.0 if kind == "neumann" else 1.0 / (cfg.g * cfg.dt ** 2)
    solve = cg_fused.make_cg_solve(grid, cfg, lam=lam, precond="mg")
    before = cg_fused.LAUNCHES
    res, res2 = solve(b), solve(b)
    assert cg_fused.LAUNCHES == before + 2
    assert torch.equal(res.x, res2.x)
    ref = cg_fused.cg_solve_plain(b, grid, cfg, lam=lam, precond="mg")
    assert abs(res.iters - ref.iters) <= 1
    scale = float(ref.x.abs().max())
    assert float((res.x - ref.x).abs().max()) <= 1e-6 * scale
    assert solve(b, x0=res.x).iters <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(136, 200), (256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cg_mg_matches_plain_per_dtype(cuda, dtype, shape):
    """K6 with the multigrid preconditioner (the tier from 64^2 at f32,
    32^2 at f64) on the ragged 200x136 grid and at 256^2, lam = 0:
    iterations within 1 of the plain CG's, x within 1e-6 x scale at f64
    and 1e-3 x scale at f32 (chip_smoke.py's bounds)."""
    ny, nx = shape
    cfg, grid, _, _ = make_case("rigid_lid", nx=nx, ny=ny, device=cuda,
                                dtype=dtype)
    g = torch.Generator(device="cpu").manual_seed(18)
    b = torch.randn(grid.mask.shape, generator=g,
                    dtype=grid.mask.dtype).to(cuda) * grid.mask
    solve = cg_fused.make_cg_solve(grid, cfg, lam=0.0, precond="mg")
    res = solve(b)
    ref = cg_fused.cg_solve_plain(b, grid, cfg, lam=0.0, precond="mg")
    torch.cuda.synchronize()
    assert abs(res.iters - ref.iters) <= 1, (res.iters, ref.iters)
    scale = float(ref.x.abs().max())
    rel = 1e-6 if dtype == "float64" else 1e-3
    assert float((res.x - ref.x).abs().max()) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cg", "mg"])
def test_run_rigid_lid_multigrid(cuda, solver):
    """run() on the 128^2 f32 rigid lid with its default solve (K3a, K6
    with multigrid, K3b) and with solver='mg' (K3a, K5 for the whole
    hierarchy, K3b; K4a and K4b run from 256 rows): the kernels' counts,
    finite output."""
    import io

    from beom_tpu_torch.run import run

    cfg, grid, forcing, st = make_case("rigid_lid", nx=128, ny=128,
                                       device=cuda, backend="fused",
                                       solver=solver, diag_every=5)
    before = (fused_projection.LAUNCHES["proj_a"], cg_fused.LAUNCHES,
              mg_coarse.LAUNCHES, redblack.LAUNCHES)
    out = run(cfg, grid, forcing, st, 10, log=io.StringIO())
    torch.cuda.synchronize()
    after = (fused_projection.LAUNCHES["proj_a"], cg_fused.LAUNCHES,
             mg_coarse.LAUNCHES, redblack.LAUNCHES)
    delta = [a - b for a, b in zip(after, before)]
    assert delta[0] == 10 and delta[3] == 0
    if solver == "cg":
        assert delta[1] == 10 and delta[2] == 0
    else:
        assert delta[1] == 0 and delta[2] > 0
    assert bool(torch.isfinite(out.h).all()) and float(out.u.abs().max()) > 0
    column = float(((out.h.sum(0) - grid.H) * grid.mask).abs().max())
    assert column < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_raw_snapshot_round_trip_through_async_writer(cuda, dtype, tmp_path):
    """save_raw of a card state through the AsyncWriter (the host buffer
    freed right after submit) and synchronously: byte-equal files, loaded
    back onto the card bit for bit."""
    from beom_tpu_torch.io import native, snapshots

    cfg, grid, forcing, st = _perturbed(cuda, 14, nx=256, ny=192,
                                        dtype=dtype)
    a, b = tmp_path / "async.bin", tmp_path / "sync.bin"
    with native.AsyncWriter() as w:
        snapshots.save_raw(a, st, cfg, writer=w)
    snapshots.save_raw(b, st, cfg)
    assert a.read_bytes() == b.read_bytes()
    assert a.stat().st_size == 3 * 256 * 192 * np.dtype(dtype).itemsize
    back = snapshots.load_raw(a, cfg, device=cuda)
    for f in "huv":
        assert getattr(back, f).device.type == "cuda"
        assert torch.equal(getattr(back, f), getattr(st, f)), f


@pytest.mark.cuda
def test_entry_launches_k1_once(cuda):
    """entry()'s fn on the card: one launch of K1's single-step kernel,
    bit for bit K1's plain version from the same state."""
    from beom_tpu_torch import entry

    fn, (st,) = entry.entry()
    assert st.h.device.type == "cuda"
    cfg, grid, forcing, _ = make_case("double_gyre", nx=256, ny=256,
                                      backend="fused", device=cuda)
    st = entry.perturb(cfg, grid, st, 14)
    fused_fb.LAUNCHES = fused_fb.PASS_LAUNCHES = 0
    out = fn(st)
    torch.cuda.synchronize()
    assert (fused_fb.LAUNCHES, fused_fb.PASS_LAUNCHES) == (1, 0)
    ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, (grid, forcing),
                                       st.n, st.t, cfg, 1)
    for f, r in zip("huv", ref):
        assert torch.equal(getattr(out, f), r), f


@pytest.mark.cuda
def test_dryrun_multichip_on_card(cuda, capsys):
    """The seven legs on 2 x 4 shards of the card: seven OK lines, K7
    launched by each fused leg's mesh plan, none on the eager legs; then
    each fused leg from a perturbed state, bit for bit one device
    (entry.one_device_twins: fb, tb2 and split end to end against K1 /
    K1s, the projection phases at the leg's mesh plan against K3a /
    K3b)."""
    from beom_tpu_torch import entry
    from beom_tpu_torch.parallel.mesh import make_mesh

    records = entry.dryrun_multichip(8)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 7 and all(x.endswith(" OK") for x in lines)
    assert sum(r["plan"] is not None for r in records) == 5
    for rec in records:
        plan, n_inner = rec["plan"], rec["leg"].n_inner
        want = {} if plan is None else {
            k: v * n_inner for k, v in plan.launches().items() if v}
        assert rec["launches"] == want, rec["leg"].label
    mesh = make_mesh(2, 4, devices=[cuda])
    for i, leg in enumerate(entry.LEGS):
        if dict(leg.kw).get("backend") != "fused":
            continue
        rec = entry.run_leg(leg, mesh, cuda, seed=140 + i)
        for what, got, ref in entry.one_device_twins(rec, seed=150 + i):
            for j, (a, b) in enumerate(zip(got, ref)):
                assert torch.equal(a, b), f"{what}: field {j}"


def _many_layers(device, seed, nz, n_tides, dtype, **kw):
    """The perturbed shelf (wet/dry, the open boundary, sponge, wind, drag)
    with its bottom layer split up to nz layers and n_tides of TPXO's
    constituents at the open boundary, at a time where the tides are on."""
    from beom_tpu_torch.cases import shelf_forced

    cfg, grid, forcing, st = _perturbed(device, seed, "shelf_forced",
                                        dtype=dtype, **kw)
    cfg, forcing, st = _layered(cfg, forcing, st, nz)
    om, amp, ph = shelf_forced.constituents(n_tides, cfg.ny, cfg.nx, seed,
                                            dtype=cfg.npdtype)
    cfg = dataclasses.replace(cfg, tides=om)
    forcing = dataclasses.replace(
        forcing, tide_amp=torch.tensor(amp, device=device),
        tide_phase=torch.tensor(ph, device=device))
    return cfg, grid, forcing, st.replace(t=cfg.npdtype.type(7 * cfg.dt))


# the cases off shared memory: past the shared-memory wall of each type
# (f64 with wet/dry from 13 layers, f32 from 25), and nz 8 f32, where the
# other route builds too and the plan's parameter forces the route
OFF_SMEM_CASES = [("float64", 16, False), ("float32", 32, False),
               ("float32", 8, True)]


def _bits(label, out, ref):
    for f, a, b in zip("huv", out, ref):
        assert torch.equal(a, b), (label, f, float((a - b).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nz", [(dtype, nz)
                                      for dtype in ("float32", "float64")
                                      for nz in (1, 9, 32)])
def test_layer_stream_matches_plain(cuda, dtype, nz):
    """K1's and K3b's layer-streamed kernels (the plans' parameter forces
    them where the shared-memory route fits too), 13 constituents on the
    shelf with the biharmonic and the interfacial drag on, 96 x 64 (not a
    multiple of the 32 x 16 tile): one step and one phase B at each sweep
    parity bit for bit their plain versions, each launch counted."""
    from beom_tpu_torch.cases import shelf_forced

    for scheme in ("fb", "implicit_fs"):
        cfg, grid, forcing, st = _perturbed(
            cuda, 89, "shelf_forced", dtype=dtype, nx=96, ny=64,
            scheme=scheme, precond="jacobi", nu4=1e9, r_int=1e-4)
        if nz != cfg.nz:
            cfg, forcing, st = _layered(cfg, forcing, st, nz) if nz > 1 \
                else (dataclasses.replace(cfg, nz=1, rho=cfg.rho[:1]),
                      dataclasses.replace(forcing, h_ext=forcing.h_ext.sum(
                          0, keepdim=True)),
                      st.replace(h=st.h.sum(0, keepdim=True), u=st.u[:1],
                                 v=st.v[:1]))
        om, amp, ph = shelf_forced.constituents(13, cfg.ny, cfg.nx, 89,
                                                dtype=cfg.npdtype)
        cfg = dataclasses.replace(cfg, tides=om)
        forcing = dataclasses.replace(
            forcing, tide_amp=torch.tensor(amp, device=cuda),
            tide_phase=torch.tensor(ph, device=cuda))
        st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
        statics = (grid, forcing)
        for n in (0, 1):
            if scheme == "fb":
                pl = fused_fb.plan(cfg, cfg.tdtype, 1, True)
                assert pl.stream, pl.describe()
                args = (st.h, st.u, st.v, statics, n, st.t, cfg, 1)
                before = dict(fused_fb.STREAM_LAUNCHES)
                out = fused_fb.fused_fb_step(*args, pl=pl)
                torch.cuda.synchronize()
                assert fused_fb.STREAM_LAUNCHES == {
                    k: v + k.startswith("fb_") for k, v in before.items()}
                _bits(f"K1 nz={nz} n={n}", out,
                      fused_fb.fused_fb_step_plain(*args))
                continue
            ph = fused_projection.Phases(
                grid, forcing, cfg,
                phase_plan=fused_projection.plan(cfg, cfg.tdtype, True))
            assert ph.plan.stream_b, ph.plan.describe()
            p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=cuda) \
                * grid.mask
            us, vs, _ = fused_projection.proj_a_plain(st.h, st.u, st.v,
                                                      statics, n, cfg)
            before = fused_projection.STREAM_LAUNCHES["proj_b"]
            out = ph.b(st.h, us, vs, p, st.t)
            torch.cuda.synchronize()
            assert fused_projection.STREAM_LAUNCHES["proj_b"] == before + 1
            _bits(f"K3b nz={nz} n={n}", out, fused_projection.proj_b_plain(
                st.h, us, vs, p, statics, st.t, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nz,forced", OFF_SMEM_CASES)
@pytest.mark.parametrize("scheme", ["split"])
def test_spill_route_matches_plain(cuda, scheme, dtype, nz, forced):
    """K1s off shared memory: its slow phase and recomposition stream the
    layers on one device (as on the shards: the spill route is gone), 13
    constituents, 96 x 64: one step at each sweep parity bit
    for bit the plain version, each streamed launch counted, and bit for
    bit the shared-memory route where a tile fits (nz 8: the same plan
    with `stream` off).  K1 off shared memory:
    test_layer_stream_matches_plain."""
    cfg, grid, forcing, st = _many_layers(cuda, 71, nz, 13, dtype, nx=96,
                                          ny=64, scheme=scheme, nsub=4)
    statics = (grid, forcing)
    both = not fused_fb.single_tile(cfg, cfg.tdtype)[1]
    pl = fused_fb.split_plan(cfg, cfg.tdtype, forced)
    assert pl.stream and pl.route == 3, pl.describe()
    for n in (0, 1):
        args = (st.h, st.u, st.v, statics, n, st.t, cfg, 1)
        before = dict(fused_fb.STREAM_LAUNCHES)
        out = fused_fb.fused_fb_step(*args, pl=pl)
        torch.cuda.synchronize()
        moved = {k: fused_fb.STREAM_LAUNCHES[k] - before[k] for k in before}
        assert moved == {"fb_continuity": 0, "fb_momentum": 0,
                         "split_slow": 1, "split_tend": 0,
                         "split_recompose": 1}, moved
        _bits(f"n={n} vs plain", out, fused_fb.fused_fb_step_plain(*args))
        if both:
            _bits(f"n={n} vs the shared-memory route", out,
                  fused_fb.fused_fb_step(*args, pl=dataclasses.replace(
                      pl, stream=False)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nz", [(dtype, nz)
                                      for dtype in ("float32", "float64")
                                      for nz in (1, 9, 32)])
def test_split_stream_kernels_match_plain(cuda, dtype, nz):
    """The layer-streamed split kernels, forced by the plan's parameter
    where the shared-memory route fits too, on the shelf with the
    biharmonic and the interfacial drag on, 13 constituents, 96 x 64:
    the slow phase bit for bit split.slow_phase, its tendencies (route 2's
    split_tend in the streamed build) split.slow_tendencies, and the
    recomposition's two launches split.recompose with fb.finalize, each
    from the plain phases' inputs."""
    from beom_tpu_torch.core.state import State
    from beom_tpu_torch.stepping import fb, split

    cfg, grid, forcing, st = _many_layers(cuda, 97, max(nz, 2), 13, dtype,
                                          nx=96, ny=64, scheme="split",
                                          nsub=4, nu4=1e9, r_int=1e-4)
    if nz == 1:
        cfg = dataclasses.replace(cfg, nz=1, rho=cfg.rho[:1])
        forcing = dataclasses.replace(
            forcing, h_ext=forcing.h_ext.sum(0, keepdim=True))
        st = st.replace(h=st.h.sum(0, keepdim=True), u=st.u[:1],
                        v=st.v[:1])
    statics = (grid, forcing)
    pl = fused_fb.split_plan(cfg, cfg.tdtype, True)
    assert pl.stream, pl.describe()
    s0 = State(h=st.h, u=st.u, v=st.v, t=st.t, n=0)
    sp = split.slow_phase(s0, grid, forcing, cfg)
    sub = split.subcycle_phase(sp, grid, cfg)
    got = fused_fb.split_slow(st.h, st.u, st.v, statics, cfg, pl)
    tend = fused_fb.split_tend(st.h, st.u, st.v, statics, cfg, pl)
    rec = fused_fb.split_recompose(sp, sub, st.h, st.u, st.v, statics, st.t,
                                   cfg, pl)
    torch.cuda.synchronize()
    for f, a, b in zip(sp._fields, got, sp):
        assert torch.equal(a, b), (f, float((a - b).abs().max()))
    for f, a, b in zip(("du_s", "dv_s"), tend,
                       split.slow_tendencies(s0, grid, forcing, cfg)):
        assert torch.equal(a, b), (f, float((a - b).abs().max()))
    ref = fb.finalize(*split.recompose(sp, *sub, st.h, grid, cfg), s0, grid,
                      forcing, cfg)
    _bits("recompose", rec, (ref.h, ref.u, ref.v))


# the layer counts the streamed projection phases are held at: one layer,
# 8 (where the single-step kernels fit shared memory too), 9, 32
STREAM_PHASE_CASES = [(dtype, nz) for dtype in ("float32", "float64")
                      for nz in (1, 8, 9, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nz", STREAM_PHASE_CASES)
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
def test_spill_route_phases_match_plain(cuda, scheme, dtype, nz):
    """Both phases off shared memory, layer-streamed (no route keeps the
    planes in device memory): K3a's streamed kernel and K3b's, forced by
    the plan's parameter where the other routes fit too, on the shelf with the
    biharmonic and the interfacial drag on, 13 constituents, 96 x 64, both
    parities: u*, v* and h1, u1, v1 bit for bit their plain versions, div
    within 4 ulp (f32) / 1e-12 (f64) of its scale (past two layers the
    plain version's torch.sum adds in an order of its own), each streamed
    launch counted; at nz 8 every field bit for bit the single-step
    kernels in shared memory."""
    cfg, grid, forcing, st = _many_layers(cuda, 73, max(nz, 2), 13, dtype,
                                          nx=96, ny=64, scheme=scheme,
                                          precond="jacobi", nu4=1e9,
                                          r_int=1e-4)
    if nz == 1:
        cfg = dataclasses.replace(cfg, nz=1, rho=cfg.rho[:1])
        forcing = dataclasses.replace(
            forcing, h_ext=forcing.h_ext.sum(0, keepdim=True))
        st = st.replace(h=st.h.sum(0, keepdim=True), u=st.u[:1],
                        v=st.v[:1])
    statics = (grid, forcing)
    rel = 1e-12 if dtype == "float64" else 4 * 2.0 ** -23
    ph = fused_projection.Phases(
        grid, forcing, cfg,
        phase_plan=fused_projection.plan(cfg, cfg.tdtype, True))
    assert ph.plan.stream_a and ph.plan.stream_b, ph.plan.describe()
    assert ph.kernel_keys() == ("proj_a_layers_kernel",
                                "proj_b_layers_kernel")
    p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=cuda) \
        * grid.mask
    for n in (0, 1):
        before = dict(fused_projection.STREAM_LAUNCHES)
        a = ph.a(st.h, st.u, st.v, n)
        a_ref = fused_projection.proj_a_plain(st.h, st.u, st.v, statics, n,
                                              cfg)
        b = ph.b(st.h, a_ref[0], a_ref[1], p, st.t)
        b_ref = fused_projection.proj_b_plain(st.h, a_ref[0], a_ref[1], p,
                                              statics, st.t, cfg)
        torch.cuda.synchronize()
        assert fused_projection.STREAM_LAUNCHES == {
            k: v + 1 for k, v in before.items()}
        _bits(f"A n={n}", a[:2], a_ref[:2])
        err = float((a[2] - a_ref[2]).abs().max())
        assert err <= rel * max(float(a_ref[2].abs().max()), 1e-30), \
            (n, err)
        _bits(f"B n={n}", b, b_ref)
        if nz == 8:
            assert not fused_projection.single_tile(cfg, cfg.tdtype)[1]
            other = fused_projection.Phases(
                grid, forcing, cfg,
                phase_plan=fused_projection.PhasePlan(None, None, False))
            _bits("A vs the shared-memory route", a,
                  other.a(st.h, st.u, st.v, n))
            _bits("B vs the shared-memory route", b,
                  other.b(st.h, a_ref[0], a_ref[1], p, st.t))


def _two_cards(m):
    """The 2 x 2 mesh m of shards of the one card as two cards' stacks
    split along x (the second on a side stream)."""
    from beom_tpu_torch.parallel.mesh import card_groups

    return [dataclasses.replace(c, device=m.devices[0])
            for c in card_groups(["a", "b"] * 2, 2, 2)]


# the streamed launches of one fb or split step per card
STEP_STREAMS = {"fb": {"fb_continuity": 1, "fb_momentum": 1},
                "split": {"split_slow": 1, "split_recompose": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nz", STREAM_PHASE_CASES)
@pytest.mark.parametrize("scheme", ["fb", "split", "implicit_fs"])
def test_spill_route_on_a_mesh(cuda, scheme, dtype, nz):
    """K7's bodies layer-streamed (forced by the plans' parameter where
    the shared-memory route fits too; the spill route is gone), one launch
    per kernel for every shard of (2, 2), on the shelf with 13
    constituents, 96 x 64: K7-fb's two launches and K7-split's slow phase
    and recomposition bit for bit K1 / K1s layer-streamed, on one stack and
    as two cards' stacks (the BEOM_CARDS build, the neighbour card's h1
    read back), each launch counted by dist_band.STREAM_LAUNCHES; K7-proj's
    phases A and B layer-streamed against the streamed K3a and K3b."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band

    cfg, grid, forcing, st = _many_layers(cuda, 79, max(nz, 2), 13, dtype,
                                          nx=96, ny=64, scheme=scheme,
                                          nsub=4, precond="jacobi")
    if nz == 1:
        cfg = dataclasses.replace(cfg, nz=1, rho=cfg.rho[:1])
        forcing = dataclasses.replace(
            forcing, h_ext=forcing.h_ext.sum(0, keepdim=True))
        st = st.replace(h=st.h.sum(0, keepdim=True), u=st.u[:1],
                        v=st.v[:1])
    statics = (grid, forcing)
    m = pmesh.make_mesh(2, 2, devices=[cuda])
    pl = dist_band.mesh_plan(cfg, cfg.tdtype, m, True)
    assert pl.streamed and "spill" not in pl.describe(), pl.describe()
    K = dist_band.MeshKernels(statics, cfg, m, pl=pl)
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    counts = dist_band.STREAM_LAUNCHES
    before = dict(counts)
    if scheme == "implicit_fs":
        p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=cuda) \
            * grid.mask
        a = dist_band.shard_proj_a(*sh, pstat, 0, cfg, kernels=K)
        b = dist_band.shard_proj_b(sh[0], a[0], a[1], pmesh.shard(p, m),
                                   pstat, st.t, cfg, kernels=K)
        ph = fused_projection.Phases(grid, forcing, cfg,
                                     phase_plan=K.plan.phases)
        assert ph.plan.stream_a and ph.plan.stream_b
        one_a = ph.a(st.h, st.u, st.v, 0)
        one_b = ph.b(st.h, one_a[0], one_a[1], p, st.t)
        torch.cuda.synchronize()
        _bits("phase A", [pmesh.gather(x) for x in a], one_a)
        _bits("phase B", [pmesh.gather(x) for x in b], one_b)
        assert {k: counts[k] - before[k] for k in ("proj_a", "proj_b")} \
            == {"proj_a": 1, "proj_b": 1}
        return
    out = dist_band.shard_step(*sh, pstat, 1, st.t, cfg, 1, kernels=K)
    torch.cuda.synchronize()
    moved = {k: counts[k] - before[k] for k in counts
             if counts[k] != before[k]}
    assert moved == STEP_STREAMS[scheme], moved
    one = K.plan.split if scheme == "split" else fused_fb.plan(
        cfg, cfg.tdtype, 1, True)
    assert one.stream, one.describe()
    ref = fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 1, st.t, cfg, 1,
                                 pl=one)
    torch.cuda.synchronize()
    _bits(f"K7-{scheme} vs K1", [pmesh.gather(a) for a in out], ref)
    # as two cards' stacks
    K2 = dist_band.MeshKernels(statics, cfg, m, cards=_two_cards(m), pl=pl)
    before = dict(counts)
    out2 = dist_band.shard_step(*sh, pstat, 1, st.t, cfg, 1, kernels=K2)
    torch.cuda.synchronize()
    moved = {k: counts[k] - before[k] for k in counts
             if counts[k] != before[k]}
    assert moved == {k: 2 * v for k, v in STEP_STREAMS[scheme].items()}, moved
    _bits(f"K7-{scheme} over two cards vs K1",
          [pmesh.gather(a) for a in out2], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("slow_card", [0, 1])
@pytest.mark.parametrize("scheme", ["fb", "split"])
def test_second_launch_waits_for_the_neighbour_card(cuda, scheme,
                                                     slow_card):
    """Over two cards' stacks (the second on a side stream), the launch
    that reads h1 back (K7-fb's momentum, K7-split's recomposition
    velocities) on each card starts only after the neighbour card's launch
    that writes it (the continuity, rch) has ended.  On the slow card's
    stream, just before its writing launch, its part of h1 is filled with
    NaN and the stream is held back by a sleep of ~25 ms: a reading launch
    on the other card that started before that writer ended would read NaN
    at its halo from the slow card's shards, so the step comes out bit for
    bit the one stack's only if the order holds (the shelf at nz 9 f32, 13
    constituents, 96 x 64, 2 x 2 shards split along x).  CUDA events
    recorded after each writing launch and before each reading launch on
    the launch's own stream put every reader after both writers."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band

    cfg, grid, forcing, st = _many_layers(cuda, 81, 9, 13, "float32", nx=96,
                                          ny=64, scheme=scheme, nsub=4)
    statics = (grid, forcing)
    m = pmesh.make_mesh(2, 2, devices=[cuda])
    pl = dist_band.mesh_plan(cfg, cfg.tdtype, m, True)
    K1 = dist_band.MeshKernels(statics, cfg, m, pl=pl)
    K2 = dist_band.MeshKernels(statics, cfg, m, cards=_two_cards(m), pl=pl)
    f = [dist_band.stack_global(a, m) for a in (st.h, st.u, st.v)]
    ref = K1.step(*f, 1, st.t, 1)
    two = [K2.stack(K1.unstack(a, m)) for a in f]
    writer, reader = ("fb_cont", "fb_mom") if scheme == "fb" else \
        ("split_rec_h", "split_rec_uv")
    # h1, the writer's output: the first of the step's fields K2 allocates
    # (MeshKernels.fb, .recompose)
    made = []
    like = K2._like
    K2._like = lambda n, parts: made.append(like(n, parts)) or made[-1]
    streams = {s.cuda_stream: s for s in K2.order.streams()}
    lib, fns = K2.fns(1)
    saved = dict(fns)
    ends, starts = [], []

    def wrap(key, writes):
        fn = saved[key]

        def launch(*args):
            card = len(ends) if writes else len(starts)
            stream = streams[args[-1]]
            ev = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                if writes and card == slow_card:
                    made[-1][0][card].fill_(float("nan"))
                    torch.cuda._sleep(50_000_000)
                if not writes:
                    ev.record(stream)
                    starts.append(ev)
                code = fn(*args)
                if writes:
                    ev.record(stream)
                    ends.append(ev)
            return code
        return launch

    fns[writer] = wrap(writer, True)
    fns[reader] = wrap(reader, False)
    try:
        out = K2.step(*two, 1, st.t, 1)
        torch.cuda.synchronize()
    finally:
        fns.update(saved)
    assert len(ends) == len(starts) == 2
    _bits(f"K7-{scheme} two cards vs one stack",
          [pmesh.gather(K2.unstack(a, m)) for a in out],
          [pmesh.gather(K1.unstack(a, m)) for a in ref])
    late = [[e.elapsed_time(s_) for e in ends] for s_ in starts]
    assert all(x >= 0.0 for row in late for x in row), late


# the mesh's solve on the card (stencils/mesh_solve.py): the Config
# overrides of each route on the rigid-lid case
MESH_SOLVES = {"jacobi": dict(scheme="implicit_fs"),
               "mg": dict(),
               "redblack": dict(solver="redblack", solver_maxiter=40)}


def _mesh_solve_inputs(device, route, mesh_shape, dtype, seed, n=128):
    """(cfg, grid, forcing, state, mesh, local and 1-halo statics, lam,
    b, x0) of one mesh solve of `route` on n^2 shards of the card, b and
    x0 seeded."""
    from beom_tpu_torch.parallel import dist
    from beom_tpu_torch.parallel import mesh as pmesh

    cfg, grid, forcing, st = make_case("rigid_lid", nx=n, ny=n,
                                       device=device, dtype=dtype,
                                       backend="fused", **MESH_SOLVES[route])
    m = pmesh.make_mesh(*mesh_shape, devices=[device])
    pgrid, _ = dist.pad_statics(grid, forcing, cfg, m, 1)
    grid_l = dist._crop_tree(pgrid, 1)
    rng = np.random.default_rng(seed)

    def field(amp):
        a = amp * rng.standard_normal((n, n)).astype(cfg.npdtype)
        return torch.tensor(a, device=device) * grid.mask

    return (cfg, grid, forcing, st, m, grid_l, pgrid, dist.pressure_lam(cfg),
            field(1.0), field(0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("route", list(MESH_SOLVES))
def test_mesh_solve_matches_eager_mesh_solve(cuda, route, mesh_shape,
                                             dtype):
    """The mesh's solve on the gathered grid of 128^2 shards of the card,
    warm-started: K6-Jacobi (implicit FS), K6-mg on the mesh's hierarchy
    (rigid lid) in one launch, K4a's sweeps (40, in passes of 8) for
    solver='redblack', with no mesh reduction or exchange; x against the
    eager mesh solve on the same shards within 1e-6 x scale at f64 and
    1e-3 x scale at f32 (K6's bounds against its plain version), the
    red-black sweeps within 1e-12 / 1e-5 x scale."""
    from beom_tpu_torch.parallel import dist, halo
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import mesh_solve

    cfg, _, _, _, m, grid_l, pgrid, lam, b, x0 = _mesh_solve_inputs(
        cuda, route, mesh_shape, dtype, 91)
    solve = mesh_solve.make_mesh_solve(grid_l, pgrid, cfg, m, lam)
    assert solve.route == route
    bs, xs = pmesh.shard(b, m), pmesh.shard(x0, m)
    halo.reset_counts()
    before = (cg_fused.LAUNCHES, redblack.LAUNCHES)
    got = solve(bs, xs)
    torch.cuda.synchronize()
    launched = (cg_fused.LAUNCHES - before[0],
                redblack.LAUNCHES - before[1])
    want = (0, len(mesh_solve.rb_passes(cfg.solver_maxiter))) \
        if route == "redblack" else (1, 0)
    assert launched == want
    assert halo.COUNTS == {"reductions": 0, "moved": 0}
    assert got.mesh is m and got.blocks[0].device == b.device
    if route == "redblack":
        ref = dist._dist_redblack(bs, grid_l, pgrid, cfg, lam=lam, x0=xs)
        rel = 1e-12 if dtype == "float64" else 1e-5
    else:
        ref = dist._dist_solve(bs, grid_l, pgrid, cfg, lam=lam, x0=xs)
        rel = 1e-6 if dtype == "float64" else 1e-3
    ref = pmesh.gather(ref)
    scale = float(ref.abs().max())
    err = float((pmesh.gather(got) - ref).abs().max())
    assert scale > 0 and err <= rel * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["jacobi", "mg", "redblack"])
def test_mesh_solve_over_two_cards(cuda, route):
    """The mesh's solve over two cards' stacks of the 2 x 2 mesh (the
    second on a side stream of the one card): bit for bit the one stack's,
    the same launches, and x handed back as each card's stacked part."""
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band, mesh_solve

    cfg, _, _, _, m, grid_l, pgrid, lam, b, x0 = _mesh_solve_inputs(
        cuda, route, (2, 2), "float32", 92)
    bs, xs = pmesh.shard(b, m), pmesh.shard(x0, m)
    one = mesh_solve.make_mesh_solve(grid_l, pgrid, cfg, m, lam)(bs, xs)
    cards = _two_cards(m)
    solve = mesh_solve.make_mesh_solve(grid_l, pgrid, cfg, m, lam, cards)
    before = (cg_fused.LAUNCHES, redblack.LAUNCHES)
    two = solve(bs, xs)
    torch.cuda.synchronize()
    assert (cg_fused.LAUNCHES - before[0], redblack.LAUNCHES - before[1]) \
        == ((0, len(mesh_solve.rb_passes(cfg.solver_maxiter)))
            if route == "redblack" else (1, 0))
    assert torch.equal(pmesh.gather(two), pmesh.gather(one))
    for c in cards:
        assert dist_band.stack_part(two, c.shards) is two.stacked[c.shards]


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("route", list(MESH_SOLVES))
def test_fused_mesh_step_solves_on_the_card(cuda, route, mesh_shape):
    """One fused mesh step at 128^2 f64 (phase A, the mesh's solve, phase
    B): one K6 launch for the CG routes, K4a's passes for red-black, no
    mesh reduction but the rigid lid's two de-mean sums and no exchange;
    the plan names the route; the state within 1e-6 x scale of the eager
    mesh step's."""
    from beom_tpu_torch.parallel import dist, halo
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band, mesh_solve
    from beom_tpu_torch.stepping import prepare_state

    cfg, grid, forcing, st, m, *_ = _mesh_solve_inputs(
        cuda, route, mesh_shape, "float64", 93)
    st = prepare_state(_perturbed(cuda, 93, "rigid_lid", nx=cfg.nx,
                                  ny=cfg.ny, dtype="float64")[3], cfg)
    text = dist_band.mesh_plan(cfg, cfg.tdtype, m).describe()
    assert {"jacobi": "K6-Jacobi", "mg": "K6-mg",
            "redblack": "K4a's sweep mode"}[route] in text, text
    step = dist.make_dist_stepper(grid, forcing, cfg, m)
    sharded = pmesh.shard_state(st, m)
    halo.reset_counts()
    before = (cg_fused.LAUNCHES, redblack.LAUNCHES,
              dict(dist_band.LAUNCHES))
    out = pmesh.gather_state(step(sharded))
    torch.cuda.synchronize()
    assert (cg_fused.LAUNCHES - before[0], redblack.LAUNCHES - before[1]) \
        == ((0, len(mesh_solve.rb_passes(cfg.solver_maxiter)))
            if route == "redblack" else (1, 0))
    assert {k: dist_band.LAUNCHES[k] - before[2][k]
            for k in ("proj_a", "proj_b")} == {"proj_a": 1, "proj_b": 1}
    assert halo.COUNTS == {
        "reductions": 0 if cfg.scheme == "implicit_fs" else 2, "moved": 0}
    eager = pmesh.gather_state(dist.make_dist_stepper(
        grid, forcing, dataclasses.replace(cfg, backend="eager"), m)(
            sharded))
    for f in ("h", "u", "v", "phi"):
        a, r = getattr(out, f), getattr(eager, f)
        scale = float(r.abs().max())
        assert float((a - r).abs().max()) <= 1e-6 * max(scale, 1.0), f
