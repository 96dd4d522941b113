"""The staged phase kernels of the projection step (K3a and K3b), on the
CPU: the host emulation of their tile schedules
(fused_projection.proj_a_tiled / proj_b_tiled: each block cut with the
kernel's halo in a ring of NaN that stands for whatever lies past a CTA's
block, the staggered masks rebuilt from the block's centre mask, the plain
phase run on it as a grid of its own, the interiors joined) bit for bit
the plain phases on every case, which pins the halos; K3a's epilogue (the
solve's right-hand side and warm start) against projection.implicit_rhs,
rigid_rhs and warm_x0; the plan; and the fused projection stepper against
beom_tpu's XLA step at f64.  The kernels themselves meet the plain phases
bit for bit on the card (tests/test_torch_cuda.py::
test_staged_phases_match_plain, test_phase_a_rhs_matches_plain)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.stepping import get_step as j_get_step
from beom_tpu.stepping import prepare_state as j_prepare_state

from beom_tpu_torch.cases import make_case
from beom_tpu_torch.core.state import State
from beom_tpu_torch.stencils import cg_fused, fused_fb
from beom_tpu_torch.stencils import fused_projection as fp
from beom_tpu_torch.stepping import make_stepper, projection

from tests.torch_parity import assert_close, perturb, to_port

# every case the projection schemes run, with every term the phases take
CASE_KW = {
    "rigid_lid": {},
    "double_gyre": {},
    "two_layer": {},
    "coastal_wetdry": {},
    "shelf_forced": dict(nu4=1e6, r_int=1e-4, cd_bot=2.5e-3),
}
TILE = (12, 8)      # divides neither 37 nor 29


def _case(name, scheme, dtype="float64", nx=37, ny=29, seed=7):
    """The case plus a seeded perturbation of h, u and v, at t = 7 dt (the
    tide is on), and a wet pressure field."""
    cfg, grid, forcing, st = make_case(name, nx=nx, ny=ny, device="cpu",
                                       dtype=dtype, scheme=scheme,
                                       **CASE_KW[name])
    rng = np.random.default_rng(seed)

    def noise(amp, m, shape=(cfg.nz, ny, nx)):
        return torch.tensor((amp * rng.standard_normal(shape)).astype(
            cfg.npdtype)) * m

    st = st.replace(h=st.h + noise(0.5, grid.mask),
                    u=st.u + noise(0.05, grid.mask_u),
                    v=st.v + noise(0.05, grid.mask_v),
                    t=cfg.npdtype.type(7 * cfg.dt))
    return cfg, (grid, forcing), st, noise(0.1, grid.mask, (ny, nx))


def _equal(outs, refs, what=""):
    for i, (a, b) in enumerate(zip(outs, refs)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                      err_msg=f"{what} {i}")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("name", list(CASE_KW))
def test_tiled_phases_equal_plain(name, scheme, dtype):
    """Phases A and B on 12 x 8 tiles of a 37 x 29 grid with the staged
    kernels' halos (A: 4 points below a tile, 3 above; B: halo_b on y, 4
    on x), the masks rebuilt per block: bit for bit the plain phases, both
    sweep parities (nz 1 and 2, dry cells, open faces with the tide,
    sponge, nu4, interfacial and quadratic drag)."""
    cfg, statics, st, p = _case(name, scheme, dtype)
    assert fp.derived_masks(statics[0])
    for n in (0, 1):
        a = fp.proj_a_tiled(st.h, st.u, st.v, statics, n, cfg, tile=TILE)
        a_ref = fp.proj_a_plain(st.h, st.u, st.v, statics, n, cfg)
        _equal(a, a_ref, f"A n={n}")
        b = fp.proj_b_tiled(st.h, a_ref[0], a_ref[1], p, statics, st.t, cfg,
                            tile=TILE)
        _equal(b, fp.proj_b_plain(st.h, a_ref[0], a_ref[1], p, statics,
                                  st.t, cfg), f"B n={n}")


@pytest.mark.parametrize("name", list(CASE_KW))
def test_narrower_halos_differ(name):
    """What pins the halos.  Phase A reads 3 points above a tile only
    through the biharmonic's lap planes: with 2 the NaN reaches the shelf
    (nu4), not the others.  Below a tile the function reaches 3 points (a
    sweep reads the other one's field at one neighbour west or south), the
    kernel's schedule 4 (each stage on a region symmetric about the tile),
    so the emulation stays exact at (3, 3) too.  Phase B's halo 1 without
    wet/dry or the open boundary is pinned (0 lets the NaN in); under them
    the limiter's comparisons stop a NaN, so the card holds the kernel to
    the plain phase there."""
    cfg, statics, st, p = _case(name, "implicit_fs")
    nu4 = cfg.nu4 != 0.0
    for halo, nan in (((4, 3), False), ((3, 3), False), ((4, 2), nu4)):
        out = fp.proj_a_tiled(st.h, st.u, st.v, statics, 0, cfg, tile=TILE,
                              halo=halo)
        assert any(bool(torch.isnan(a).any()) for a in out) == nan, halo
    u_s, v_s, _ = fp.proj_a_plain(st.h, st.u, st.v, statics, 0, cfg)
    w = fp.halo_b(cfg)
    assert w == (1 if not (cfg.wetdry or cfg.obc) else
                 (3 if cfg.wetdry else 2))
    out = fp.proj_b_tiled(st.h, u_s, v_s, p, statics, st.t, cfg, tile=TILE,
                          halo=(w - 1, w - 1))
    assert any(bool(torch.isnan(a).any()) for a in out) == \
        (not (cfg.wetdry or cfg.obc))


@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("name", list(CASE_KW))
def test_epilogue_right_hand_side(name, scheme):
    """K3a's epilogue as csrc/projection_body.cuh (pas) writes it, in
    torch: eta = (h_0 [+ h_1] - H) mask, b = (-lam) (eta - dt div), x0 = 2
    phi - phi_prev; implicit_rhs and warm_x0 bit for bit (a layer sum of at
    most two terms is torch.sum's in any order: the plan takes the
    epilogue at nz <= 2).  The rigid lid's right-hand side from div and
    eta, with its de-mean in torch (Phases._demean), is rigid_rhs bit for
    bit; and Phases.a_rhs on the CPU is the eager composition."""
    cfg, (grid, forcing), st, p = _case(name, scheme)
    assert cfg.nz <= 2 and fp.plan(cfg, torch.float64).rhs
    lam = projection.solve_lam(cfg)
    _, _, div = fp.proj_a_plain(st.h, st.u, st.v, (grid, forcing), 0, cfg)
    hs = st.h[0]
    for k in range(1, cfg.nz):
        hs = hs + st.h[k]
    eta = (hs - grid.H) * grid.mask
    ph = fp.Phases(grid, forcing, cfg)
    phi_prev = 0.5 * p
    x0 = 2.0 * p - phi_prev
    warm = projection.warm_x0(State(h=st.h, u=st.u, v=st.v, t=st.t, n=0,
                                    phi=p, phi_prev=phi_prev), cfg)
    np.testing.assert_array_equal(x0.numpy(), warm.numpy())
    if scheme == "rigid_lid":
        ref = projection.rigid_rhs(st.h, div, grid, cfg)
        np.testing.assert_array_equal(ph._demean(div, eta).numpy(),
                                      ref.numpy())
    else:
        b_ref, eta_ref = projection.implicit_rhs(st.h, div, grid, cfg, lam)
        np.testing.assert_array_equal(eta.numpy(), eta_ref.numpy())
        np.testing.assert_array_equal(
            ((-lam) * (eta - cfg.dt * div)).numpy(), b_ref.numpy())
    for carries in ((p, phi_prev), (p, None), (None, None)):
        out = ph.a_rhs(st.h, st.u, st.v, 0, *carries)
        ref = fp._rhs_plain(st.h, div, grid, cfg, lam, *carries)
        _equal(out[2:3], ref[:1], "rhs")
        assert (out[3] is None) == (ref[1] is None)
        if ref[1] is not None:
            _equal(out[3:], ref[1:], "x0")


def _xla_cases(scheme, **kw):
    jcfg, jgrid, jforcing, jst = jax_make_case(
        "rigid_lid", nx=32, ny=32, dtype="float64", scheme=scheme,
        solver_tol=1e-13, solver_maxiter=5000, **kw)
    jst = j_prepare_state(perturb(jcfg, jgrid, jst, 3), jcfg)
    return (jcfg, jgrid, jforcing, jst), to_port(jcfg, jgrid, jforcing, jst)


@pytest.mark.parametrize("scheme,kw", [
    ("rigid_lid", dict(precond="jacobi")), ("rigid_lid", {}),
    ("implicit_fs", {}), ("implicit_fs", dict(warm_start=False))])
def test_fused_stepper_matches_xla(scheme, kw):
    """3 steps of make_stepper(backend='fused') on the CPU (the phase
    kernels' plain versions, the right-hand side as Phases.a_rhs builds
    it, the solve) against beom_tpu's XLA projection step at f64 with the
    tight solve: 1e-11 x each field's scale, the solver tolerance
    amplifying the ulp-level differences of the reductions (as the eager
    step's parity test)."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _xla_cases(
        scheme, **kw)
    jstep = jax.jit(lambda s: j_get_step(jcfg)(s, jgrid, jforcing, jcfg))
    step = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused"))
    for _ in range(3):
        jst, st = jstep(jst), step(st)
    assert st.n == int(jst.n) == 3
    for f in ("h", "u", "v") + (("phi", "phi_prev") if cfg.warm_start
                                 else ()):
        assert_close(getattr(st, f), getattr(jst, f), 1e-11, f)
    assert float(st.u.abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["rigid_lid", "two_layer",
                                  "coastal_wetdry", "shelf_forced"])
def test_plan_per_case(name, dtype):
    """Each case's plan at 2048^2: every staged CTA fits 232,448 bytes, the
    geometry is one of the candidates and is built into the library with
    the masks' rebuild, and K3a's epilogue takes the right-hand side."""
    cfg = make_case(name, nx=2048, ny=2048, device="cpu", dtype=dtype,
                    scheme="implicit_fs", **CASE_KW[name])[0]
    pl = fp.plan(cfg, cfg.tdtype)
    elem = 4 if dtype == "float32" else 8
    assert pl.a is not None and pl.b is not None and pl.rhs
    smem = fp.staged_smem(cfg, pl.a, pl.b, elem)
    assert max(smem.values()) <= fused_fb._MAX_SMEM
    assert pl.a.tx % 4 == 0 and pl.b.tx % 4 == 0
    assert pl.a in [c.a for c in fp.candidates(cfg, cfg.tdtype)]
    assert pl.b in [c.b for c in fp.candidates(cfg, cfg.tdtype)]
    name_, defines = fp.build_spec(cfg, cfg.tdtype, pl, True)
    defs = dict(d.split("=") for d in defines)
    assert name_ == "projection" and defs["BEOM_DMASK"] == "1"
    assert (int(defs["BEOM_ATX"]), int(defs["BEOM_ATY"]),
            int(defs["BEOM_ANT"])) == (pl.a.tx, pl.a.ty, pl.a.threads)
    assert (int(defs["BEOM_BTX"]), int(defs["BEOM_BTY"]),
            int(defs["BEOM_BNT"])) == (pl.b.tx, pl.b.ty, pl.b.threads)
    # the shard kernels keep the single-step kernels' defines
    staged = fp.staged_defines(pl, cfg, True)
    assert defines[-len(staged):] == staged
    assert fp.build_spec(cfg, cfg.tdtype)[1] == defines[:-len(staged)]
    assert "K3a staged" in pl.describe()


def test_plan_keeps_the_torch_rhs_past_two_layers():
    """A layer sum of three terms may be added in another order by
    torch.sum on the card: there the plan leaves the right-hand side to
    torch."""
    cfg = make_case("two_layer", nx=256, ny=256, device="cpu",
                    scheme="implicit_fs")[0]
    cfg = dataclasses.replace(cfg, nz=3, rho=tuple(cfg.rho) + (
        cfg.rho[-1] + 1.0,))
    assert not fp.plan(cfg, torch.float32).rhs


def test_derived_masks():
    """The staged kernels rebuild the staggered masks only for a grid whose
    masks are make_grid's products of the centre mask."""
    cfg, (grid, forcing), _, _ = _case("coastal_wetdry", "implicit_fs")
    assert fp.derived_masks(grid)
    mq = grid.mask_q.clone()
    mq[5, 5] = 1.0 - mq[5, 5]
    assert not fp.derived_masks(dataclasses.replace(grid, mask_q=mq))


@pytest.mark.parametrize("name", list(CASE_KW))
def test_every_case_rebuilds_its_masks(name):
    """On every case the staggered masks are the centre mask's products and
    f_q is f0 + beta y, as the reference's band rebuilds them in-kernel:
    the staged kernels read `mask` alone, and the byte bound of K3a / K3b
    (chip_smoke.phase_fields) counts neither the staggered masks nor f."""
    cfg, (grid, _), _, _ = _case(name, "implicit_fs")
    assert fp.derived_masks(grid)
    y = (torch.arange(cfg.ny, dtype=torch.float64) + 0.5) * cfg.dy
    f = (cfg.f0 + cfg.beta * y)[:, None].expand(cfg.ny, cfg.nx)
    torch.testing.assert_close(grid.f_q, f, rtol=1e-15, atol=0.0)


def test_phases_on_the_cpu_are_the_plain_phases():
    """Phases on CPU tensors: proj_a_plain and proj_b_plain, and proj_a /
    proj_b the same."""
    cfg, statics, st, p = _case("shelf_forced", "rigid_lid")
    ph = fp.Phases(*statics, cfg)
    a = ph.a(st.h, st.u, st.v, 1)
    _equal(a, fp.proj_a_plain(st.h, st.u, st.v, statics, 1, cfg))
    _equal(a, fp.proj_a(st.h, st.u, st.v, statics, 1, cfg))
    b = ph.b(st.h, a[0], a[1], p, st.t)
    _equal(b, fp.proj_b_plain(st.h, a[0], a[1], p, statics, st.t, cfg))
    _equal(b, fp.proj_b(st.h, a[0], a[1], p, statics, st.t, cfg))


def test_jacobi_tile_plan_is_kept():
    """The Jacobi kernel's tile plan, a host search over the tile widths,
    is made once per (ny, nx, CTAs, item size)."""
    cg_fused.tile_plan.cache_clear()
    first = cg_fused.tile_plan(512, 384, 132, 4)
    assert cg_fused.tile_plan(512, 384, 132, 4) == first
    assert cg_fused.tile_plan.cache_info().hits == 1
