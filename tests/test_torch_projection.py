"""The projection slice: the port's rigid-lid and implicit-free-surface
steps against beom_tpu's XLA steps and the f64 NumPy oracle; the fused
stepper (its plain versions on CPU tensors) against the eager one and
against beom_tpu's Pallas projection stepper in interpret mode; and a
projection run through run(), snapshots and convert.py.  The rigid lid
runs its default solve (CG + multigrid, beom_tpu's precond='auto' for
lam = 0), solver='mg', CG + Jacobi and red-black; the implicit free
surface's 'auto' is Jacobi in both packages.  The multigrid solves'
parity at the solver level is in tests/test_torch_multigrid.py."""

import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.oracle import oracle_for
from beom_tpu.stencils.fused_projection import make_pallas_projection_stepper
from beom_tpu.stepping import get_step as j_get_step
from beom_tpu.stepping import prepare_state as j_prepare_state

from beom_tpu_torch import convert
from beom_tpu_torch.run import run
from beom_tpu_torch.stencils import cg_fused, fused_projection, redblack
from beom_tpu_torch.stepping import (get_step, make_stepper, prepare_state,
                                     run_steps)

from tests.torch_parity import assert_close, perturb, to_port

CONFIGS = {
    "rigid_lid-cg": dict(precond="jacobi"),
    "rigid_lid-cg-mg": {},
    "rigid_lid-mg": dict(solver="mg"),
    "implicit_fs-cg": dict(scheme="implicit_fs"),
    "rigid_lid-redblack": dict(solver="redblack"),
    "implicit_fs-redblack": dict(scheme="implicit_fs", solver="redblack"),
}
TIGHT = dict(solver_tol=1e-13, solver_maxiter=5000)


def _cases(nx, ny, seed=0, **kw):
    """(JAX case, port case) of the perturbed rigid-lid gyre, with the
    warm-start carry attached to both states."""
    jcfg, jgrid, jforcing, jst = jax_make_case("rigid_lid", nx=nx, ny=ny,
                                               **kw)
    jst = j_prepare_state(perturb(jcfg, jgrid, jst, seed), jcfg)
    port = to_port(jcfg, jgrid, jforcing, jst)
    return (jcfg, jgrid, jforcing, jst), port


@pytest.mark.parametrize("name", list(CONFIGS))
def test_eager_steps_match_reference(name):
    """3 steps at f64, tolerance 1e-13: 1e-11 x each field's scale, the
    solver tolerance amplifying the ulp-level differences of the
    reductions."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _cases(
        32, 32, dtype="float64", **TIGHT, **CONFIGS[name])
    jstep = jax.jit(lambda s: j_get_step(jcfg)(s, jgrid, jforcing, jcfg))
    step = get_step(cfg)
    for _ in range(3):
        jst = jstep(jst)
        st = step(st, grid, forcing, cfg)
    assert st.n == int(jst.n) == 3 and st.t == np.asarray(jst.t)
    for f in ("h", "u", "v", "phi", "phi_prev"):
        assert_close(getattr(st, f), getattr(jst, f), 1e-11, f)


@pytest.mark.parametrize("name", ["rigid_lid-cg", "implicit_fs-cg"])
def test_eager_200_steps_vs_oracle(name):
    """tests/test_parity.py's projection envelopes: h 1e-5, u/v 1e-8."""
    jcfg, jgrid, jforcing, jst = jax_make_case(
        "rigid_lid", nx=32, ny=32, dtype="float64", **TIGHT,
        **CONFIGS[name])
    cfg, grid, forcing, st = to_port(jcfg, jgrid, jforcing, jst)
    out = run_steps(st, grid, forcing, cfg, 200)
    ho, uo, vo = oracle_for(jcfg, jgrid, jforcing).run(
        np.asarray(jst.h), np.asarray(jst.u), np.asarray(jst.v), 200)
    np.testing.assert_allclose(out.h.numpy(), ho, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.u.numpy(), uo, rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.v.numpy(), vo, rtol=0, atol=1e-8)
    assert np.abs(uo).max() > 1e-8        # the run did something


@pytest.mark.parametrize("name", ["rigid_lid-cg", "implicit_fs-cg",
                                  "rigid_lid-ssor"])
def test_fused_stepper_equals_eager_on_cpu(name):
    """On CPU tensors the fused stepper runs the plain versions of its
    kernels, which are the eager step's own operations: bit for bit."""
    kw = CONFIGS.get(name, dict(precond="ssor"))
    _, (cfg, grid, forcing, st) = _cases(40, 24, seed=2, dtype="float32",
                                         **kw)
    before = (dict(fused_projection.LAUNCHES), cg_fused.LAUNCHES)
    fused = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused"))
    eager = make_stepper(grid, forcing, cfg)
    a = b = st
    for _ in range(3):
        a, b = fused(a), eager(b)
    assert (a.n, a.t) == (b.n, b.t) == (3, b.t)
    for f in ("h", "u", "v", "phi", "phi_prev"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)
    assert (dict(fused_projection.LAUNCHES), cg_fused.LAUNCHES) == before


@pytest.mark.parametrize("name,atol_ulp", [
    ("rigid_lid-cg", 1e-5), ("implicit_fs-cg", 1e-5),
    ("rigid_lid-redblack", 1e-4), ("rigid_lid-cg-mg", 1e-5),
    ("rigid_lid-mg", 1e-5)])
def test_fused_stepper_matches_pallas_interpret(name, atol_ulp):
    """tests/unit/test_pallas.py's projection comparison (128x96, by=48,
    3 steps, atol_ulp x max(scale, 1), f32), with the port's fused
    stepper in place of the XLA one, from a perturbed state.  With the
    default solve both run the whole multigrid-preconditioned CG as one
    kernel (its plain version here); with solver='mg' the reference's
    interpret tier runs the eager-smoothed W-cycle solver and the port
    its fused tier (the fused gamma schedule, the coarse stack's plain
    version), so the two iterate differently and meet at the
    tolerance."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _cases(
        128, 96, seed=3, **CONFIGS[name])
    jstep = make_pallas_projection_stepper(jgrid, jforcing, jcfg, by=48,
                                           interpret=True)
    step = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused"))
    for _ in range(3):
        jst, st = jstep(jst), step(st)
    for f in "huv":
        ref = np.asarray(getattr(jst, f))
        scale = max(np.abs(ref).max(), 1e-30)
        np.testing.assert_allclose(getattr(st, f).numpy(), ref, rtol=0,
                                   atol=atol_ulp * max(scale, 1.0),
                                   err_msg=f)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_run_rigid_lid_defaults(backend):
    """make_case('rigid_lid') with its defaults (CG + multigrid) runs
    through run() on CPU tensors: finite, moving, and the column held to
    the f32 solve's tolerance."""
    from beom_tpu_torch.cases import make_case

    cfg, grid, forcing, st = make_case("rigid_lid", nx=64, ny=48,
                                       device="cpu", backend=backend,
                                       diag_every=5)
    assert (cfg.solver, cfg.precond, cfg.dtype) == ("cg", "auto", "float32")
    out = run(cfg, grid, forcing, st, 10, log=io.StringIO())
    assert out.n == 10 and bool(np.isfinite(out.h.numpy()).all())
    assert float(out.u.abs().max()) > 0
    column = float(((out.h.sum(0) - grid.H) * grid.mask).abs().max())
    assert column < 1e-3


def test_fused_redblack_counts_one_launch_per_pass():
    """The blocked solve's passes are counted on the host; on CPU tensors
    the sweeps run their plain version and launch nothing."""
    _, (cfg, grid, forcing, st) = _cases(32, 32, dtype="float64",
                                         **CONFIGS["rigid_lid-redblack"])
    passes, launches = redblack.PASSES, redblack.LAUNCHES
    make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused", solver_maxiter=64))(st)
    assert 0 < redblack.PASSES - passes <= 64 // 8
    assert redblack.LAUNCHES == launches


def test_run_resume_carries_phi(tmp_path):
    """A 20-step rigid-lid run() stopped at step 10 and resumed from its
    snapshot equals the straight run bit for bit: the snapshot carries
    phi and phi_prev, the warm start of the next solve."""
    from beom_tpu_torch.cases import make_case

    cfg, grid, forcing, st = make_case(
        "rigid_lid", nx=32, ny=32, dtype="float64", device="cpu",
        precond="jacobi", backend="fused", snap_every=10, diag_every=5)
    quiet = io.StringIO()
    full = run(cfg, grid, forcing, st, 20, log=quiet)
    rd = str(tmp_path)
    run(cfg, grid, forcing, st, 10, run_dir=rd, log=quiet)
    log = io.StringIO()
    out = run(cfg, grid, forcing, st, 10, run_dir=rd, log=log)
    assert "resumed from" in log.getvalue() and out.n == full.n == 20
    for f in ("h", "u", "v", "phi", "phi_prev"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      getattr(full, f).numpy(), err_msg=f)
    assert float(full.u.abs().max()) > 0


def test_convert_carries_phi():
    """A beom_tpu projection state with its carry converts to the port and
    back with phi and phi_prev intact, and steps on as beom_tpu's does."""
    (jcfg, jgrid, jforcing, jst), _ = _cases(
        32, 24, dtype="float64", **TIGHT, **CONFIGS["implicit_fs-cg"])
    jstep = jax.jit(lambda s: j_get_step(jcfg)(s, jgrid, jforcing, jcfg))
    jst = jstep(jstep(jst))
    cfg, grid, forcing, st = to_port(jcfg, jgrid, jforcing, jst)
    for f in ("phi", "phi_prev"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)))
    _, _, _, back = convert.to_numpy(cfg, grid, forcing, st)
    np.testing.assert_array_equal(back["phi_prev"], np.asarray(jst.phi_prev))
    st = prepare_state(st, cfg)                 # already attached: no-op
    jst = jstep(jst)
    st = get_step(cfg)(st, grid, forcing, cfg)
    for f in ("h", "u", "v", "phi", "phi_prev"):
        assert_close(getattr(st, f), getattr(jst, f), 1e-11, f)


# the cases whose terms the phase kernels took last: two layers, wet/dry,
# the open boundary with the sponge and the tide
OTHER_CASES = ["two_layer", "coastal_wetdry", "shelf_forced"]


def _other_case(case, scheme, seed=5, **kw):
    jcfg, jgrid, jforcing, jst = jax_make_case(
        case, nx=48, ny=32, dtype="float64", scheme=scheme, **TIGHT, **kw)
    jst = j_prepare_state(perturb(jcfg, jgrid, jst, seed), jcfg)
    return (jcfg, jgrid, jforcing, jst), to_port(jcfg, jgrid, jforcing, jst)


@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("case", OTHER_CASES)
def test_phase_plain_versions_match_reference_bodies(case, scheme):
    """proj_a_plain and proj_b_plain against the bodies the TPU kernel
    runs (beom_tpu's momentum_update with free_surface=False, the
    transport divergence; the correction, continuity_rhs and finalize),
    on every term: 1e-12 x each field's scale at f64, both parities."""
    import jax.numpy as jnp

    from beom_tpu.core import ops as jops
    from beom_tpu.core.state import State as JState
    from beom_tpu.physics import continuity as jcont
    from beom_tpu.stepping import fb as jfb
    from beom_tpu.stepping.projection import barotropic_transport

    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _other_case(
        case, scheme)
    statics = (grid, forcing)
    p_np = np.random.default_rng(6).standard_normal(
        (cfg.ny, cfg.nx)) * np.asarray(jgrid.mask)
    corr = cfg.dt if scheme == "rigid_lid" else cfg.g * cfg.dt
    t = cfg.npdtype.type(7 * cfg.dt)
    for n in (0, 1):
        js = jst.replace(n=jnp.asarray(n, jst.n.dtype),
                         t=jnp.asarray(t, jst.t.dtype))
        ju, jv = jfb.momentum_update(js.h, js, jgrid, jforcing, jcfg,
                                     free_surface=False)
        U, V = barotropic_transport(js.h, ju, jv, jgrid)
        jdiv = (jops.d_xm(U, jcfg.dx) + jops.d_ym(V, jcfg.dy)) * jgrid.mask
        us, vs, div = fused_projection.proj_a(st.h, st.u, st.v, statics, n,
                                              cfg)
        for f, a, b in (("us", us, ju), ("vs", vs, jv), ("div", div, jdiv)):
            assert_close(a, b, 1e-12, f"{f} n={n}")

        jp = jnp.asarray(p_np)
        dpx = jgrid.mask_u * jops.d_xp(jp, jcfg.dx)
        dpy = jgrid.mask_v * jops.d_yp(jp, jcfg.dy)
        u1 = (ju - corr * dpx[None]) * jgrid.mask_u
        v1 = (jv - corr * dpy[None]) * jgrid.mask_v
        h1 = (js.h + jcfg.dt * jcont.continuity_rhs(js.h, u1, v1, jgrid,
                                                    jcfg)) * jgrid.mask
        jout = jfb.finalize(h1, u1, v1, JState(h=js.h, u=ju, v=jv, t=js.t,
                                               n=js.n), jgrid, jforcing,
                            jcfg)
        out = fused_projection.proj_b(st.h, us, vs, torch.tensor(p_np),
                                      statics, t, cfg)
        for f, a in zip("huv", out):
            assert_close(a, getattr(jout, f), 1e-12, f"{f} n={n}")


@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
@pytest.mark.parametrize("case", OTHER_CASES)
def test_fused_steps_match_reference_on_every_case(case, scheme):
    """3 steps of the fused stepper (the kernels' plain versions on CPU
    tensors) on the cases the phase kernels used to refuse, against
    beom_tpu's projection step at f64 with the tight solve: 1e-9 x each
    field's scale (the solver tolerance through three steps), and bit for
    bit the port's eager stepper."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _other_case(
        case, scheme, precond="jacobi")
    jstep = jax.jit(lambda s: j_get_step(jcfg)(s, jgrid, jforcing, jcfg))
    fused = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused"))
    eager = make_stepper(grid, forcing, cfg)
    a = b = st
    for _ in range(3):
        jst, a, b = jstep(jst), fused(a), eager(b)
    assert a.n == int(jst.n) == 3
    for f in ("h", "u", "v", "phi"):
        assert_close(getattr(a, f), getattr(jst, f), 1e-9, f)
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)
    assert float(a.u.abs().max()) > 0


def test_phase_kernels_build_spec_per_case():
    """The phase kernels are built once per combination of compile-time
    switches, as the fused fb step is; the shared-memory count per kernel
    chooses the tile."""
    from beom_tpu_torch.cases import make_case

    cfg, *_ = make_case("shelf_forced", nx=48, ny=32, device="cpu",
                        scheme="implicit_fs", nu4=1e6, r_int=1e-4,
                        cd_bot=2.5e-3, dtype="float64")
    name, defines = fused_projection.build_spec(cfg)
    assert name == "projection"
    for d in ("BEOM_NZ=2", "BEOM_OBC=1", "BEOM_SPONGE=1", "BEOM_NTIDE=1",
              "BEOM_NU4=1", "BEOM_CDBOT=1", "BEOM_RINT=1", "BEOM_WETDRY=1"):
        assert d in defines, d
    tile = tuple(int(d.split("=")[1]) for d in defines[-2:])
    need = fused_projection.smem_bytes(cfg, tile, 8)
    assert max(need.values()) <= 232448
    gyre, *_ = make_case("rigid_lid", nx=48, ny=32, device="cpu")
    # the rigid-lid gyre keeps its halo of 1 in phase B
    assert fused_projection.smem_bytes(gyre, (32, 16), 4)["proj_b"] \
        == 34 * 18 * (8 * 4 + 4)
