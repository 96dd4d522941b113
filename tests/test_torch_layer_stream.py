"""The layer-streamed K1 and K3b: their schedules on the host and their
plans.

K1's single step and K3b's phase, where no tile's planes of every layer
fit a CTA's shared memory, stream the layers through a few planes of one
layer (csrc/fb_step_body.cuh: fbs, csrc/projection_body.cuh: pbl).
fused_fb.fb_step_streamed and fused_projection.proj_b_streamed run those
schedules on the host: K1's continuity one layer at a time on blocks with
the halo LO into out_h, then its momentum one layer at a time on blocks
with the halo 3, the column's h1 read back from out_h and summed from the
surface, Montgomery's running sums carried from layer to layer, and
Flather's increments, from its sums over the written layers, added
afterwards; K3b's correction, continuity and gates one layer at a time.  Every block
lies in a ring of NaN that stands for what lies past a CTA's block, so a
halo too narrow shows.  They are held bit for bit against the plain step
and phase at f64 on every case (and the shelf with the biharmonic and the
interfacial drag on) at 1, 3 and 9 layers, on tiles that divide neither
size; and the streamed path at nz 9 against beom_tpu's XLA step.  The
card's tests (test_torch_cuda.py) hold the kernels against the plain
versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.stepping import get_step as j_get_step
from beom_tpu.stepping import prepare_state as j_prepare_state
from beom_tpu_torch.cases import make_case, shelf_forced
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.stencils import fused_fb, fused_projection
from beom_tpu_torch.stepping import prepare_state, projection

from tests.torch_parity import assert_state_close, one_thread, perturb, \
    to_port

# (case, extra Config fields): the five cases and the shelf with every
# term the shelf leaves off
CASES = [("double_gyre", {}), ("two_layer", {}), ("rigid_lid", {}),
         ("coastal_wetdry", {}), ("shelf_forced", {}),
         ("shelf_forced", dict(nu4=1e9, r_int=1e-4))]
LAYERS = (1, 3, 9)
# 37 x 29 points in tiles of 16 x 8: neither size a multiple of the tile
NX, NY, TILE = 37, 29, (16, 8)


def _case(name, nz, seed, nx=NX, ny=NY, **kw):
    """The port's case at f64 on nx x ny, perturbed from a numpy generator
    of `seed`, its layers merged into one (nz 1) or its bottom layer split
    up to nz layers, the shelf with 13 of TPXO's constituents, at a time
    where the tides are on."""
    cfg, grid, forcing, st = make_case(name, nx=nx, ny=ny, device="cpu",
                                       dtype="float64", **kw)
    rng = np.random.default_rng(seed)

    def noise(amp, m):
        a = amp * rng.standard_normal((cfg.nz, cfg.ny, cfg.nx))
        return torch.tensor(a) * m

    st = st.replace(h=st.h + noise(0.5, grid.mask),
                    u=st.u + noise(0.05, grid.mask_u),
                    v=st.v + noise(0.05, grid.mask_v))
    if nz < cfg.nz:
        cfg = dataclasses.replace(cfg, nz=1, rho=cfg.rho[:1])
        forcing = dataclasses.replace(
            forcing, h_ext=forcing.h_ext.sum(0, keepdim=True))
        st = st.replace(h=st.h.sum(0, keepdim=True), u=st.u[:1], v=st.v[:1])
    elif nz > cfg.nz:
        parts, top = nz - cfg.nz + 1, cfg.nz - 1
        rho = tuple(cfg.rho[:top]) + tuple(cfg.rho[top] + i
                                           for i in range(parts))
        split = lambda a, share: torch.cat([a[:top]] + [a[top:] / share]
                                           * parts)
        cfg = dataclasses.replace(cfg, nz=nz, rho=rho)
        forcing = dataclasses.replace(forcing,
                                      h_ext=split(forcing.h_ext, parts))
        st = st.replace(h=split(st.h, parts), u=split(st.u, 1),
                        v=split(st.v, 1))
    if cfg.obc:
        om, amp, ph = shelf_forced.constituents(13, cfg.ny, cfg.nx, seed)
        cfg = dataclasses.replace(cfg, tides=om)
        forcing = dataclasses.replace(forcing, tide_amp=torch.tensor(amp),
                                      tide_phase=torch.tensor(ph))
    return cfg, grid, forcing, st.replace(t=7 * cfg.dt)


def _bits(label, got, ref):
    for f, a, b in zip("huv", got, ref):
        assert torch.equal(a, b), (label, f, float((a - b).abs().max()))


@pytest.mark.parametrize("nz", LAYERS)
@pytest.mark.parametrize("name,extra", CASES)
def test_streamed_fb_step_is_the_plain_step(name, extra, nz):
    """K1's layer-streamed schedule on the host, both sweep parities, bit
    for bit the plain fb step."""
    cfg, grid, forcing, st = _case(name, nz, 11, scheme="fb", **extra)
    statics = (grid, forcing)
    with one_thread():
        for n in (0, 1):
            got = fused_fb.fb_step_streamed(st.h, st.u, st.v, statics, n,
                                            st.t, cfg, tile=TILE)
            ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, statics, n,
                                               st.t, cfg, 1)
            _bits(f"n={n}", got, ref)
    assert float(ref[1].abs().max()) > 0


@pytest.mark.parametrize("nz", LAYERS)
@pytest.mark.parametrize("name,extra", CASES)
def test_streamed_phase_b_is_the_plain_phase(name, extra, nz):
    """K3b's layer-streamed schedule on the host bit for bit the plain
    phase B, under the implicit free surface (the rigid lid on its own
    case), from the plain phase A's u*, v* and a pressure from a numpy
    generator."""
    scheme = "rigid_lid" if name == "rigid_lid" else "implicit_fs"
    cfg, grid, forcing, st = _case(name, nz, 13, scheme=scheme, **extra)
    statics = (grid, forcing)
    p = torch.tensor(np.random.default_rng(13).standard_normal(
        (cfg.ny, cfg.nx))) * grid.mask
    with one_thread():
        for n in (0, 1):
            us, vs, _ = fused_projection.proj_a_plain(st.h, st.u, st.v,
                                                      statics, n, cfg)
            got = fused_projection.proj_b_streamed(st.h, us, vs, p, statics,
                                                   st.t, cfg, tile=TILE)
            ref = fused_projection.proj_b_plain(st.h, us, vs, p, statics,
                                                st.t, cfg)
            _bits(f"n={n}", got, ref)


@pytest.mark.parametrize("name", ["double_gyre", "shelf_forced"])
def test_streamed_halos_are_pinned(name):
    """The ring of NaN shows a block too narrow, so the bit-for-bit tests
    above hold at the kernels' halos (the continuity's LO, the momentum's
    3, K3b's halo_b), which cover the cone of dependence with room to
    spare: the host schedule is exact down to halos of 1 and 2 (K3b 1, or
    2 where finalize reads h1 east and north) and no narrower.  A block
    with no halo for the continuity, of 1 for the momentum, or one point
    under K3b's least, lets the NaN into the result."""
    cfg, grid, forcing, st = _case(name, 3, 17)
    statics = (grid, forcing)
    args = (st.h, st.u, st.v, statics, 0, st.t, cfg)
    nan = lambda outs: any(bool(torch.isnan(a).any()) for a in outs)
    with one_thread():
        ref = fused_fb.fused_fb_step_plain(*args, 1)
        _bits("halos (1, 2)", fused_fb.fb_step_streamed(
            *args, tile=TILE, halos=(1, 2)), ref)
        for halos in ((0, 3), (1, 1)):
            assert nan(fused_fb.fb_step_streamed(*args, tile=TILE,
                                                 halos=halos)), halos
        cfg = dataclasses.replace(cfg, scheme="implicit_fs")
        least = 2 if cfg.wetdry or cfg.obc else 1
        assert fused_projection.halo_b(cfg) >= least
        args = (st.h, st.u, st.v, st.h[0] * grid.mask, statics, st.t, cfg)
        ref = fused_projection.proj_b_plain(*args)
        _bits(f"halo {least}", fused_projection.proj_b_streamed(
            *args, tile=TILE, halo=least), ref)
        got = fused_projection.proj_b_streamed(*args, tile=TILE,
                                               halo=least - 1)
    assert nan(got)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stream_smem_does_not_grow_with_layers(dtype):
    """The streamed kernels' shared memory holds planes of one layer: the
    same at 1 and 64 layers, within one CTA's 232,448 bytes at the largest
    tile with every term on, and several CTAs per SM on the shelf at f32;
    the plans' describe() names the route."""
    cfg = make_case("shelf_forced", nx=64, ny=64, device="cpu", dtype=dtype,
                    nu4=1e9, r_int=1e-4)[0]
    elem = 4 if dtype == "float32" else 8
    per = {}
    for nz in (1, 64):
        c = dataclasses.replace(cfg, nz=nz, rho=tuple(1020.0 + k
                                                      for k in range(nz)))
        per[nz] = (fused_fb.stream_smem(c, (32, 16), elem),
                   fused_projection.stream_smem(
                       dataclasses.replace(c, scheme="implicit_fs"),
                       (32, 16), elem))
    assert per[1] == per[64]
    k1, k3b = per[64]
    assert max(max(k1.values()), k3b) <= fused_fb._MAX_SMEM
    # the momentum kernel: 15 planes of 38 x 22 points and the offsets
    assert k1["fb_momentum"] == 38 * 22 * (15 * elem + 4)
    # the continuity: 11 planes of 36 x 20; K3b: 12 of 38 x 22 (halo 3)
    assert k1["fb_continuity"] == 36 * 20 * (11 * elem + 4)
    assert k3b == 38 * 22 * (12 * elem + 4)
    c = dataclasses.replace(cfg, nz=64, rho=tuple(1020.0 + k
                                                  for k in range(64)))
    pl = fused_fb.plan(c, c.tdtype, 1)
    assert pl.stream and "layer-streamed" in pl.describe()
    assert pl.smem == k1["fb_momentum"]
    if dtype == "float32":
        assert 233472 // (pl.smem + 1024) >= 4


def test_streamed_path_matches_xla():
    """3 steps of the fb scheme through K1's streamed schedule, and 3
    implicit-FS steps whose phase B is K3b's streamed schedule (phase A
    and the solve as the fused stepper runs them on the CPU), against 3
    steps of beom_tpu's XLA path at f64 on the shelf at nz 9 with 9
    constituents, 48 x 32 on tiles of 16 x 8 (the case's own size is the
    tile's multiple; the kernel's wrap is held above): within the field-
    scale bounds of test_torch_layers.py's parity tests."""
    rel = {"fb": 1e-11, "implicit_fs": 1e-9}
    for scheme in ("fb", "implicit_fs"):
        kw = dict(solver_tol=1e-13, solver_maxiter=5000, precond="jacobi") \
            if scheme == "implicit_fs" else {}
        jcfg, jgrid, jforcing, jst = jax_make_case(
            "shelf_forced", nx=48, ny=32, dtype="float64", scheme=scheme,
            **kw)
        jst = perturb(jcfg, jgrid, jst, 5)
        parts, top = 9 - jcfg.nz + 1, jcfg.nz - 1
        rho = tuple(jcfg.rho[:top]) + tuple(jcfg.rho[top] + i
                                            for i in range(parts))
        split = lambda a, share: jnp.concatenate([a[:top]] + [a[top:] / share]
                                                 * parts)
        jcfg = dataclasses.replace(jcfg, nz=9, rho=rho)
        jforcing = dataclasses.replace(jforcing,
                                       h_ext=split(jforcing.h_ext, parts))
        jst = jst.replace(h=split(jst.h, parts), u=split(jst.u, 1),
                          v=split(jst.v, 1))
        om, amp, ph = shelf_forced.constituents(9, jcfg.ny, jcfg.nx, 5,
                                                dtype=jcfg.npdtype)
        jcfg = dataclasses.replace(jcfg, tides=om)
        jforcing = dataclasses.replace(jforcing, tide_amp=jnp.asarray(amp),
                                       tide_phase=jnp.asarray(ph))
        jst = j_prepare_state(jst.replace(t=jnp.asarray(7 * jcfg.dt)), jcfg)
        cfg, grid, forcing, st = to_port(jcfg, jgrid, jforcing, jst)
        jstep = jax.jit(lambda s: j_get_step(jcfg)(s, jgrid, jforcing, jcfg))
        for _ in range(3):
            jst = jstep(jst)
        statics = (grid, forcing)
        one = prepare_state(st, cfg)
        with one_thread():
            if scheme == "fb":
                for _ in range(3):
                    h, u, v = fused_fb.fb_step_streamed(
                        one.h, one.u, one.v, statics, one.n, one.t, cfg,
                        tile=TILE)
                    one = State(h=h, u=u, v=v, n=one.n + 1,
                                t=advance_time(one.t, cfg.dt, cfg.npdtype))
            else:
                ph = fused_projection.Phases(grid, forcing, cfg)
                solve = fused_projection.make_solve(
                    grid, cfg, projection.solve_lam(cfg))
                for _ in range(3):
                    us, vs, rhs, x0 = ph.a_rhs(one.h, one.u, one.v, one.n,
                                               one.phi, one.phi_prev)
                    p = solve(rhs, x0=x0)
                    h, u, v = fused_projection.proj_b_streamed(
                        one.h, us, vs, p, statics, one.t, cfg, tile=TILE)
                    out = State(h=h, u=u, v=v, n=one.n + 1,
                                t=advance_time(one.t, cfg.dt, cfg.npdtype))
                    one = projection.with_carry(out, one, p)
        assert_state_close(one, jst, rel[scheme], scheme)
        assert float(jnp.abs(jst.u).max()) > 0
