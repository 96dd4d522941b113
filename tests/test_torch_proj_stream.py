"""The layer-streamed K3a and K7's streamed projection phases: their
schedule on the host, their plans and their builds.

From _STREAM_FROM layers, and wherever no tile fits the single-step
kernels, both projection phases stream the layers through a few planes
of one layer (csrc/projection_body.cuh: pal, pbl), on one device and on
the shards of a mesh.  fused_projection.proj_a_streamed runs K3a's
schedule on the host: per layer from the surface Montgomery's running
sums without the surface term, that layer's tendencies and both sweeps
from its own h, u, v (the interfacial drag from the layers beside it),
and the column's transports added as they come; div after the last
layer.  Every block lies in a ring of NaN that stands for what lies past
a CTA's block, so a halo too narrow shows.  It is held bit for bit in
u*, v* against the plain phase A at f64 on every case (and the shelf
with the biharmonic and the interfacial drag on) at 1, 3 and 9 layers,
both sweep parities, on tiles that divide neither size, and div within
1e-12 of its scale (past two layers the plain version's torch.sum adds in
an order of its own); and the streamed phases at nz 9 against beom_tpu's
XLA step.  The card's tests (test_torch_cuda.py) hold the kernels against
the plain versions and K7's against the single-device kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.core import ops as j_ops
from beom_tpu.stepping import fb as j_fb
from beom_tpu.stepping import get_step as j_get_step
from beom_tpu.stepping import prepare_state as j_prepare_state
from beom_tpu.stepping import projection as j_projection
from beom_tpu_torch.cases import make_case, shelf_forced
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.parallel.mesh import make_mesh
from beom_tpu_torch.stencils import dist_band, fused_fb, fused_projection
from beom_tpu_torch.stepping import prepare_state, projection

from tests.test_torch_layer_stream import CASES, LAYERS, TILE, _bits, _case
from tests.torch_parity import assert_state_close, one_thread, perturb, \
    to_port

# the layer count from which the plan streams both phases (fused_projection.
# _STREAM_FROM, set by tools/kernel_times.py --layers projection on the H100)
STREAM_FROM = 4


def _scheme(name):
    return "rigid_lid" if name == "rigid_lid" else "implicit_fs"


def _near(label, got, ref, rel=1e-12):
    """got within rel of ref's scale."""
    err = float((got - ref).abs().max())
    assert err <= rel * max(float(ref.abs().max()), 1e-300), (label, err)


@pytest.mark.parametrize("nz", LAYERS)
@pytest.mark.parametrize("name,extra", CASES)
def test_streamed_phase_a_is_the_plain_phase(name, extra, nz):
    """K3a's layer-streamed schedule on the host, both sweep parities: u*,
    v* bit for bit the plain phase A, div within 1e-12 of its scale (bit
    for bit at one layer)."""
    cfg, grid, forcing, st = _case(name, nz, 41, scheme=_scheme(name),
                                   **extra)
    statics = (grid, forcing)
    with one_thread():
        for n in (0, 1):
            got = fused_projection.proj_a_streamed(st.h, st.u, st.v,
                                                   statics, n, cfg,
                                                   tile=TILE)
            ref = fused_projection.proj_a_plain(st.h, st.u, st.v, statics,
                                                n, cfg)
            _bits(f"n={n}", got[:2], ref[:2])
            _near(f"div n={n}", got[2], ref[2])
            if nz == 1:
                assert torch.equal(got[2], ref[2]), n
    assert float(ref[0].abs().max()) > 0


@pytest.mark.parametrize("nu4", [0.0, 1e9])
@pytest.mark.parametrize("name", ["double_gyre", "shelf_forced"])
def test_streamed_phase_a_halo_is_pinned(name, nu4):
    """The ring of NaN shows a block too narrow, so the bit-for-bit test
    above holds at the kernel's halo of 4 (its stages on [1, R-1), [2, R-2),
    [3, R-3), and div reading u*, v* one cell west and south), which covers
    the cone of dependence with room to spare: the host schedule is exact
    down to a halo of 2, 3 with the biharmonic on, at both parities, and a
    block one point narrower lets the NaN into the result."""
    cfg, grid, forcing, st = _case(name, 3, 43, scheme="implicit_fs",
                                   nu4=nu4, r_int=1e-4)
    least = 3 if nu4 else 2
    nan = lambda outs: any(bool(torch.isnan(a).any()) for a in outs)
    with one_thread():
        for n in (0, 1):
            args = (st.h, st.u, st.v, (grid, forcing), n, cfg)
            ref = fused_projection.proj_a_plain(*args)
            for halo in (4, least):
                got = fused_projection.proj_a_streamed(*args, tile=TILE,
                                                       halo=halo)
                _bits(f"n={n} halo {halo}", got[:2], ref[:2])
                _near(f"div n={n} at halo {halo}", got[2], ref[2])
            assert nan(fused_projection.proj_a_streamed(
                *args, tile=TILE, halo=least - 1)), n


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streamed_phase_a_smem_does_not_grow_with_layers(dtype):
    """K3a's streamed kernel holds planes of one layer: the same shared
    memory at 1 and 64 layers, 18 planes of 40 x 24 points and the offsets
    with the biharmonic on, within a CTA's 232,448 bytes, three CTAs per
    SM at f32; the build's check counts both phases' (stream_smems)."""
    cfg = make_case("shelf_forced", nx=64, ny=64, device="cpu", dtype=dtype,
                    scheme="implicit_fs", nu4=1e9, r_int=1e-4)[0]
    elem = 4 if dtype == "float32" else 8
    per = {}
    for nz in (1, 64):
        c = dataclasses.replace(cfg, nz=nz, rho=tuple(1020.0 + k
                                                      for k in range(nz)))
        per[nz] = fused_projection.stream_smems(c, (32, 16), elem)
    assert per[1] == per[64]
    a = per[64]["proj_a"]
    assert a == 40 * 24 * (18 * elem + 4) <= fused_fb._MAX_SMEM
    assert per[64]["proj_b"] == fused_projection.stream_smem(
        cfg, (32, 16), elem)
    no_nu4 = dataclasses.replace(cfg, nu4=0.0)
    assert fused_projection.stream_smem(no_nu4, (32, 16), elem,
                                        kernel="proj_a") \
        == 40 * 24 * (16 * elem + 4)
    # across cards the offsets take 8 bytes
    assert fused_projection.stream_smem(cfg, (32, 16), elem, 8, "proj_a") \
        == 40 * 24 * (18 * elem + 8)
    if dtype == "float32":
        assert fused_projection.ctas_per_sm(a, 256) == 3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["two_layer", "shelf_forced",
                                  "coastal_wetdry"])
def test_plan_streams_from_the_threshold(case, dtype):
    """The plan streams both phases from STREAM_FROM layers (pinned) and
    wherever no single-step tile fits, and only there: its build carries
    BEOM_STREAM=1 and never BEOM_SPILL, describe() names both streamed
    phases and the right-hand side stays in torch."""
    assert fused_projection._STREAM_FROM == STREAM_FROM
    base = make_case(case, nx=64, ny=64, device="cpu", dtype=dtype,
                     scheme="implicit_fs")[0]
    for nz in (1, 2, 3, 4, 7, 8, 9, 16, 32):
        cfg = dataclasses.replace(base, nz=nz, rho=tuple(
            1020.0 + 0.5 * k for k in range(nz)))
        pl = fused_projection.plan(cfg, cfg.tdtype)
        off = fused_projection.single_tile(cfg, cfg.tdtype)[1]
        want = nz >= STREAM_FROM or off
        assert pl.stream == want, (nz, pl.describe())
        assert pl.stream_a == pl.stream_b == want
        text = pl.describe()
        assert ("K3a layer-streamed" in text) == want, (nz, text)
        assert ("K3b layer-streamed" in text) == want, (nz, text)
        if want:
            assert pl == fused_projection.PhasePlan(None, None, False, True)
        _, defines = fused_projection.build_spec(cfg, cfg.tdtype, pl, True)
        assert ("BEOM_STREAM=1" in defines) == want, (nz, defines)
        assert "BEOM_SPILL=1" not in defines
    # the forced route at one layer, where every other route fits
    one = dataclasses.replace(base, nz=1, rho=base.rho[:1])
    forced = fused_projection.plan(one, one.tdtype, True)
    assert forced.stream_a and forced.stream_b
    assert not fused_projection.plan(one, one.tdtype).stream


@pytest.mark.parametrize("cards", [False, True])
def test_mesh_plan_streams_the_phases(cards):
    """On a 2 x 2 mesh the shard phases take the single-device plan's route:
    streamed at 32 layers (f32, the shelf) and forced at 2, where the
    staged kernels fit; MeshPlan names them (no spill route), and its builds
    carry BEOM_STREAM=1 with and without BEOM_CARDS, their shared memory
    the single-device streamed kernels' (8-byte offsets across cards)."""
    base = make_case("shelf_forced", nx=64, ny=64, device="cpu",
                     dtype="float32", scheme="implicit_fs")[0]
    base = dataclasses.replace(base, tides=shelf_forced.constituents(
        13, 1, 1, 0)[0])
    mesh = make_mesh(2, 2, devices=["cpu"])
    for nz, off in ((32, False), (2, True)):
        cfg = dataclasses.replace(base, nz=nz, rho=tuple(
            1020.0 + 0.5 * k for k in range(nz)))
        mp = dist_band.mesh_plan(cfg, cfg.tdtype, mesh, off)
        assert mp.streamed, mp.describe()
        text = mp.describe()
        assert "K3a layer-streamed" in text and "K3b layer-streamed" in text
        assert "spill" not in text
        assert mp.launches() == {"proj_a": 1, "proj_b": 1}
        name, d = dist_band.build_spec(cfg, cfg.tdtype, dmask=True,
                                       cards=cards, off_smem=off)
        assert name == "shard_projection"
        assert "BEOM_STREAM=1" in d and "BEOM_SPILL=1" not in d
        assert ("BEOM_CARDS=1" in d) == cards
        want = dist_band._want_smem(cfg, name, d, 4, 1)
        tile = (32, 16)
        assert want[:2] == [fused_projection.stream_smem(
            cfg, tile, 4, 8 if cards else 4, k) for k in ("proj_a",
                                                          "proj_b")]
    # below the threshold the plan keeps shared memory on the mesh too
    cfg = dataclasses.replace(base, nz=2, rho=base.rho[:2])
    mp = dist_band.mesh_plan(cfg, cfg.tdtype, mesh)
    assert not mp.streamed and "layer-streamed" not in mp.describe()


def _jax_shelf(nz, scheme, nx=48, ny=32, **kw):
    """beom_tpu's shelf at f64 on nx x ny, perturbed, its bottom layer
    split up to nz layers, with nz of TPXO's constituents at a time where
    the tides are on; and the port's twin."""
    jcfg, jgrid, jforcing, jst = jax_make_case(
        "shelf_forced", nx=nx, ny=ny, dtype="float64", scheme=scheme, **kw)
    jst = perturb(jcfg, jgrid, jst, 7)
    parts, top = nz - jcfg.nz + 1, jcfg.nz - 1
    rho = tuple(jcfg.rho[:top]) + tuple(jcfg.rho[top] + i
                                        for i in range(parts))
    split = lambda a, share: jnp.concatenate([a[:top]] + [a[top:] / share]
                                             * parts)
    jcfg = dataclasses.replace(jcfg, nz=nz, rho=rho)
    jforcing = dataclasses.replace(jforcing,
                                   h_ext=split(jforcing.h_ext, parts))
    jst = jst.replace(h=split(jst.h, parts), u=split(jst.u, 1),
                      v=split(jst.v, 1))
    om, amp, ph = shelf_forced.constituents(nz, jcfg.ny, jcfg.nx, 7,
                                            dtype=jcfg.npdtype)
    jcfg = dataclasses.replace(jcfg, tides=om)
    jforcing = dataclasses.replace(jforcing, tide_amp=jnp.asarray(amp),
                                   tide_phase=jnp.asarray(ph))
    jst = j_prepare_state(jst.replace(t=jnp.asarray(7 * jcfg.dt)), jcfg)
    return (jcfg, jgrid, jforcing, jst), to_port(jcfg, jgrid, jforcing, jst)


def test_streamed_phases_match_xla():
    """At f64 on the shelf with 9 layers and 9 constituents, 48 x 32 on
    tiles of 16 x 8: K3a's streamed schedule against beom_tpu's phase A
    (fb.momentum_update without the surface term, the transport's
    divergence) within 1e-12 of each field's scale, both parities; and 3
    implicit-FS steps through both streamed schedules around the fused
    stepper's solve against 3 of beom_tpu's XLA steps, within the field-
    scale bound of test_torch_layer_stream.py's streamed path (1e-9)."""
    kw = dict(solver_tol=1e-13, solver_maxiter=5000, precond="jacobi")
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _jax_shelf(
        9, "implicit_fs", **kw)
    statics = (grid, forcing)
    one = prepare_state(st, cfg)
    with one_thread():
        for n in (0, 1):
            js = jst.replace(n=n)
            ju, jv = j_fb.momentum_update(js.h, js, jgrid, jforcing, jcfg,
                                          free_surface=False)
            U, V = j_projection.barotropic_transport(js.h, ju, jv, jgrid)
            jdiv = (j_ops.d_xm(U, jcfg.dx) + j_ops.d_ym(V, jcfg.dy)) \
                * jgrid.mask
            got = fused_projection.proj_a_streamed(one.h, one.u, one.v,
                                                   statics, n, cfg,
                                                   tile=TILE)
            for label, a, b in zip(("u*", "v*", "div"), got, (ju, jv, jdiv)):
                _near(f"{label} n={n}", a, torch.tensor(np.asarray(b)))
        jstep = jax.jit(lambda s: j_get_step(jcfg)(s, jgrid, jforcing, jcfg))
        for _ in range(3):
            jst = jstep(jst)
        solve = fused_projection.make_solve(grid, cfg,
                                            projection.solve_lam(cfg))
        ph = fused_projection.Phases(grid, forcing, cfg)
        for _ in range(3):
            us, vs, div = fused_projection.proj_a_streamed(
                one.h, one.u, one.v, statics, one.n, cfg, tile=TILE)
            rhs, x0 = fused_projection._rhs_plain(one.h, div, grid, cfg,
                                                  ph.lam, one.phi,
                                                  one.phi_prev)
            p = solve(rhs, x0=x0)
            h, u, v = fused_projection.proj_b_streamed(
                one.h, us, vs, p, statics, one.t, cfg, tile=TILE)
            out = State(h=h, u=u, v=v, n=one.n + 1,
                        t=advance_time(one.t, cfg.dt, cfg.npdtype))
            one = projection.with_carry(out, one, p)
    assert_state_close(one, jst, 1e-9, "implicit_fs streamed")
    assert float(jnp.abs(jst.u).max()) > 0
