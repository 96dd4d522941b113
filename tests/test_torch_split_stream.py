"""The layer-streamed split step (K1s's route 3 at many layers): its
schedule on the host, its plan and its shared memory.

Where the planes of every layer leave the split step's slow phase and
recomposition only small tiles or none, they stream the layers through a
few planes of one layer (csrc/split_body.cuh: sps): the slow phase in one
launch, carrying Montgomery's running sums from layer to layer and the
column's depth-mean sums in registers, its shear parts subtracted in a
second loop; the recomposition in two, the continuity and the column
rescale into out_h, then the velocities, the gates and Flather's
increments from the rescaled h1 read back.  fused_fb.split_step_streamed
runs that schedule on the host, every block in a ring of NaN that stands
for what lies past a CTA's block, so a halo too narrow shows.  It is held
bit for bit against the plain split step and slow phase at f64 on every
case (and the shelf with the biharmonic and the interfacial drag on) at 1,
3 and 9 layers, on tiles that divide neither size, and at nz 9 against
beom_tpu's XLA split step.  The card's tests (test_torch_cuda.py) hold
the kernels against the plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.stepping import get_step as j_get_step
from beom_tpu.stepping import prepare_state as j_prepare_state
from beom_tpu_torch.cases import make_case, shelf_forced
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.stencils import fused_fb
from beom_tpu_torch.stepping import prepare_state
from beom_tpu_torch.stepping import split as split_mod

from tests.test_torch_layer_stream import CASES, LAYERS, TILE, _bits, _case
from tests.torch_parity import assert_state_close, one_thread, perturb, \
    to_port


def _split_case(name, nz, seed, **kw):
    """_case under the split scheme at nsub 4."""
    return _case(name, nz, seed, scheme="split", nsub=4, **kw)


@pytest.mark.parametrize("nz", LAYERS)
@pytest.mark.parametrize("name,extra", CASES)
def test_streamed_split_step_is_the_plain_step(name, extra, nz):
    """The streamed schedule on the host bit for bit the plain split step,
    and its slow phase bit for bit split.slow_phase."""
    cfg, grid, forcing, st = _split_case(name, nz, 11, **extra)
    statics = (grid, forcing)
    with one_thread():
        *got, slow = fused_fb.split_step_streamed(st.h, st.u, st.v, statics,
                                                  0, st.t, cfg, tile=TILE)
        ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, statics, 0,
                                           st.t, cfg, 1)
        sp = split_mod.slow_phase(State(h=st.h, u=st.u, v=st.v, t=st.t,
                                        n=0), grid, forcing, cfg)
    _bits("step", got, ref)
    for f, a, b in zip(sp._fields, slow, sp):
        assert torch.equal(a, b), (f, float((a - b).abs().max()))
    assert float(ref[1].abs().max()) > 0


@pytest.mark.parametrize("name,extra", [
    ("double_gyre", {}), ("coastal_wetdry", {}),
    ("shelf_forced", dict(nu4=1e9, r_int=1e-4))])
def test_streamed_split_halos_are_pinned(name, extra):
    """The ring of NaN shows a block too narrow, so the tests above hold at
    the kernels' halos (the slow phase's 2, the continuity's LO, the
    velocities' 1): a narrower block lets the NaN into the result where a
    term reads that far (the slow phase's biharmonic one point less; the
    continuity with no halo, since under wet/dry the limiter's scale at a
    NaN compares false and is 1, which hides its second point from the
    ring; the gates and Flather, which read h1 east and north, one point
    less), and the kernel of a case without them reads no halo for its
    velocities."""
    cfg, grid, forcing, st = _split_case(name, 3, 17, **extra)
    statics = (grid, forcing)
    lo = 2 if cfg.wetdry else 1
    args = (st.h, st.u, st.v, statics, 0, st.t, cfg)
    nan = lambda outs: any(bool(torch.isnan(a).any()) for a in outs)
    with one_thread():
        ref = fused_fb.fused_fb_step_plain(*args, 1)
        run = lambda halos: fused_fb.split_step_streamed(
            *args, tile=TILE, halos=halos)[:3]
        _bits("the kernels' halos", run((2, lo, 1)), ref)
        assert nan(run((2, 0, 1)))
        assert nan(run((1, lo, 1))) == (cfg.nu4 != 0.0)
        assert nan(run((2, lo, 0))) == (cfg.wetdry or cfg.obc)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_split_stream_smem_does_not_grow_with_layers(dtype):
    """The streamed split kernels' shared memory holds planes of one layer:
    the same at 1 and 64 layers, within one CTA's 232,448 bytes at the
    largest tile with every term on, several CTAs per SM at f32; each
    kernel's planes counted by hand."""
    cfg = make_case("shelf_forced", nx=64, ny=64, device="cpu", dtype=dtype,
                    scheme="split", nsub=8, nu4=1e9, r_int=1e-4)[0]
    elem = 4 if dtype == "float32" else 8
    per = {}
    for nz in (1, 64):
        c = dataclasses.replace(cfg, nz=nz, rho=tuple(1020.0 + k
                                                      for k in range(nz)))
        per[nz] = fused_fb.split_stream_smem(c, (32, 16), elem)
    assert per[1] == per[64]
    smem = per[64]
    assert max(smem.values()) <= fused_fb._MAX_SMEM
    # the slow phase: 16 planes of 36 x 20 (h, u, v of two layers, and
    # the biharmonic's two); the continuity: 15 of 36 x 20 under wet/dry
    # (h, u', v' of two layers); the velocities: 5 of 34 x 18
    assert smem["split_slow"] == 36 * 20 * (16 * elem + 4)
    assert smem["split_rec_h"] == 36 * 20 * (15 * elem + 4)
    assert smem["split_rec_uv"] == 34 * 18 * (5 * elem + 4)
    if dtype == "float32":
        assert 233472 // (max(smem.values()) + 1024) >= 4
    c = dataclasses.replace(cfg, nz=64, rho=tuple(1020.0 + k
                                                  for k in range(64)))
    sp = fused_fb.split_plan(c, c.tdtype)
    assert sp.stream and sp.route == 3 and sp.launches() == 4
    assert "layer-streamed" in sp.describe()
    name, defines = fused_fb.build_spec(c, c.tdtype)
    assert "BEOM_STREAM=1" in defines and "BEOM_SPILL=1" not in defines
    assert ("BEOM_TX=32", "BEOM_TY=16") == defines[-9:-7]


# each case's own layers at nsub 4, 8, 12: (route at f32, at f64)
OWN_ROUTES = {"double_gyre": ((2, 2, 2), (2, 2, 3)),
              "two_layer": ((2, 2, 2), (2, 2, 3)),
              "rigid_lid": ((2, 2, 2), (2, 2, 3)),
              "coastal_wetdry": ((2, 2, 3), (2, 3, 3)),
              "shelf_forced": ((3, 3, 3), (3, 3, 3))}


@pytest.mark.parametrize("name", sorted(OWN_ROUTES))
def test_split_plan_streams_from_four_layers(name):
    """Each case at its own layers keeps the route and the shared-memory
    kernels it had (pinned), and its describe() names no streamed
    kernel; at any nz to 64 the plan streams exactly on route 3 from
    _STREAM_FROM (4) layers and wherever no tile fits, and the forced
    plan streams on either route."""
    for i, dtype in enumerate(("float32", "float64")):
        for nsub, route in zip((4, 8, 12), OWN_ROUTES[name][i]):
            cfg = make_case(name, nx=64, ny=64, device="cpu", dtype=dtype,
                            scheme="split", nsub=nsub)[0]
            sp = fused_fb.split_plan(cfg, cfg.tdtype)
            assert (sp.route, sp.stream) == (route, False), (dtype, nsub)
            assert "layer-streamed" not in sp.describe()
            forced = fused_fb.split_plan(cfg, cfg.tdtype, True)
            assert forced.stream and forced.route == route
            assert "layer-streamed" in forced.describe()
        base = make_case(name, nx=64, ny=64, device="cpu", dtype=dtype,
                         scheme="split", nsub=8)[0]
        for nz in (2, 4, 8, 13, 16, 25, 32, 48, 64):
            cfg = dataclasses.replace(base, nz=nz, rho=tuple(
                1020.0 + 0.5 * k for k in range(nz)))
            sp = fused_fb.split_plan(cfg, cfg.tdtype)
            off = fused_fb.single_tile(cfg, cfg.tdtype)[1]
            assert fused_fb._STREAM_FROM == 4
            assert sp.stream == (off or sp.route == 3 and nz >= 4), (dtype,
                                                                   nz)
            assert sp.launches() == (2 if sp.route == 2 else 3 + sp.stream)


def test_streamed_split_path_matches_xla():
    """3 split steps through the streamed schedule on the host against 3
    steps of beom_tpu's XLA split step at f64 on the shelf at nz 9 with 9
    constituents, nsub 4, 48 x 32 on tiles of 16 x 8: within the
    field-scale bound of test_torch_layers.py's parity tests (1e-11)."""
    jcfg, jgrid, jforcing, jst = jax_make_case(
        "shelf_forced", nx=48, ny=32, dtype="float64", scheme="split",
        nsub=4)
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
        for _ in range(3):
            h, u, v, _ = fused_fb.split_step_streamed(
                one.h, one.u, one.v, statics, one.n, one.t, cfg, tile=TILE)
            one = State(h=h, u=u, v=v, n=one.n + 1,
                        t=advance_time(one.t, cfg.dt, cfg.npdtype))
    assert_state_close(one, jst, 1e-11, "split")
    assert float(jnp.abs(jst.u).max()) > 0
