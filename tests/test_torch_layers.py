"""Many layers and tidal constituents: the fused kernels' plans, slots and
parameters at any nz, and the port's fused steppers at nz 9 and 32 against
beom_tpu.

The fused steppers on the CPU run the kernels' plain versions, so these
tests hold the functions the kernels compute (at every layer count, with up
to 13 of TPXO's constituents at the open boundary) against beom_tpu's XLA
path at f64: make_stepper with backend='fused' on one device, and
make_dist_stepper with backend='fused' on 2 x 2 shards.  beom_tpu's Pallas
path stands in for neither here: in interpret mode it takes 13 to 24 s for
two steps of one scheme at nz 9 (on 48 x 64; its band needs ny >= 64 at this
halo), which this file's budget of about a minute cannot hold for the
sixteen cases; the XLA path is the function those kernels compute
(tests/unit/test_pallas.py holds them equal), and the card's tests
(test_torch_cuda.py) hold the kernels against these plain versions.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.stepping import get_step as j_get_step
from beom_tpu.stepping import prepare_state as j_prepare_state
from beom_tpu_torch.cases import make_case, shelf_forced
from beom_tpu_torch.parallel.dist import make_dist_stepper
from beom_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state
from beom_tpu_torch.stencils import dist_band, fused_fb, fused_projection
from beom_tpu_torch.stepping import make_stepper, prepare_state

from tests.torch_parity import assert_state_close, one_thread, perturb, \
    to_port

CSRC = Path(__file__).resolve().parents[1] / "beom_tpu_torch" / "csrc"
LAYERS = (1, 8, 9, 13, 16, 25, 32, 64)
CASES = ("double_gyre", "two_layer", "rigid_lid", "coastal_wetdry",
         "shelf_forced")
SCHEMES = ("fb", "split", "rigid_lid", "implicit_fs")


def _layered_jax(cfg, forcing, st, nz):
    """cfg, forcing and state (beom_tpu's) with the bottom layer split into
    equal layers, each a little denser, up to nz layers."""
    parts, top = nz - cfg.nz + 1, cfg.nz - 1
    rho = tuple(cfg.rho[:top]) + tuple(cfg.rho[top] + i
                                       for i in range(parts))

    def split(a, share):
        return jnp.concatenate([a[:top]] + [a[top:] / share] * parts)

    return (dataclasses.replace(cfg, nz=nz, rho=rho),
            dataclasses.replace(forcing, h_ext=split(forcing.h_ext, parts)),
            st.replace(h=split(st.h, parts), u=split(st.u, 1),
                       v=split(st.v, 1)))


def _with_tides(cfg, forcing, n, seed):
    """beom_tpu's cfg and forcing with the first n of TPXO's constituents
    (shelf_forced.constituents)."""
    om, amp, ph = shelf_forced.constituents(n, cfg.ny, cfg.nx, seed,
                                            dtype=cfg.npdtype)
    return (dataclasses.replace(cfg, tides=om),
            dataclasses.replace(forcing, tide_amp=jnp.asarray(amp),
                                tide_phase=jnp.asarray(ph)))


# the port's steppers against the XLA path: (case, nz, constituents)
STEPPED = [("shelf_forced", 9, 9), ("shelf_forced", 32, 13),
           ("two_layer", 9, 0), ("two_layer", 32, 0)]
# the field-scale bound of 3 steps: f64 round-off of the op-by-op twins;
# the projection schemes' solves (tolerance 1e-13) amplify it
REL = {"fb": 1e-11, "split": 1e-11, "rigid_lid": 1e-9,
       "implicit_fs": 1e-9}


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name,nz,n_tides", STEPPED)
def test_fused_steppers_match_xla(name, nz, n_tides, scheme):
    """3 steps of the port's fused stepper (the kernels' plain versions)
    on one device and on 2 x 2 shards against 3 steps of beom_tpu's XLA
    path at f64, 48 x 32, the case layered to nz layers with n_tides
    constituents: within REL[scheme] of each field's scale (the velocity's
    for u and v)."""
    kw = dict(solver_tol=1e-13, solver_maxiter=5000, precond="jacobi") \
        if scheme in ("rigid_lid", "implicit_fs") else dict(nsub=4)
    jcfg, jgrid, jforcing, jst = jax_make_case(
        name, nx=48, ny=32, dtype="float64", scheme=scheme, **kw)
    jst = perturb(jcfg, jgrid, jst, 5)
    jcfg, jforcing, jst = _layered_jax(jcfg, jforcing, jst, nz)
    if n_tides:
        jcfg, jforcing = _with_tides(jcfg, jforcing, n_tides, 5)
    jst = j_prepare_state(jst.replace(t=jnp.asarray(7 * jcfg.dt)), jcfg)
    cfg, grid, forcing, st = to_port(jcfg, jgrid, jforcing, jst)
    assert cfg.nz == nz and len(cfg.tides) == max(n_tides, 1 if
                                                  name == "shelf_forced"
                                                  else 0)
    jstep = jax.jit(lambda s: j_get_step(jcfg)(s, jgrid, jforcing, jcfg))
    for _ in range(3):
        jst = jstep(jst)
    fused = dataclasses.replace(cfg, backend="fused")
    with one_thread():
        step = make_stepper(grid, forcing, fused)
        one = prepare_state(st, fused)
        for _ in range(3):
            one = step(one)
        assert_state_close(one, jst, REL[scheme], "one device")
        mcfg = dataclasses.replace(fused, mesh_y=2, mesh_x=2)
        mesh = make_mesh(2, 2, devices=["cpu"])
        mstep = make_dist_stepper(grid, forcing, mcfg, mesh)
        sh = shard_state(prepare_state(st, mcfg), mesh)
        for _ in range(3):
            sh = mstep(sh)
        assert_state_close(gather_state(sh), jst, REL[scheme], "2 x 2")
    assert float(jnp.abs(jst.u).max()) > 0


def _spills_from(case, scheme, dtype):
    """The first of LAYERS at which the scheme's single-step kernels leave
    shared memory on `case` (None: none of them), by the shared-memory
    walls of a CTA's 232,448 bytes: K1 at nz 32 (f32) and 16 (f64), 25 and
    13 under wet/dry; the projection phases at 32 and 16; the split step's
    slow phase and recomposition (nsub 8) past 64 (f32) and at 64 (f64),
    at 64 and 25 under wet/dry.  There K1, K3a, K3b and the split step
    stream their layers, on one device and in K7's shard kernels alike."""
    wd = case in ("coastal_wetdry", "shelf_forced")
    f64 = dtype == "float64"
    if scheme == "fb":
        return (13 if f64 else 25) if wd else (16 if f64 else 32)
    if scheme == "split":
        return (25 if f64 else 64) if wd else (64 if f64 else None)
    return 16 if f64 else 32


# the first of LAYERS at which the split step's slow phase and
# recomposition (nsub 8) stream their layers on one device, on every case
# and type: route 3 from 4 layers (fused_fb._STREAM_FROM; route 2, which
# keeps shared memory, ends below 8 layers)
STREAMS_FROM = 8
# the first of LAYERS at which both projection phases stream their layers,
# on one device and on the shards (from 4 layers: fused_projection.
# _STREAM_FROM)
PROJECTION_STREAMS_FROM = 8


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", CASES)
def test_plans_take_every_layer_count(case, scheme, dtype):
    """For every nz of LAYERS (13 constituents on the shelf), the build
    specs and plans of one device and of a 2 x 2 mesh return a kernel
    route without raising: from the first nz past the single-step kernels'
    shared-memory wall (pinned) K1 layer-streamed (BEOM_STREAM); the split
    step layer-streamed from nz 8 (pinned, route 3); both projection
    phases layer-streamed from nz 8 (pinned); K7's fb, split and
    projection bodies streamed where the single-device kernels are, with
    and without BEOM_CARDS, never on a spill route (BEOM_SPILL is gone);
    the pass kernel and the staged phases only where they fit, every
    plan's describe() naming its route."""
    base = make_case(case, nx=64, ny=64, device="cpu", dtype=dtype,
                     scheme=scheme, nsub=8)[0]
    if case == "shelf_forced":
        base = dataclasses.replace(base, tides=shelf_forced.constituents(
            13, 1, 1, 0)[0])
    mesh = make_mesh(2, 2, devices=["cpu"])
    first = _spills_from(case, scheme, dtype)
    for nz in LAYERS:
        rho = tuple(1020.0 + 0.5 * k for k in range(nz))
        cfg = dataclasses.replace(base, nz=nz, rho=rho)
        projection = scheme in ("rigid_lid", "implicit_fs")
        spill = first is not None and nz >= first
        stream = scheme == "split" and nz >= STREAMS_FROM
        pstream = projection and nz >= PROJECTION_STREAMS_FROM
        mp = dist_band.mesh_plan(cfg, cfg.tdtype, mesh)
        streamed = stream if scheme == "split" else pstream if projection \
            else spill
        assert mp.streamed == streamed, (nz, mp.describe())
        assert "spill" not in mp.describe(), nz
        assert ("layer-streamed" in mp.describe()) == streamed, nz
        if projection:
            pl = fused_projection.plan(cfg, cfg.tdtype)
            assert pl.stream == pstream and (pl.a is None or not pstream)
            assert pl.stream_a == pl.stream_b == pstream
            assert ("layer-streamed" in pl.describe()) == pstream
            assert not spill or pstream
            if pstream:
                assert pl.a is None and pl.b is None and not pl.rhs
            name, defines = fused_projection.build_spec(cfg, cfg.tdtype,
                                                        pl, True)
        else:
            assert fused_fb.launch_plan(cfg, cfg.tdtype, 1).stream == spill
            if scheme == "fb":
                pl = fused_fb.plan(cfg, cfg.tdtype, 4)
                assert pl.stream == spill and (pl.kb == 1 or not spill)
                assert ("layer-streamed" in pl.describe()) == spill
                for m in pl.launches(4):
                    fused_fb.build_spec(cfg, cfg.tdtype, m)
            else:
                sp = fused_fb.split_plan(cfg, cfg.tdtype)
                assert sp.stream == stream and sp.route in (2, 3)
                assert sp.route == 3 or not stream
                assert ("layer-streamed" in sp.describe()) == stream
                assert "spill route" not in sp.describe()
            name, defines = fused_fb.build_spec(cfg, cfg.tdtype)
        assert "BEOM_SPILL=1" not in defines, (nz, defines)
        assert ("BEOM_STREAM=1" in defines) == (
            stream if scheme == "split" else pstream if projection
            else spill), (nz, defines)
        assert f"BEOM_NZ={nz}" in defines
        for cards in (False, True):
            for m in set(mp.fb_launches(4)) if scheme == "fb" else {1}:
                _, d = dist_band.build_spec(cfg, cfg.tdtype, m, True, cards)
                assert not any(x.startswith("BEOM_SPILL") for x in d)
                assert ("BEOM_STREAM=1" in d) == (streamed and m == 1)


def test_forced_spill_route_where_both_build():
    """The plans' own parameter takes the routes off shared memory where
    the shared-memory route builds too (nz 8 f32 on the shelf): K1, K3a,
    K3b and the split step layer-streamed, and K7's fb, split and
    projection bodies with them; the builds differ only in the switch and
    the tile, the shard builds' switches are the single-device builds',
    and their shared memory the single-device streamed kernels'."""
    cfg = make_case("shelf_forced", nx=64, ny=64, device="cpu",
                    dtype="float32")[0]
    cfg = dataclasses.replace(cfg, nz=8, rho=tuple(1020.0 + k
                                                   for k in range(8)))
    assert not fused_fb.plan(cfg, torch.float32, 1).stream
    forced = fused_fb.plan(cfg, torch.float32, 4, True)
    assert forced.stream and forced.kb == 1 and forced.tile == (32, 16)
    assert forced.smem == max(fused_fb.stream_smem(cfg, (32, 16),
                                                   4).values())
    a = dict(d.split("=") for d in fused_fb.build_spec(cfg,
                                                       torch.float32)[1])
    b = dict(d.split("=") for d in fused_fb.build_spec(
        cfg, torch.float32, off_smem=True)[1])
    assert b.pop("BEOM_STREAM") == "1"
    assert {k: v for k, v in a.items() if k not in ("BEOM_TX", "BEOM_TY")} \
        == {k: v for k, v in b.items() if k not in ("BEOM_TX", "BEOM_TY")}
    # K7's body of the step streams with K1
    mesh = make_mesh(2, 2, devices=["cpu"])
    assert dist_band.mesh_plan(cfg, torch.float32, mesh, True).streamed
    assert not dist_band.mesh_plan(cfg, torch.float32, mesh).streamed
    name, d = dist_band.build_spec(cfg, torch.float32, off_smem=True)
    assert d == fused_fb.build_spec(cfg, torch.float32, off_smem=True)[1]
    assert dist_band._want_smem(cfg, name, d, 4, 1) == [
        forced.smem, fused_fb.stream_smem(cfg, (32, 16), 4)["fb_continuity"]]
    rigid = dataclasses.replace(cfg, scheme="rigid_lid")
    ph = fused_projection.plan(rigid, torch.float32, True)
    assert ph == fused_projection.PhasePlan(None, None, False, True)
    assert ph.stream_a and ph.stream_b
    # the phases stream at nz 8 by their plan; a plan that says not builds
    # the single-step kernels in shared memory, which fit there
    assert fused_projection.plan(rigid, torch.float32) == ph
    single = fused_projection.PhasePlan(None, None, False)
    a = dict(d.split("=") for d in fused_projection.build_spec(
        rigid, torch.float32, single)[1])
    b = dict(d.split("=") for d in fused_projection.build_spec(
        rigid, torch.float32, ph)[1])
    assert b.pop("BEOM_STREAM") == "1" and "BEOM_SPILL" not in a
    assert (int(a["BEOM_TX"]), int(a["BEOM_TY"])) \
        == fused_projection.single_tile(rigid, torch.float32)[0]
    assert {k: v for k, v in a.items() if k not in ("BEOM_TX", "BEOM_TY")} \
        == {k: v for k, v in b.items() if k not in ("BEOM_TX", "BEOM_TY")}
    # K7-proj streams too, never spills
    d = dist_band.build_spec(rigid, torch.float32, off_smem=True)[1]
    assert "BEOM_STREAM=1" in d and "BEOM_SPILL=1" not in d
    split_cfg = dataclasses.replace(cfg, scheme="split", nsub=8)
    split = fused_fb.split_plan(split_cfg, torch.float32, True)
    assert split.stream and "layer-streamed" in split.describe()
    # the split step streams at nz 8 by its plan; a plan that says not
    # builds the shared-memory route, which fits there
    assert fused_fb.split_plan(split_cfg, torch.float32) == split
    a = fused_fb.build_spec(split_cfg, torch.float32, sp=dataclasses.replace(
        split, stream=False))[1]
    b = fused_fb.build_spec(split_cfg, torch.float32, off_smem=True)[1]
    assert "BEOM_STREAM=1" in b and "BEOM_STREAM=1" not in a
    assert b == fused_fb.build_spec(split_cfg, torch.float32)[1] \
        == fused_fb.build_spec(split_cfg, torch.float32, sp=split)[1]
    # the plan names the route: a forcing flag beside it is refused
    with pytest.raises(ValueError, match="the plan names the route"):
        fused_fb.build_spec(split_cfg, torch.float32, sp=split, off_smem=True)
    # K7-split streams with the split step, its shared memory the
    # single-device streamed kernels' (8-byte offsets across cards)
    name, d = dist_band.build_spec(split_cfg, torch.float32, off_smem=True,
                                   cards=True)
    assert d == b + ("BEOM_CARDS=1",)
    smem = fused_fb.split_stream_smem(split_cfg, (32, 16), 4, 8)
    want = dist_band._want_smem(split_cfg, name, d, 4, 1)
    assert [want[0], want[1], want[4]] == [
        smem["split_slow"], smem["split_rec_h"], smem["split_rec_uv"]]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_spill_false_lets_the_plan_choose(scheme):
    """off_smem=False means what leaving it out means at every layer: the
    plans leave shared memory where no tile fits (nz 32 f32 on the shelf,
    past every single-step wall but the split step's; K1 layer-streamed,
    the split step layer-streamed by its plan from 4 layers, both
    projection phases streamed), on one device and on the shards alike,
    and off_smem=True forces it; no plan raises for want of a tile."""
    cfg = make_case("shelf_forced", nx=64, ny=64, device="cpu",
                    dtype="float32", scheme=scheme, nsub=8)[0]
    cfg = dataclasses.replace(cfg, nz=32, rho=tuple(1020.0 + 0.5 * k
                                                    for k in range(32)))
    mesh = make_mesh(2, 2, devices=["cpu"])
    f32 = torch.float32
    chosen = scheme != "split"
    for off in (False, True):
        want = chosen or off
        mp = dist_band.mesh_plan(cfg, f32, mesh, off)
        if scheme in ("rigid_lid", "implicit_fs"):
            assert mp.streamed == want
            assert fused_projection.plan(cfg, f32, off).stream == want
            assert fused_projection.single_tile(cfg, f32, off)[1] == want
            assert ("BEOM_STREAM=1" in dist_band.build_spec(
                cfg, f32, off_smem=off)[1]) == want
            continue
        assert mp.streamed == (want or scheme == "split")
        assert fused_fb.single_tile(cfg, f32, off)[1] == want
        assert ("BEOM_STREAM=1" in dist_band.build_spec(
            cfg, f32, off_smem=off)[1]) == mp.streamed
        streams = "BEOM_STREAM=1" in fused_fb.build_spec(cfg, f32,
                                                         off_smem=off)[1]
        if scheme == "fb":
            assert streams == want
            assert fused_fb.plan(cfg, f32, 4, off).stream == want
            assert fused_fb.launch_plan(cfg, f32, 1, off).stream == want
        else:
            assert streams and fused_fb.split_plan(cfg, f32, off).stream


def _enum_dbl(nz: int, ntide: int) -> dict:
    """csrc/fb_terms.cuh's enum Dbl evaluated at NZ = nz and NTIDE =
    ntide: each name's value by the C rules (one past the previous name
    where no value is given)."""
    text = (CSRC / "fb_terms.cuh").read_text()
    max_kb = int(re.search(r"constexpr int MAX_KB = (\d+);", text)[1])
    body = re.search(r"enum Dbl \{(.*?)\};", text, re.S)[1]
    env = {"NZ": nz, "NTIDE_SLOTS": max(ntide, 1), "MAX_KB": max_kb}
    out, nxt = {}, 0
    for item in (x.strip() for x in body.split(",")):
        name, _, expr = item.partition("=")
        name = name.strip()
        value = eval(expr, {}, {**env, **out}) if expr else nxt
        out[name] = value
        nxt = value + 1
    return out


@pytest.mark.parametrize("nz,n_tides,obc", [
    (1, 0, False), (2, 1, True), (8, 8, True), (9, 9, True), (32, 13, True),
    (64, 13, True), (16, 13, False)])
def test_slot_layout_matches_the_enum(nz, n_tides, obc):
    """slot_layout is the enum's arithmetic (D_OMEGA0 = D_GP0 + NZ, D_TS0 =
    D_OMEGA0 + max(NTIDE, 1), N_DBL = D_TS0 + MAX_KB), and _scalars writes
    gprime, the build's constituents and the step times into those
    slots."""
    cfg = dataclasses.replace(
        make_case("shelf_forced", nx=16, ny=16, device="cpu")[0], nz=nz,
        rho=tuple(1020.0 + k for k in range(nz)), obc=obc,
        tides=tuple(1e-4 * (k + 1) for k in range(n_tides)))
    ntide = n_tides if obc else 0
    enum = _enum_dbl(nz, ntide)
    lay = fused_fb.slot_layout(cfg)
    assert (lay.gp0, lay.omega0, lay.ts0, lay.n) == (
        enum["D_GP0"], enum["D_OMEGA0"], enum["D_TS0"], enum["N_DBL"])
    assert enum["D_T1"] == fused_fb.D_T1
    ts = [3.0 + k for k in range(4)]
    ints, dbls = fused_fb._scalars(cfg, 0, 2.5, ts=ts)
    assert len(dbls) == lay.n and len(ints) == fused_fb.N_INT
    assert list(dbls[lay.gp0:lay.omega0]) == list(cfg.gprime)
    assert list(dbls[lay.omega0:lay.omega0 + ntide]) == list(cfg.tides)[
        :ntide]
    assert list(dbls[lay.ts0:lay.ts0 + 4]) == ts
    assert dbls[fused_fb.D_T1] == 2.5 and list(ints)[:2] == [16, 16]


def test_params_fit_the_kernel_parameter_limit():
    """Params<double> of nz 64 and 13 constituents across cards (every
    operand nine pointers) stays within PARAMS_MAX, the budget of
    fb_terms.cuh's static_assert (mirrored here), and the largest kernel's
    parameters (the shard recomposition's streamed velocity kernel:
    Params, its source of 19 stacked operands, h1's nine stacks, two
    outputs) within the 4096 bytes of the limit."""
    text = (CSRC / "fb_terms.cuh").read_text()
    assert int(re.search(r"PARAM_LIMIT = (\d+);", text)[1]) \
        == fused_fb.PARAM_LIMIT == 4096
    assert re.search(r"PARAMS_MAX = PARAM_LIMIT - (\d+);", text)[1] \
        == str(fused_fb.PARAM_LIMIT - fused_fb.PARAMS_MAX)
    cfg = dataclasses.replace(
        make_case("shelf_forced", nx=16, ny=16, device="cpu")[0], nz=64,
        rho=tuple(1020.0 + k for k in range(64)),
        tides=shelf_forced.constituents(13, 1, 1, 0)[0])
    size = fused_fb.params_bytes(cfg, 8, cards=True)
    assert size <= fused_fb.PARAMS_MAX, size
    # StackSrc<double, 19> across cards: 19 x 9 pointers, the Stack's nine
    # ints (padded to 40), the plane and the shard's (j, i)
    stack_src = 19 * 72 + 40 + 8 + 8
    assert size + stack_src + 72 + 2 * 8 <= fused_fb.PARAM_LIMIT
    # the layout by hand on one card, f32, nz 2 and one constituent: 18
    # operands, 9 ints, the scalars, then the plane at a multiple of 8
    small = dataclasses.replace(cfg, nz=2, rho=(1026.0, 1027.5),
                                tides=(1e-4,))
    assert fused_fb.params_bytes(small, 4) == \
        18 * 8 + 9 * 4 + (16 + 2 + 1 + 8) * 4 + 8
