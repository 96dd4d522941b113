"""K7's layer-streamed fb and split bodies on the shards of a mesh: their
schedule on the host, their plans and builds.

Where K1 and K1s stream their layers (fused_fb.launch_plan, split_plan),
the shard kernels run the same streamed bodies (csrc/fb_step_body.cuh:
fbs, csrc/split_body.cuh: sps) over the tiles of every shard, each block's
offsets from the stacked layout: K7-fb in two launches per step (the
continuity into h1, then the momentum, which reads h1 back at its block's
points, a neighbour shard's or card's too), K7-split's slow phase in one
and its recomposition in two.  dist_band.fb_stream_launch_tiled and
split_stream_launch_tiled run those launches on the host through
_launch_tiled, each block of a tile of every shard gathered through the
stacked layout's row and column tables and put in a ring of NaN that
stands for what lies past a CTA's block, so a halo too narrow shows.  They
are held bit for bit at f64 against the plain shard step
(dist_band.shard_step_plain) and the plain split pieces on every case (and
the shelf with the biharmonic and the interfacial drag on) at 1, 3 and 9
layers, both sweep parities, on a (2, 2) mesh whose 22 x 18 blocks the 16
x 8 tiles divide on neither axis, and over two cards' stacks; and at nz 9
against beom_tpu's make_dist_stepper on the Pallas interpreter.  The
card's tests (test_torch_cuda.py) hold the kernels against the plain
versions and the single-device streamed K1 / K1s.
"""

import dataclasses

import pytest
import torch

from beom_tpu.parallel.dist import make_dist_stepper as j_make_dist_stepper
from beom_tpu.parallel.mesh import make_mesh as j_make_mesh
from beom_tpu.parallel.mesh import shard_state as j_shard_state
from beom_tpu_torch.cases import make_case, shelf_forced
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.parallel.mesh import Card, gather, make_mesh, shard
from beom_tpu_torch.stencils import dist_band, fused_fb

from tests.test_torch_layer_stream import CASES, LAYERS, TILE, _bits, _case
from tests.test_torch_proj_stream import _jax_shelf
from tests.torch_parity import assert_state_close, one_thread

# a (2, 2) mesh of 22 x 18 blocks: TILE (16 x 8) divides neither
NX, NY, MESH = 44, 36, (2, 2)
# the split subcycle's tiles (halo nsub)
SUB_TILE = (16, 16)


def _mesh_case(name, nz, seed, scheme, **kw):
    """_case on NX x NY under `scheme` (split at nsub 4), the mesh, the
    statics stacked and padded, and (h, u, v) sharded."""
    if scheme == "split":
        kw = dict(kw, nsub=4)
    cfg, grid, forcing, st = _case(name, nz, seed, nx=NX, ny=NY,
                                   scheme=scheme, **kw)
    mesh = make_mesh(*MESH, devices=["cpu"])
    sh = [shard(a, mesh) for a in (st.h, st.u, st.v)]
    return (cfg, grid, forcing, st, mesh,
            dist_band.pad_statics(grid, forcing, cfg, mesh),
            dist_band.stack_statics(grid, forcing, mesh), sh)


def _stacked(fields):
    return [dist_band.stack(a) for a in fields]


def _split_plain(sh, pst, t, cfg):
    """The plain split pieces on the shards: (h1, u1, v1) and SlowPhase's
    13 fields, stacked."""
    slow = dist_band.split_slow_plain(*sh, pst, cfg)
    sub = dist_band.split_subcycle_plain(slow, pst, cfg)
    out = dist_band.split_recompose_plain(slow, sub, sh[0], pst, t, cfg)
    return _stacked(out), _stacked(slow)


@pytest.mark.parametrize("nz", LAYERS)
@pytest.mark.parametrize("name,extra", CASES)
def test_streamed_shard_fb_step_is_the_plain_step(name, extra, nz):
    """K7-fb's two streamed launches over every shard on the host, both
    sweep parities, bit for bit the plain shard step."""
    cfg, _, _, st, mesh, pst, stat, sh = _mesh_case(name, nz, 23, "fb",
                                                    **extra)
    with one_thread():
        for n in (0, 1):
            got = dist_band.fb_stream_launch_tiled(
                *_stacked(sh), stat, n, st.t, cfg, mesh, TILE)
            ref = dist_band.shard_step_plain(*sh, pst, n, st.t, cfg, 1)
            _bits(f"n={n}", got, _stacked(ref))
    assert float(ref[1].blocks[0].abs().max()) > 0


@pytest.mark.parametrize("nz", LAYERS)
@pytest.mark.parametrize("name,extra", CASES)
def test_streamed_shard_split_step_is_the_plain_step(name, extra, nz):
    """K7-split's streamed launches over every shard on the host (the slow
    phase, route 3's subcycle, the recomposition's two) bit for bit the
    plain split pieces on the shards: the step and the slow phase."""
    cfg, _, _, st, mesh, pst, stat, sh = _mesh_case(name, nz, 29, "split",
                                                    **extra)
    with one_thread():
        got, slow = dist_band.split_stream_launch_tiled(
            *_stacked(sh), stat, st.t, cfg, mesh, TILE, SUB_TILE)
        ref, ref_slow = _split_plain(sh, pst, st.t, cfg)
    _bits("step", got, ref)
    for i, (a, b) in enumerate(zip(slow, ref_slow)):
        assert torch.equal(a, b), (i, float((a - b).abs().max()))


def _two_cards(mesh, axis):
    """The (2, 2) mesh as two cards of two shards along `axis`."""
    if axis == "x":
        return [Card("cpu", (0, 2), (0, 0), (2, 1), (0, 0)),
                Card("cpu", (1, 3), (0, 1), (2, 1), (0, 1))]
    return [Card("cpu", (0, 1), (0, 0), (1, 2), (0, 0)),
            Card("cpu", (2, 3), (1, 0), (1, 2), (1, 0))]


@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("scheme", ["fb", "split"])
def test_streamed_shard_launches_over_two_cards(scheme, axis):
    """Over two cards' stacks (BEOM_CARDS' layout: each card's tables
    card-local, a point's card class picking the stack), the streamed
    launches read h1 and the slow phase's and subcycle's fields at the
    neighbour card's points: bit for bit the plain pieces, on the shelf
    with every term at nz 3."""
    cfg, grid, forcing, st, mesh, pst, _, sh = _mesh_case(
        "shelf_forced", 3, 31, scheme, nu4=1e9, r_int=1e-4)
    cards = _two_cards(mesh, axis)
    parts = [[dist_band.stack_part(a, c.shards) for c in cards] for a in sh]
    stat = [dist_band.stack_statics(grid, forcing, mesh, c) for c in cards]
    with one_thread():
        if scheme == "fb":
            got = dist_band.fb_stream_launch_tiled(
                *parts, stat, 1, st.t, cfg, mesh, TILE, cards=cards)
            ref = dist_band.shard_step_plain(*sh, pst, 1, st.t, cfg, 1)
        else:
            got, _ = dist_band.split_stream_launch_tiled(
                *parts, stat, st.t, cfg, mesh, TILE, SUB_TILE, cards=cards)
            slow = dist_band.split_slow_plain(*sh, pst, cfg)
            sub = dist_band.split_subcycle_plain(slow, pst, cfg)
            ref = dist_band.split_recompose_plain(slow, sub, sh[0], pst,
                                                  st.t, cfg)
    for f, a, b in zip("huv", got, ref):
        for c, card in enumerate(cards):
            want = dist_band.stack_part(b, card.shards)
            assert torch.equal(a[c], want), (f, c)


@pytest.mark.parametrize("name", ["double_gyre", "shelf_forced"])
def test_streamed_shard_halos_are_pinned(name):
    """The ring of NaN shows a block too narrow on the shards as on one
    device (test_torch_layer_stream.py, test_torch_split_stream.py): K7-fb
    exact down to halos of 1 and 2 and not with no halo for the continuity
    or 1 for the momentum; K7-split (the shelf with the biharmonic and the
    interfacial drag on) exact at (2, LO, 1) and not with no halo for the
    recomposition's continuity, one point less for the slow phase where
    the biharmonic reads it, none for the velocities where the gates or
    Flather read h1 east and north."""
    nan = lambda outs: any(bool(torch.isnan(a).any()) for a in outs)
    cfg, _, _, st, mesh, pst, stat, sh = _mesh_case(name, 3, 37, "fb")
    args = (*_stacked(sh), stat, 0, st.t, cfg, mesh, TILE)
    with one_thread():
        ref = _stacked(dist_band.shard_step_plain(*sh, pst, 0, st.t, cfg, 1))
        _bits("fb halos (1, 2)", dist_band.fb_stream_launch_tiled(
            *args, halos=(1, 2)), ref)
        for halos in ((0, 3), (1, 1)):
            assert nan(dist_band.fb_stream_launch_tiled(
                *args, halos=halos)), halos
        extra = dict(nu4=1e9, r_int=1e-4) if name == "shelf_forced" else {}
        cfg, _, _, st, mesh, pst, stat, sh = _mesh_case(name, 3, 37, "split",
                                                        **extra)
        lo = 2 if cfg.wetdry else 1
        ref, _ = _split_plain(sh, pst, st.t, cfg)
        run = lambda halos: dist_band.split_stream_launch_tiled(
            *_stacked(sh), stat, st.t, cfg, mesh, TILE, SUB_TILE,
            halos=halos)[0]
        _bits("split at the kernels' halos", run((2, lo, 1)), ref)
        assert nan(run((2, 0, 1)))
        assert nan(run((1, lo, 1))) == (cfg.nu4 != 0.0)
        assert nan(run((2, lo, 0))) == (cfg.wetdry or cfg.obc)


@pytest.mark.parametrize("cards", [False, True])
def test_mesh_plan_streams_fb_and_split(cards):
    """On a 2 x 2 mesh K7-fb and K7-split take the single-device plans'
    streamed route: at 32 layers on the shelf (f32), past K1's wall and
    from the split step's 4 layers on route 3, and where off_smem forces
    it at 2; MeshPlan.streamed says so, describe() names the streamed
    kernels and no spill route, the launches per call are the plan's, and
    the shard builds carry BEOM_STREAM=1 with and without BEOM_CARDS and
    BEOM_SPILL nowhere, their shared memory the single-device streamed
    kernels' (8-byte offsets across cards).  Below the thresholds the
    builds keep shared memory."""
    base = make_case("shelf_forced", nx=64, ny=64, device="cpu",
                     dtype="float32", nsub=8)[0]
    base = dataclasses.replace(base, tides=shelf_forced.constituents(
        13, 1, 1, 0)[0])
    mesh = make_mesh(*MESH, devices=["cpu"])
    f32, off = torch.float32, 8 if cards else 4
    for scheme in ("fb", "split"):
        for nz, forced in ((32, False), (2, True), (2, False)):
            cfg = dataclasses.replace(base, scheme=scheme, nz=nz, rho=tuple(
                1020.0 + 0.5 * k for k in range(nz)))
            want = nz == 32 or forced
            mp = dist_band.mesh_plan(cfg, f32, mesh, forced)
            if scheme == "fb":
                single = fused_fb.launch_plan(cfg, f32, 1, forced).stream
            else:
                single = fused_fb.split_plan(cfg, f32, forced).stream
            assert mp.streamed == single == want, (scheme, nz, forced)
            text = mp.describe()
            assert ("layer-streamed" in text) == want, text
            assert "spill" not in text
            if want and scheme == "fb":
                assert mp.launches(4) == {"fb": 4, "fb_pass": 0}
            if want and scheme == "split":
                assert mp.split.route == 3
                assert mp.launches(2) == {"split_slow": 2,
                                          "split_subcycle": 2,
                                          "split_recompose": 2}
            name, d = dist_band.build_spec(cfg, f32, cards=cards,
                                           off_smem=forced)
            assert ("BEOM_STREAM=1" in d) == want, (scheme, nz, d)
            assert ("BEOM_CARDS=1" in d) == cards
            assert not any(x.startswith("BEOM_SPILL") for x in d)
            # the shard build's switches are the single-device build's
            assert tuple(x for x in d if x != "BEOM_CARDS=1") == \
                fused_fb.build_spec(cfg, f32, off_smem=forced)[1]
            smem = dist_band._want_smem(cfg, name, d, 4, 1)
            if want and scheme == "fb":
                s = fused_fb.stream_smem(cfg, (32, 16), 4, off)
                assert smem == [s["fb_momentum"], s["fb_continuity"]]
            elif want:
                s = fused_fb.split_stream_smem(cfg, (32, 16), 4, off)
                assert [smem[0], smem[1], smem[4]] == [
                    s["split_slow"], s["split_rec_h"], s["split_rec_uv"]]


@pytest.mark.parametrize("scheme", ["fb", "split"])
def test_streamed_shard_steps_match_beom_tpu(scheme):
    """2 steps of the streamed shard launches on the host (on 32 x 16
    tiles) on a (2, 2) mesh against 2 steps of beom_tpu's
    make_dist_stepper with backend='pallas' on the Pallas interpreter, as
    test_torch_dist_band.py runs it: the shelf at f64 on 64 x 128 with 9
    layers and 9 constituents (split at nsub 4), within 1e-12 of each
    field's scale."""
    kw = dict(nsub=4) if scheme == "split" else {}
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _jax_shelf(
        9, scheme, nx=64, ny=128, backend="pallas", **kw)
    assert cfg.nz == 9 and cfg.steps_per_pass == 1
    jmesh = j_make_mesh(*MESH)
    jout = j_make_dist_stepper(jgrid, jforcing, jcfg, jmesh, n_inner=2)(
        j_shard_state(jst, jmesh))
    assert int(jout.n) == int(jst.n) + 2
    mesh = make_mesh(*MESH, devices=["cpu"])
    stat = dist_band.stack_statics(grid, forcing, mesh)
    h, u, v = (dist_band.stack_global(a, mesh) for a in (st.h, st.u, st.v))
    n, t = int(st.n), st.t
    with one_thread():
        for _ in range(2):
            if scheme == "fb":
                h, u, v = dist_band.fb_stream_launch_tiled(
                    h, u, v, stat, n, t, cfg, mesh, (32, 16))
            else:
                (h, u, v), _ = dist_band.split_stream_launch_tiled(
                    h, u, v, stat, t, cfg, mesh, (32, 16), SUB_TILE)
            n, t = n + 1, advance_time(t, cfg.dt, cfg.npdtype)
    got = State(**{f: gather(dist_band.unstack(a, mesh))
                   for f, a in zip("huv", (h, u, v))}, t=t, n=n)
    assert_state_close(got, jout, 1e-12, f"{scheme} on 2 x 2 shards")
    assert float(abs(got.u).max()) > 0
