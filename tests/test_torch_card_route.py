"""The fused mesh over several cards (K7 and K8 one launch per card,
beom_tpu_torch/stencils/dist_band.py and halo_pad.py, the cards of
parallel/mesh.py), held on the CPU the way tests/test_torch_shard_pass.py
holds the one-card route: the kernels' schedules on the host at f64, each
card's tiles gathering their haloed blocks through the card's row and
column tables, whose terms are card-local and whose classes pick one of
the nine card stacks (csrc/shard_addr.cuh with BEOM_CARDS).  Each emulated
launch over the cards' stacks must equal the single-device plain step or
phase bit for bit: the fb pass, the split step by route 2 and route 3,
phases A and B at both parities, on the gyre, two_layer, coastal_wetdry
and shelf_forced, on meshes (2, 2) as two cards along y and along x, (2,
4) as 2, 4 and 8 cards and (4, 1) as 2 and 4, with tiles that divide no
block size.  Also: the grouping of a mesh's devices into cards and its
refusals, the tables against pad2d, K8's gather per card, the card layout's
round trip, and the route against beom_tpu's composed tier with one shard
per device."""

import dataclasses

import numpy as np
import pytest
import torch

from beom_tpu.parallel.dist import make_dist_stepper as j_make_dist_stepper
from beom_tpu.parallel.mesh import make_mesh as j_make_mesh
from beom_tpu.parallel.mesh import shard_state as j_shard_state

from beom_tpu_torch import entry
from beom_tpu_torch.parallel import halo
from beom_tpu_torch.parallel.mesh import (Card, Mesh, Sharded, card_classes,
                                          card_groups, device_type, gather,
                                          make_mesh, peer_pairs, shard)
from beom_tpu_torch.stencils import dist_band, fused_fb, fused_projection
from beom_tpu_torch.stencils.halo_pad import halo_pad_gather
from beom_tpu_torch.stepping import run_steps

from tests.test_torch_dist_band import CASES, _port_case

NY, NX = 48, 64
# tiles that divide no block size of any mesh below: blocks of 24 x 32,
# 24 x 16 and 12 x 64
TILE, TAIL_TILE, PHASE_TILE, SUB_TILE = (10, 7), (11, 5), (12, 5), (11, 5)
# mesh shape and the device of each shard: the cards are the shards of
# one device
CARDS = {
    "2x2 two along y": ((2, 2), ["a", "a", "b", "b"]),
    "2x2 two along x": ((2, 2), ["a", "b", "a", "b"]),
    "2x4 two": ((2, 4), ["a", "a", "b", "b"] * 2),
    "2x4 four": ((2, 4), ["a", "a", "b", "b", "c", "c", "d", "d"]),
    "2x4 eight": ((2, 4), list("abcdefgh")),
    "4x1 two": ((4, 1), ["a", "a", "b", "b"]),
    "4x1 four": ((4, 1), list("abcd")),
}
KERNELS = ("fb pass", "split route 2", "split route 3", "phases")
# each kernel on every placement, the cases in turn
ROUTES = [(kernel, name, list(CASES)[(k + j) % len(CASES)])
          for k, kernel in enumerate(KERNELS)
          for j, name in enumerate(CARDS)]


def _setup(case, name, **kw):
    _, (cfg, grid, forcing, st) = _port_case(case, nx=NX, ny=NY,
                                             **CASES[case], **kw)
    st = st.replace(t=cfg.npdtype.type(5 * cfg.dt))
    shape, devices = CARDS[name]
    mesh = make_mesh(*shape, devices=["cpu"])
    cards = card_groups(devices, *shape)
    f = [[dist_band.stack_card(a, mesh, c) for c in cards]
         for a in (st.h, st.u, st.v)]
    statics = [dist_band.stack_statics(grid, forcing, mesh, c)
               for c in cards]
    return cfg, grid, forcing, st, mesh, cards, f, statics


def _equal(label, outs, refs, mesh, cards):
    for i, (a, b) in enumerate(zip(outs, refs)):
        got = gather(dist_band.unstack_parts(a, mesh, cards))
        assert torch.equal(got, b), (label, i, float((got - b).abs().max()))


@pytest.mark.parametrize("kernel,name,case", ROUTES)
def test_card_launches_emulation_equals_single_device(kernel, name, case):
    """The launches over the cards' stacks, each card's tiles reading the
    neighbour cards' stacks through the classes of its tables: bit for bit
    the single-device plain step or phases."""
    scheme = {"fb pass": "fb", "phases": ("implicit_fs", "rigid_lid")[
        list(CARDS).index(name) % 2]}.get(kernel, "split")
    cfg, grid, forcing, st, mesh, cards, f, statics = _setup(
        case, name, scheme=scheme, **({"nsub": 4} if scheme == "split"
                                      else {}))
    label = f"{kernel} {case} {name}"
    if kernel == "fb pass":
        out = dist_band.fb_launch_tiled(*f, statics, 1, st.t, cfg, mesh, 2,
                                        TILE, cards=cards)
        ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, (grid, forcing),
                                           1, st.t, cfg, 2)
        _equal(label, out, ref, mesh, cards)
        return
    if kernel.startswith("split"):
        launch = dist_band.split_launch_tiled if kernel.endswith("2") \
            else dist_band.split3_launch_tiled
        out = launch(*f, statics, st.t, cfg, mesh, TILE,
                     TAIL_TILE if kernel.endswith("2") else SUB_TILE,
                     cards=cards)
        ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, (grid, forcing),
                                           0, st.t, cfg, 1)
        _equal(label, out, ref, mesh, cards)
        return
    dmask = fused_projection.derived_masks(grid)
    p = (st.h.sum(0) - grid.H) * grid.mask
    ps = [dist_band.stack_card(p, mesh, c) for c in cards]
    for n in (0, 1):
        a = dist_band.proj_a_launch_tiled(*f, statics, n, cfg, mesh,
                                          PHASE_TILE, dmask, cards=cards)
        ra = fused_projection.proj_a_plain(st.h, st.u, st.v, (grid, forcing),
                                           n, cfg)
        _equal(f"{label} A n={n}", a, ra, mesh, cards)
        b = dist_band.proj_b_launch_tiled(f[0], a[0], a[1], ps, statics,
                                          st.t, cfg, mesh, PHASE_TILE, dmask,
                                          cards=cards)
        rb = fused_projection.proj_b_plain(st.h, ra[0], ra[1], p,
                                           (grid, forcing), st.t, cfg)
        _equal(f"{label} B n={n}", b, rb, mesh, cards)


@pytest.mark.parametrize("name", ["2x4 two", "4x1 four"])
def test_single_step_phases_emulation_across_cards(name):
    """The single-step phases (each haloed point from the shard it falls
    into, on whichever card) at both parities: bit for bit the
    single-device plain phases."""
    cfg, grid, forcing, st, mesh, cards, f, statics = _setup(
        "two_layer", name, scheme="rigid_lid")
    p = (st.h.sum(0) - grid.H) * grid.mask
    ps = [dist_band.stack_card(p, mesh, c) for c in cards]
    tile = fused_fb._TILES[0]
    for n in (0, 1):
        a = dist_band.proj_a_launch_tiled(*f, statics, n, cfg, mesh, tile,
                                          False, staged=False, cards=cards)
        ra = fused_projection.proj_a_plain(st.h, st.u, st.v, (grid, forcing),
                                           n, cfg)
        _equal(f"{name} A n={n}", a, ra, mesh, cards)
        b = dist_band.proj_b_launch_tiled(f[0], a[0], a[1], ps, statics,
                                          st.t, cfg, mesh, tile, False,
                                          staged=False, cards=cards)
        rb = fused_projection.proj_b_plain(st.h, ra[0], ra[1], p,
                                           (grid, forcing), st.t, cfg)
        _equal(f"{name} B n={n}", b, rb, mesh, cards)


@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("name", list(CARDS))
def test_card_tables_are_pad2d_indices(name, w):
    """Each card's row and column tables with the nine bases, read at the
    padded block of each of its shards, give the points pad2d puts there:
    a field whose value is its own grid index, stacked per card, read
    through the tables, equals pad2d of the sharded field."""
    shape, devices = CARDS[name]
    mesh = make_mesh(*shape, devices=["cpu"])
    cards = card_groups(devices, *shape)
    classes = card_classes(cards)
    ncards = (1 + max(c.place[0] for c in cards),
              1 + max(c.place[1] for c in cards))
    ny, nx = 24, 40
    ly, lx = ny // shape[0], nx // shape[1]
    index = torch.arange(ny * nx, dtype=torch.float64).reshape(ny, nx)
    parts = [dist_band.stack_card(index, mesh, c).reshape(-1) for c in cards]
    padded = halo.pad2d(shard(index, mesh), w)
    for c, card in enumerate(cards):
        bases = torch.stack([parts[k] for k in classes[c]])
        for s in card.shards:
            j, i = divmod(s, shape[1])
            gy = (j * ly - w + torch.arange(ly + 2 * w)) % ny
            gx = (i * lx - w + torch.arange(lx + 2 * w)) % nx
            rc, roff, cc, coff = dist_band.card_offsets(gy, gx, ly, lx, card,
                                                        ncards)
            assert int(roff.max()) < ly * lx * len(card.shards)
            got = bases[3 * rc[:, None] + cc[None, :],
                        roff[:, None] + coff[None, :]]
            assert torch.equal(got, padded.blocks[s]), (name, s)
            assert torch.equal(got, index[gy][:, gx]), (name, s)


def test_one_card_tables_are_the_stacked_layout():
    """One card: every class is the card itself (class 0) and the terms
    are the one-card stacked layout's (stack_offsets)."""
    mesh = make_mesh(2, 4, devices=["cpu"])
    card = dist_band.whole_card(mesh)
    gy, gx = torch.arange(48), torch.arange(64)
    rc, roff, cc, coff = dist_band.card_offsets(gy, gx, 24, 16, card, (1, 1))
    want = dist_band.stack_offsets(gy, gx, 24, 16, 4)
    assert not rc.any() and not cc.any()
    assert torch.equal(roff, want[0]) and torch.equal(coff, want[1])


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("name", list(CARDS))
def test_halo_pad_gather_per_card_equals_pad2d(name, w, lead):
    """K8's index arithmetic per card (one launch per card, the card's
    shards on its z blocks, each output point from its source shard on
    whichever card), into one allocation per card: pad2d bit for bit."""
    shape, devices = CARDS[name]
    mesh = make_mesh(*shape, devices=["cpu"])
    cards = card_groups(devices, *shape)
    g = torch.Generator().manual_seed(3)
    a = shard(torch.randn(lead + (24, 40), generator=g,
                          dtype=torch.float64), mesh)
    got = halo_pad_gather(a, w, cards)
    ref = halo.pad2d(a, w)
    for card in cards:
        stores = {got.blocks[s].untyped_storage().data_ptr()
                  for s in card.shards}
        assert len(stores) == 1
    for x, y in zip(got.blocks, ref.blocks):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mesh_shape,devices,want", [
    ((2, 4), ["a"] * 8, [((0, 0), (2, 4), (0, 0))]),
    ((2, 4), ["a"] * 4 + ["b"] * 4,
     [((0, 0), (1, 4), (0, 0)), ((1, 0), (1, 4), (1, 0))]),
    ((2, 4), ["a", "a", "b", "b"] * 2,
     [((0, 0), (2, 2), (0, 0)), ((0, 2), (2, 2), (0, 1))]),
    ((2, 4), ["d", "c", "b", "a", "h", "g", "f", "e"],
     [((0, i), (1, 1), (0, i)) for i in range(4)]
     + [((1, i), (1, 1), (1, i)) for i in range(4)]),
    ((4, 1), ["a", "b", "c", "d"],
     [((j, 0), (1, 1), (j, 0)) for j in range(4)]),
])
def test_card_groups_are_equal_rectangles(mesh_shape, devices, want):
    """A mesh's cards: the shards of each device, a rectangle of the mesh,
    in the row-major order of the grid of cards, with each card's nine
    classes wrapping periodically (a mesh axis of one card points at the
    card itself)."""
    cards = card_groups(devices, *mesh_shape)
    assert [(c.origin, c.shape, c.place) for c in cards] == want
    for c in cards:
        assert [devices[s] for s in c.shards] == [c.device] * len(c.shards)
    cy = 1 + max(c.place[0] for c in cards)
    cx = 1 + max(c.place[1] for c in cards)
    for c, nbs in zip(cards, card_classes(cards)):
        assert nbs[0] == cards.index(c)
        a, b = c.place
        assert cards[nbs[3]].place == ((a + 1) % cy, b)
        assert cards[nbs[6]].place == ((a - 1) % cy, b)
        assert cards[nbs[1]].place == (a, (b + 1) % cx)
        assert cards[nbs[2]].place == (a, (b - 1) % cx)
        assert cards[nbs[8]].place == ((a - 1) % cy, (b - 1) % cx)


@pytest.mark.parametrize("devices,match", [
    (["a", "b"] * 4, "not a rectangle"),
    (["a"] * 6 + ["b"] * 2, "not a rectangle"),
    (["a"] * 4 + ["b", "b", "c", "c"], "different shapes"),
    (["a"] * 7, "7 devices"),
])
def test_card_groups_refuse_unequal_placements(devices, match):
    """A placement whose devices do not hold equal rectangles raises
    ValueError and names the devices."""
    with pytest.raises(ValueError, match=match) as err:
        card_groups(devices, 2, 4)
    if match != "7 devices":
        assert "a" in str(err.value)


def test_mixed_meshes_and_peers():
    """A mesh that mixes CPU and CUDA shards raises ValueError; the peer
    pairs are the neighbour cards on other devices, each pair once."""
    mixed = Mesh(["cpu", "cpu", torch.device("cuda", 0),
                  torch.device("cuda", 0)], 2, 2)
    with pytest.raises(ValueError, match="mixes"):
        device_type(mixed)
    assert device_type(make_mesh(2, 2, devices=["cpu"])) == "cpu"
    two = card_groups(["a", "a", "b", "b"], 2, 2)
    assert peer_pairs(two) == [("a", "b"), ("b", "a")]
    assert peer_pairs(card_groups(["a"] * 4, 2, 2)) == []
    eight = card_groups(list("abcdefgh"), 2, 4)
    pairs = peer_pairs(eight)
    # a at (0, 0) of the 2 x 4 grid of cards reads b, d, e, f and h
    assert sorted(y for x, y in pairs if x == "a") == list("bdefh")
    assert len(pairs) == len(set(pairs)) == 8 * 5


def test_route_refuses_cards_that_are_not_the_mesh():
    """The route's internal cards must cover the mesh, each shard once, in
    rectangles of one shape on their shards' devices."""
    mesh = make_mesh(2, 2, devices=["cpu"])
    good = card_groups(["cpu"] * 2 + ["cpu"] * 2, 2, 2)
    assert dist_band._cards_of(mesh, good) == good
    halves = [Card("cpu", (0, 1), (0, 0), (1, 2), (0, 0)),
              Card("cpu", (2, 3), (1, 0), (1, 2), (1, 0))]
    assert dist_band._cards_of(mesh, halves) == halves
    with pytest.raises(ValueError, match="each of the mesh's"):
        dist_band._cards_of(mesh, halves[:1])
    with pytest.raises(ValueError, match="not a rectangle"):
        dist_band._cards_of(mesh, [
            Card("cpu", (0, 3), (0, 0), (1, 2), (0, 0)),
            Card("cpu", (1, 2), (1, 0), (1, 2), (1, 0))])
    with pytest.raises(ValueError, match="another device"):
        dist_band._cards_of(mesh, [
            Card("cpu", (0, 1), (0, 0), (1, 2), (0, 0)),
            Card(torch.device("cuda", 0), (2, 3), (1, 0), (1, 2), (1, 0))])


@pytest.mark.parametrize("lead", [(), (2,)])
def test_card_layout_round_trips(lead):
    """stack_part of a card's shards returns the part its blocks are views
    of, without a copy; unstack_parts gives views whose gather is the
    field; one card's part is the one-card stack."""
    mesh = make_mesh(2, 4, devices=["cpu"])
    cards = card_groups(["a", "a", "b", "b"] * 2, 2, 4)
    a = torch.randn(lead + (16, 32), dtype=torch.float64)
    parts = [dist_band.stack_card(a, mesh, c) for c in cards]
    assert parts[0].shape == lead + (4, 8, 8)
    sh = dist_band.unstack_parts(parts, mesh, cards)
    assert isinstance(sh, Sharded) and torch.equal(gather(sh), a)
    for part, c in zip(parts, cards):
        again = dist_band.stack_part(sh, c.shards)
        assert again.data_ptr() == part.data_ptr()
        copied = dist_band.stack_part(shard(a, mesh), c.shards)
        assert copied.data_ptr() != part.data_ptr()
        assert torch.equal(copied, part)
    assert torch.equal(dist_band.stack_card(a, mesh,
                                            dist_band.whole_card(mesh)),
                       dist_band.stack_global(a, mesh))
    with pytest.raises(ValueError, match="4 shards"):
        dist_band.unstack_parts([parts[0], parts[0][..., :2, :, :]], mesh,
                                cards)


@pytest.mark.parametrize("my,mx,n_cards,want", [
    (2, 4, 1, (1, 1)), (2, 4, 2, (1, 2)), (2, 4, 3, (1, 2)),
    (2, 4, 8, (2, 4)), (2, 4, 16, (2, 4)), (4, 1, 2, (2, 1)),
    (1, 8, 4, (1, 4)),
])
def test_dryrun_placement_spreads_shards_over_cards(my, mx, n_cards, want):
    """entry.dryrun_multichip's placement: the most cards that cut the
    mesh into equal rectangles, each card one rectangle; one card holds
    every shard, as before."""
    assert entry.card_grid(my, mx, n_cards) == want
    labels = [f"cuda:{i}" for i in range(n_cards)]
    devices = entry.card_placement(my, mx, labels)
    cards = card_groups(devices, my, mx)
    assert len(cards) == want[0] * want[1]
    assert {c.shape for c in cards} == {(my // want[0], mx // want[1])}
    if n_cards == 1:
        assert devices == ["cuda:0"] * (my * mx)


def test_card_route_matches_composed_tier_one_shard_per_device():
    """The fb path over eight cards of one shard each (the route's
    launches of the pass kernel, two steps each, emulated on the host)
    against beom_tpu's composed tier on its eight CPU devices, one shard
    per device (make_dist_pallas_stepper in interpret mode), at the size
    and tolerance of tests/dist/test_pallas_dist.py's 2-D mesh; and bit
    for bit the single-device plain steps."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = _port_case(
        "double_gyre", nx=128, ny=96, backend="pallas", steps_per_pass=2)
    n = 6
    jmesh = j_make_mesh(2, 4)
    jout = j_make_dist_stepper(jgrid, jforcing, jcfg, jmesh, n_inner=n // 2)(
        j_shard_state(jst, jmesh))
    mesh = make_mesh(2, 4, devices=["cpu"])
    cards = card_groups(list("abcdefgh"), 2, 4)
    f = [[dist_band.stack_card(a, mesh, c) for c in cards]
         for a in (st.h, st.u, st.v)]
    statics = [dist_band.stack_statics(grid, forcing, mesh, c)
               for c in cards]
    t = st.t
    for k in range(0, n, 2):
        f = dist_band.fb_launch_tiled(*f, statics, k, t, cfg, mesh, 2,
                                      (16, 16), cards=cards)
        t = fused_fb._times(t, cfg, 2)[-1]
    ref = run_steps(st, grid, forcing, dataclasses.replace(
        cfg, steps_per_pass=1), n)
    assert int(jout.n) == n
    for name, part in zip("huv", f):
        got = gather(dist_band.unstack_parts(part, mesh, cards)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jout, name)),
                                   rtol=0, atol=1e-11,
                                   err_msg=f"{name}: vs beom_tpu")
        np.testing.assert_array_equal(got, getattr(ref, name).numpy(),
                                      err_msg=f"{name}: 1 vs 8 cards")
    assert float(ref.u.abs().max()) > 0


@pytest.mark.parametrize("scheme", ["fb", "split", "rigid_lid",
                                    "implicit_fs"])
def test_fused_mesh_over_cards_takes_the_card_route(scheme, monkeypatch):
    """make_dist_stepper with backend='fused' on a mesh of two CUDA devices
    in equal rectangles, and K8 on it, take the route over cards (no
    NotImplementedError): where the two cannot read each other's memory
    they raise RuntimeError naming the pair, before anything is built; a
    mesh that mixes CPU and CUDA shards raises ValueError."""
    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.parallel.dist import make_dist_stepper
    from beom_tpu_torch.stencils import halo_pad

    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    cfg, grid, forcing, _ = make_case("double_gyre", nx=32, ny=32,
                                      device="cpu", backend="fused",
                                      scheme=scheme, mesh_y=2, mesh_x=2)
    cuda = [torch.device("cuda", i) for i in range(2)]
    mesh = Mesh([cuda[0], cuda[0], cuda[1], cuda[1]], 2, 2)
    with pytest.raises(RuntimeError, match="cuda:0 cannot read the memory "
                       "of cuda:1"):
        make_dist_stepper(grid, forcing, cfg, mesh)
    a = shard(torch.zeros(32, 32), make_mesh(2, 2, devices=["cpu"]))
    a.mesh = mesh
    with pytest.raises(RuntimeError, match="no peer access"):
        halo_pad.halo_pad(a, 1)
    mixed = Mesh(["cpu", "cpu", cuda[0], cuda[0]], 2, 2)
    with pytest.raises(ValueError, match="mixes"):
        make_dist_stepper(grid, forcing, cfg, mixed)
