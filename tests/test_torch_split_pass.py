"""K1s's two-launch split step, on the CPU: the host emulation of the tail's
blocked schedule (fused_fb.split_step_tiled: the slow phase on the whole
grid, then on blocks with a halo of nsub + LO + E the subcycle, the
recomposition and fb.finalize as on a grid of their own, the interiors
joined) bit for bit against the plain split step on every case, which pins
the halo; the tail's rebuild of SlowPhase from h, u, v and the layer
tendencies; and the split plan.  The kernels themselves meet the plain step
and the three-kernel route bit for bit on the card
(tests/test_torch_cuda.py::test_split_two_launches_match_plain_and_three)."""

import dataclasses

import numpy as np
import pytest
import torch

from beom_tpu_torch.cases import make_case
from beom_tpu_torch.core.state import State
from beom_tpu_torch.stencils import fused_fb
from beom_tpu_torch.stepping import split

from tests.test_torch_fb_pass import CASE_KW, _perturbed


def _split_case(name, nsub, dtype="float64", nx=37, ny=29):
    cfg, statics, st = _perturbed(name, nx, ny, dtype)
    return dataclasses.replace(cfg, scheme="split", nsub=nsub), statics, st


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nsub", [4, 8])
@pytest.mark.parametrize("name", list(CASE_KW))
def test_tiled_tail_equals_plain(name, nsub, dtype):
    """Two split steps on 12 x 8 tiles of a 37 x 29 grid, which divide
    neither size: bit for bit the plain split step (nz 1 and 2, dry cells,
    open faces with the tide, sponge, nu4, interfacial and quadratic
    drag)."""
    cfg, statics, st = _split_case(name, nsub, dtype)
    args = (st.h, st.u, st.v, statics, 0, st.t, cfg, 2)
    out = fused_fb.split_step_tiled(*args, tile=(12, 8))
    ref = fused_fb.fused_fb_step_plain(*args)
    for f, a, b in zip("huv", out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)


@pytest.mark.parametrize("name", list(CASE_KW))
def test_narrower_halo_differs(name):
    """The tail's halo is nsub + LO + E (LO = 2 under wet/dry, else 1; E =
    1 under wet/dry and the open boundary, where fb.finalize reads h1 one
    point east and north).  Without wet/dry a halo one narrower lets the
    NaN past each block into the result: the width is pinned.  Under
    wet/dry the block's data need at most nsub + LO, and the ring E is the
    kernel's own: its continuity fills a region symmetric about the tile,
    and finalize reads one point past it.  (The limiter's comparisons stop
    a NaN there, so the emulation cannot pin those widths; the card holds
    the kernel to the plain step on those cases.)"""
    cfg, statics, st = _split_case(name, 4)
    args = (st.h, st.u, st.v, statics, 0, st.t, cfg, 1)
    halo = fused_fb.tail_halo(cfg)
    lo = 2 if cfg.wetdry else 1
    assert halo == 4 + lo + int(cfg.wetdry or cfg.obc)
    ref = fused_fb.fused_fb_step_plain(*args)
    for hw in (halo, 4 + lo):
        out = fused_fb.split_step_tiled(*args, tile=(12, 8), halo=hw)
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), hw
    if not cfg.wetdry:
        out = fused_fb.split_step_tiled(*args, tile=(12, 8), halo=halo - 1)
        assert bool(torch.isnan(out[0]).any())


@pytest.mark.parametrize("name", list(CASE_KW))
def test_rebuild_from_tendencies(name):
    """What the tail rebuilds at a point from h, u, v and the layer
    tendencies of the slow phase reaches one point and no further (h east
    and north; u, v around it for the quadratic drag): SlowPhase rebuilt on
    a block is the stored SlowPhase one ring inside it, bit for bit; and
    the tail's plain version from the tendencies is the split step."""
    cfg, (grid, forcing), st = _split_case(name, 8)
    du_s, dv_s = split.slow_tendencies(st, grid, forcing, cfg)
    sp = split.slow_phase(st, grid, forcing, cfg)
    rows, cols = torch.arange(5, 18), torch.arange(3, 20)
    cut = lambda a: fused_fb._cut(a, rows, cols)
    g = type(grid)(**{f.name: cut(getattr(grid, f.name))
                      for f in dataclasses.fields(grid)})
    sub = dataclasses.replace(cfg, ny=len(rows), nx=len(cols))
    block = split.depth_means(
        State(h=cut(st.h), u=cut(st.u), v=cut(st.v), t=st.t, n=0),
        cut(du_s), cut(dv_s), g, sub)
    for f, a, b in zip(sp._fields, block, sp):
        np.testing.assert_array_equal(a[..., 1:-1, 1:-1].numpy(),
                                      cut(b)[..., 1:-1, 1:-1].numpy(),
                                      err_msg=f)
    out = fused_fb.split_tail((du_s, dv_s), st.h, st.u, st.v,
                              (grid, forcing), st.t, cfg)
    tend = fused_fb.split_tend(st.h, st.u, st.v, (grid, forcing), cfg)
    ref = split.split_step(st, grid, forcing, cfg)
    for a, b in zip(tend, (du_s, dv_s)):
        assert torch.equal(a, b)
    for a, b in zip(out, (ref.h, ref.u, ref.v)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nsub", [4, 8, 12])
@pytest.mark.parametrize("name", list(CASE_KW))
def test_split_plan_fits(name, nsub, dtype):
    """Every case's split plan at 2048^2: the tail's geometry builds (whole
    warps per row, at most 1024 threads, a tile of at least 8 rows), its
    CTA fits 232,448 bytes and its registers, and the library is built
    with it; a route-2 plan launches twice per step."""
    cfg = make_case(name, nx=2048, ny=2048, device="cpu", dtype=dtype,
                    scheme="split", nsub=nsub, **CASE_KW[name])[0]
    pl = fused_fb.split_plan(cfg, cfg.tdtype)
    assert pl.halo == fused_fb.tail_halo(cfg)
    defines = dict(d.split("=") for d in fused_fb.build_spec(cfg)[1])
    assert (int(defines["BEOM_QX"]), int(defines["BEOM_QS"]),
            int(defines["BEOM_QP"])) == pl.tail
    assert pl.threads <= 1024 and pl.qy >= 1
    if pl.route == 2:
        assert pl.launches() == 2
        assert pl.tail in fused_fb.tail_geometries(cfg, cfg.tdtype)
        assert pl.rx % 32 == 0 and 512 <= pl.threads
        assert pl.qy >= 8 and pl.smem <= 232448
        assert pl.smem == fused_fb.tail_smem(cfg, pl.tail,
                                             4 if dtype == "float32" else 8)
    else:
        assert pl.launches() == 3


def test_main_split_path_takes_two_launches():
    """The 2048^2 f32 double gyre at nsub 8 takes the two-launch route."""
    cfg = make_case("double_gyre", nx=2048, ny=2048, device="cpu",
                    scheme="split", nsub=8)[0]
    pl = fused_fb.split_plan(cfg, torch.float32)
    assert pl.route == 2 and pl.launches() == 2
    assert "route 2" in pl.describe()


def test_tiled_tail_takes_the_plan():
    """Without overrides the emulation cuts the plan's tiles: the f32 gyre
    at nsub 4 on a 100 x 90 grid."""
    cfg, statics, st = _split_case("double_gyre", 4, "float32", 100, 90)
    pl = fused_fb.split_plan(cfg, torch.float32)
    assert pl.route == 2
    args = (st.h, st.u, st.v, statics, 0, st.t, cfg, 1)
    for a, b in zip(fused_fb.split_step_tiled(*args),
                    fused_fb.fused_fb_step_plain(*args)):
        assert torch.equal(a, b)
