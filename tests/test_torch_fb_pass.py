"""K1's pass of kb fb steps per launch, on the CPU: the host emulation of
its blocked schedule (fused_fb.fused_fb_step_tiled: blocks with a halo of
kb W, kb eager steps on each as a grid of its own, the interiors joined)
bit for bit against the plain step on every case, which pins the width W
of every term's dependence cone; and the launch plan.  The kernel itself
meets kb single-step launches bit for bit on the card
(tests/test_torch_cuda.py::test_fb_pass_equals_single_steps)."""

import numpy as np
import pytest
import torch

from beom_tpu_torch.cases import make_case
from beom_tpu_torch.stencils import fused_fb

# every term: dry cells (coastal_wetdry), open faces, tides, sponge, nu4
# and interfacial drag (shelf_forced)
CASE_KW = {
    "double_gyre": {},
    "two_layer": {},
    "coastal_wetdry": {},
    "shelf_forced": dict(nu4=1e6, r_int=1e-4),
}


def _perturbed(name, nx, ny, dtype="float64", seed=7):
    """The case plus a seeded perturbation of h, u and v, at t = 7 dt (the
    tide is on)."""
    cfg, grid, forcing, st = make_case(name, nx=nx, ny=ny, device="cpu",
                                       dtype=dtype, **CASE_KW[name])
    rng = np.random.default_rng(seed)

    def noise(amp, m):
        a = amp * rng.standard_normal((cfg.nz, ny, nx))
        return torch.tensor(a.astype(cfg.npdtype)) * m

    st = st.replace(h=st.h + noise(0.5, grid.mask),
                    u=st.u + noise(0.05, grid.mask_u),
                    v=st.v + noise(0.05, grid.mask_v),
                    t=cfg.npdtype.type(7 * cfg.dt))
    if cfg.wetdry:      # dry cells: h = 0 in about one wet cell in seven
        dry = torch.tensor(rng.random((cfg.nz, ny, nx)) < 0.15)
        st = st.replace(h=torch.where(dry, torch.zeros_like(st.h), st.h))
        assert bool(((st.h < cfg.h_dry) & (grid.mask > 0)).any())
    if cfg.obc:
        assert bool((forcing.obc_v != 0).any())
    return cfg, (grid, forcing), st


@pytest.mark.parametrize("nx,ny", [(37, 29), (40, 24)])
@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("kb", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(CASE_KW))
def test_tiled_schedule_equals_plain(name, kb, n, nx, ny):
    """A 4-step pass at kb steps per launch (kb = 3: launches of 3 and 1)
    on 16 x 8 tiles, which divide neither size: bit for bit the plain
    step at f64."""
    cfg, statics, st = _perturbed(name, nx, ny)
    args = (st.h, st.u, st.v, statics, n, st.t, cfg, 4)
    out = fused_fb.fused_fb_step_tiled(*args, kb=kb, tile=(16, 8))
    ref = fused_fb.fused_fb_step_plain(*args)
    for f, a, b in zip("huv", out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)


def test_tiled_schedule_takes_the_plan():
    """Without overrides the emulation runs the plan's launches at their
    tiles: the f32 gyre's kb = 2 pass on 48 x 40 tiles at 100 x 90."""
    cfg, statics, st = _perturbed("double_gyre", 100, 90, "float32")
    assert fused_fb.plan(cfg, torch.float32, 4).launches(4) == [2, 2]
    args = (st.h, st.u, st.v, statics, 0, st.t, cfg, 4)
    out = fused_fb.fused_fb_step_tiled(*args)
    for a, b in zip(out, fused_fb.fused_fb_step_plain(*args)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_main_path_plan():
    """The main path (2048^2 f32 double gyre, steps_per_pass = 4): the
    pass kernel, two launches per pass of 4 steps (PERF.md: kb = 4 fits a
    CTA only on tiles whose halo doubles the stage work)."""
    cfg = make_case("double_gyre", nx=2048, ny=2048, device="cpu",
                    steps_per_pass=4)[0]
    pl = fused_fb.plan(cfg, torch.float32)
    assert pl.kb == 2 and pl.launches(4) == [2, 2]
    assert pl.threads == 1024 and pl.smem <= fused_fb._MAX_SMEM
    name, defines = fused_fb.build_spec(cfg, torch.float32, 2)
    assert name == "fb_step" and "BEOM_KB=2" in defines
    assert f"BEOM_TX={pl.tile[0]}" in defines


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(CASE_KW))
def test_plans_fit_a_cta(name, dtype):
    """Every case's plan at both types: its CTA within 232,448 bytes, the
    pass kernel's bytes as pass_smem counts them, the single-step kernel
    where no block with kb > 1 fits (the shelf with every term at f64)."""
    cfg = make_case(name, nx=2048, ny=2048, device="cpu", dtype=dtype,
                    **CASE_KW[name])[0]
    elem = 4 if dtype == "float32" else 8
    for k in (1, 2, 4):
        pl = fused_fb.plan(cfg, cfg.tdtype, k)
        assert pl.smem <= 232448
        assert sum(pl.launches(k)) == k and pl.kb <= k
        if pl.kb > 1:
            assert pl.smem == fused_fb.pass_smem(cfg, pl.kb, pl.tile, elem)
    if name == "shelf_forced" and dtype == "float64":
        assert fused_fb.launch_plan(cfg, cfg.tdtype, 2) is None
        assert fused_fb.plan(cfg, cfg.tdtype, 4).launches(4) == [1] * 4
        with pytest.raises(ValueError, match="fits"):
            fused_fb.build_spec(cfg, cfg.tdtype, 2)


@pytest.mark.parametrize("k,kb,steps", [
    (4, 3, [3, 1]), (6, 3, [3, 3]), (2, 2, [2]), (3, 1, [1, 1, 1]),
    (4, 4, [4])])
def test_launches_of_a_pass(k, kb, steps):
    assert fused_fb.launch_steps(k, kb) == steps
    assert fused_fb.Plan(kb, (32, 32), 1024, 0).launches(k) == steps
