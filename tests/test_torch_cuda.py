"""The CUDA kernels against their plain PyTorch versions, on the card:
K1 (fused fb step), K3a/K3b (projection phases), K4a (blocked red-black
sweep) and K6 (fused Jacobi CG).

Skips where torch.cuda.is_available() is false.  It imports no jax, so
on a machine with a card and no jax it runs without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from beom_tpu_torch.cases import make_case
from beom_tpu_torch.solvers import elliptic
from beom_tpu_torch.stencils import (cg_fused, fused_fb, fused_projection,
                                     redblack)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda")


def _perturbed(device, seed, case="double_gyre", **kw):
    """A case plus a seeded perturbation of h, u and v."""
    cfg, grid, forcing, st = make_case(case, device=device, **kw)
    rng = np.random.default_rng(seed)

    def noise(amp, m):
        a = amp * rng.standard_normal((cfg.nz, cfg.ny, cfg.nx))
        return torch.tensor(a.astype(cfg.npdtype), device=device) * m

    st = st.replace(h=st.h + noise(0.5, grid.mask),
                    u=st.u + noise(0.05, grid.mask_u),
                    v=st.v + noise(0.05, grid.mask_v))
    return cfg, grid, forcing, st


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n_steps,rel,variant", [
    ("float64", 20, 1e-12, {}),
    ("float64", 20, 1e-12, dict(adv_scheme="linear", slip="no")),
    ("float32", 1, 4 * 2.0 ** -23, {}),
])
def test_kernel_matches_plain(cuda, dtype, n_steps, rel, variant):
    """200x136: sizes that are not multiples of the tile, so the ragged
    tiles and the wrap on both axes are exercised.  The f32 bound is
    4 ulp of each field's scale."""
    cfg, grid, forcing, st = _perturbed(cuda, 8, nx=200, ny=136,
                                        dtype=dtype)
    cfg = dataclasses.replace(cfg, **variant)
    args = (st.h, st.u, st.v, (grid, forcing), st.n, st.t, cfg, n_steps)
    before = fused_fb.LAUNCHES
    out = fused_fb.fused_fb_step(*args)
    torch.cuda.synchronize()
    assert fused_fb.LAUNCHES == before + n_steps
    ref = fused_fb.fused_fb_step_plain(*args)
    for f, a, b in zip("huv", out, ref):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= rel * scale, (f, err, scale)


@pytest.mark.cuda
def test_kernel_refuses_unsupported_term(cuda):
    cfg, grid, forcing, st = _perturbed(cuda, 9, nx=64, ny=48)
    cfg = dataclasses.replace(cfg, cd_bot=2.5e-3)
    with pytest.raises(NotImplementedError, match="cd_bot"):
        fused_fb.fused_fb_step(st.h, st.u, st.v, (grid, forcing), st.n,
                               st.t, cfg, 1)


def _max_err(out, ref):
    return max(float((a - b).abs().max()) for a, b in zip(out, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("scheme", ["rigid_lid", "implicit_fs"])
def test_projection_phases_match_plain(cuda, scheme, n):
    """K3a and K3b on a 200x136 f64 grid: bit for bit."""
    cfg, grid, forcing, st = _perturbed(cuda, 10, "rigid_lid", nx=200,
                                        ny=136, dtype="float64",
                                        scheme=scheme, precond="jacobi")
    statics = (grid, forcing)
    before = dict(fused_projection.LAUNCHES)
    a = fused_projection.proj_a(st.h, st.u, st.v, statics, n, cfg)
    a_ref = fused_projection.proj_a_plain(st.h, st.u, st.v, statics, n, cfg)
    p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=cuda) \
        * grid.mask
    b = fused_projection.proj_b(st.h, a_ref[0], a_ref[1], p, statics, st.t,
                                cfg)
    b_ref = fused_projection.proj_b_plain(st.h, a_ref[0], a_ref[1], p,
                                          statics, st.t, cfg)
    torch.cuda.synchronize()
    assert fused_projection.LAUNCHES == {
        k: v + 1 for k, v in before.items()}
    assert _max_err(a, a_ref) == 0.0 and _max_err(b, b_ref) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lam", [0.0, 1e-9])
def test_rb_sweep_matches_plain(cuda, lam, reverse):
    """One k = 8 pass on a 200x136 f64 grid: bit for bit."""
    cfg, grid, _, st = _perturbed(cuda, 11, "rigid_lid", nx=200, ny=136,
                                  dtype="float64")
    Hu, Hv = elliptic.face_depths(grid)
    b = st.h[0] - grid.H
    x = torch.randn_like(b) * grid.mask
    kw = dict(lam=lam, k=8, omega=cfg.sor_omega, reverse=reverse)
    before = redblack.LAUNCHES
    out = redblack.rb_sweep(x, b, Hu, Hv, grid.mask, cfg.dx, cfg.dy, **kw)
    torch.cuda.synchronize()
    assert redblack.LAUNCHES == before + 1
    ref = redblack.rb_sweep_plain(x, b, Hu, Hv, grid.mask, cfg.dx, cfg.dy,
                                  **kw)
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_cg_fused_matches_plain(cuda, kind):
    """The kernel's solve at 200x136 f64: x within 1e-6 x scale of the
    plain CG, the iteration counts within 2, two launches bitwise
    equal."""
    cfg, grid, _, st = _perturbed(cuda, 12, "rigid_lid", nx=200, ny=136,
                                  dtype="float64", solver_maxiter=5000)
    lam = 0.0 if kind == "neumann" else 1.0 / (cfg.g * cfg.dt ** 2)
    b = (st.h[0] - grid.H) * grid.mask
    solve = cg_fused.make_cg_solve(grid, cfg, lam=lam, precond="jacobi")
    before = cg_fused.LAUNCHES
    res, res2 = solve(b), solve(b)
    assert cg_fused.LAUNCHES == before + 2
    ref = cg_fused.cg_solve_plain(b, grid, cfg, lam=lam)
    assert torch.equal(res.x, res2.x)
    assert abs(res.iters - ref.iters) <= 2
    scale = float(ref.x.abs().max())
    assert float((res.x - ref.x).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_projection_kernels_refuse_unsupported_term(cuda):
    cfg, grid, forcing, st = _perturbed(cuda, 13, "rigid_lid", nx=64, ny=48,
                                        precond="jacobi", cd_bot=2.5e-3)
    with pytest.raises(NotImplementedError, match="cd_bot"):
        fused_projection.proj_a(st.h, st.u, st.v, (grid, forcing), 0, cfg)
