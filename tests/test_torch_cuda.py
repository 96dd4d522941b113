"""The CUDA kernel K1 against its plain PyTorch version, on the card.

Skips where torch.cuda.is_available() is false.  It imports no jax, so
on a machine with a card and no jax it runs without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from beom_tpu_torch.cases import make_case
from beom_tpu_torch.stencils import fused_fb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda")


def _perturbed(device, seed, **kw):
    """The double gyre plus a seeded perturbation of h, u and v."""
    cfg, grid, forcing, st = make_case("double_gyre", device=device, **kw)
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
