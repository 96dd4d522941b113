"""The Munk layer's width on the port's eager backend at f64 on the CPU:
the twin of tests/physics/test_analytic.py::test_munk_layer_width_scaling
with its tolerances and step counts (2 x 30,000 steps at 128^2), in a
file of its own so that a run across workers gives it one of its own."""

import numpy as np
import pytest

from beom_tpu_torch.cases import make_case
from beom_tpu_torch.stepping import run_steps

from tests.torch_parity import one_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _munk_jet_width(nu2, nx=128, n_steps=30000):
    """Distance from the west wall to the first sign change of v past
    the boundary-jet maximum, at mid-latitude (steady Munk gyre)."""
    cfg, grid, forcing, state = make_case(
        "double_gyre", nx=nx, ny=nx, dtype="float64", adv_scheme="linear",
        r_bot=0.0, nu2=nu2, beta=2e-11, device="cpu")
    out = run_steps(state, grid, forcing, cfg, n_steps)
    v = out.v.numpy()[0]
    prof = v[nx // 4, :]                 # subtropical-gyre latitude
    i_max = int(np.argmax(np.abs(prof[1:nx // 2]))) + 1
    sgn = np.sign(prof[i_max])
    i = i_max
    while i < nx - 1 and np.sign(prof[i]) == sgn:
        i += 1
    return i * cfg.dx, cfg.dx


def test_munk_layer_width_scaling():
    """Munk viscous boundary layer: width ~ (nu/beta)^{1/3}.  8x the
    viscosity must double the measured jet width."""
    w1, dx = _munk_jet_width(4000.0)
    w2, _ = _munk_jet_width(32000.0)
    # predicted zero crossing of the Munk profile: x = 4*pi/(3*sqrt(3))
    # * delta_M with delta_M = (nu/beta)^{1/3}
    for w, nu in ((w1, 4000.0), (w2, 32000.0)):
        dm = (nu / 2e-11) ** (1.0 / 3.0)
        pred = 4.0 * np.pi / (3.0 * np.sqrt(3.0)) * dm
        assert abs(w - pred) < max(0.45 * pred, 2.0 * dx), \
            f"nu={nu}: width {w / 1e3:.0f} km vs Munk {pred / 1e3:.0f} km"
    assert 1.4 < w2 / w1 < 2.9, f"width ratio {w2 / w1:.2f}, expected ~2"
