"""K1, the fused fb step: its plain PyTorch version against beom_tpu's
Pallas kernel, run as tests/unit/test_pallas.py runs it (interpret mode,
by=48) on the 128x96 double gyre at f64, and the wrapper's routing on CPU
tensors.  The CUDA kernel itself is held against the plain version on
the card by tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import numpy as np
import pytest

from beom_tpu.stencils.fused_fb import make_pallas_stepper

from beom_tpu_torch.stencils import fused_fb
from beom_tpu_torch.stepping import make_stepper

from tests.torch_parity import perturbed_case


@pytest.mark.parametrize("k", [1, 2])
def test_plain_matches_pallas_interpret(k):
    """3 calls of k steps each: 1e-12 x max(scale, 1), as
    tests/unit/test_pallas.py bounds the Pallas kernel."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = perturbed_case(
        nx=128, ny=96, dtype="float64", seed=4)
    jstep = make_pallas_stepper(jgrid, jforcing, jcfg, by=48,
                                interpret=True, steps_per_pass=k)
    statics = (grid, forcing)
    h, u, v, n, t = st.h, st.u, st.v, st.n, st.t
    for _ in range(3):
        jst = jstep(jst)
        h, u, v = fused_fb.fused_fb_step_plain(h, u, v, statics, n, t, cfg,
                                               k)
        n += k
    assert int(jst.n) == n == 3 * k
    for f, out in zip("huv", (h, u, v)):
        ref = np.asarray(getattr(jst, f))
        scale = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-12 * scale, err_msg=f)


def test_wrapper_takes_plain_version_on_cpu():
    _, (cfg, grid, forcing, st) = perturbed_case(nx=40, ny=24,
                                                 dtype="float64", seed=5)
    before = fused_fb.LAUNCHES
    args = (st.h, st.u, st.v, (grid, forcing), st.n, st.t, cfg, 3)
    out = fused_fb.fused_fb_step(*args)
    ref = fused_fb.fused_fb_step_plain(*args)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert fused_fb.LAUNCHES == before       # no kernel ran


@pytest.mark.parametrize("k", [1, 4])
def test_fused_stepper_equals_eager_stepper(k):
    """make_stepper(backend='fused') advances steps_per_pass steps, with n
    and t as k single steps leave them."""
    _, (cfg, grid, forcing, st) = perturbed_case(nx=40, ny=24,
                                                 dtype="float32", seed=6)
    fused = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused", steps_per_pass=k))(st)
    eager = st
    step1 = make_stepper(grid, forcing, cfg)
    for _ in range(k):
        eager = step1(eager)
    assert (fused.n, fused.t) == (eager.n, eager.t) == (k, eager.t)
    for f in "huv":
        np.testing.assert_array_equal(getattr(fused, f).numpy(),
                                      getattr(eager, f).numpy())
