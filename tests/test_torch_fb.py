"""The port's forward-backward step against beom_tpu's XLA path and the
f64 NumPy oracle."""

import dataclasses

import numpy as np
import pytest

from beom_tpu.oracle import oracle_for
from beom_tpu.stepping import fb as jfb
from beom_tpu.stepping import run_steps as j_run_steps

from beom_tpu_torch.stepping import fb, make_stepper, run_steps

from tests.test_torch_physics import _case
from tests.torch_parity import assert_close, perturbed_case


def _one_step(ref, port, n):
    jcfg, jgrid, jforcing, jst = ref
    cfg, grid, forcing, st = port
    jst = jst.replace(n=jst.n + n)
    st = st.replace(n=st.n + n)
    r = jfb.fb_step(jst, jgrid, jforcing, jcfg)
    p = fb.fb_step(st, grid, forcing, cfg)
    assert p.n == int(r.n) == n + 1
    assert p.t == np.asarray(r.t)
    return p, r


@pytest.mark.parametrize("n", [0, 1])
def test_fb_step_double_gyre_parity(n):
    """One step from a perturbed state at both sweep orders: 1e-13
    relative to each field's scale."""
    ref, port = perturbed_case(nx=32, ny=32, dtype="float64", seed=1)
    p, r = _one_step(ref, port, n)
    for f in "huv":
        assert_close(getattr(p, f), getattr(r, f), 1e-13, f)


@pytest.mark.parametrize("n", [0, 1])
def test_fb_step_all_terms_parity(n):
    """One step with every term on (two layers, wet/dry, OBC + tides,
    sponge, nu4, both drags)."""
    r, p = _case()
    ref = (r["cfg"], r["grid"], r["forcing"], r["state"])
    port = (p["cfg"], p["grid"], p["forcing"], p["state"])
    out, jout = _one_step(ref, port, n)
    for f in "huv":
        assert_close(getattr(out, f), getattr(jout, f), 1e-13, f)


def test_fb_300_steps_vs_reference_and_oracle():
    """300 steps of the 32x32 double gyre at f64: within the
    tests/test_parity.py envelope of the oracle (h 1e-7, u/v 1e-10) and
    within 1e-10 relative of beom_tpu's XLA path."""
    from beom_tpu.cases import make_case as jax_make_case
    from tests.torch_parity import to_port

    jcfg, jgrid, jforcing, jst = jax_make_case(
        "double_gyre", nx=32, ny=32, dtype="float64")
    cfg, grid, forcing, st = to_port(jcfg, jgrid, jforcing, jst)
    out = run_steps(st, grid, forcing, cfg, 300)
    ref = j_run_steps(jst, jgrid, jforcing, jcfg, 300)
    ho, uo, vo = oracle_for(jcfg, jgrid, jforcing).run(
        np.asarray(jst.h), np.asarray(jst.u), np.asarray(jst.v), 300)
    np.testing.assert_allclose(out.h.numpy(), ho, rtol=0, atol=1e-7)
    np.testing.assert_allclose(out.u.numpy(), uo, rtol=0, atol=1e-10)
    np.testing.assert_allclose(out.v.numpy(), vo, rtol=0, atol=1e-10)
    assert np.abs(uo).max() > 1e-8        # the run did something
    for f in "huv":
        assert_close(getattr(out, f), getattr(ref, f), 1e-10, f)
    assert out.n == 300


@pytest.mark.parametrize("k", [1, 3])
def test_make_stepper_eager_advances_steps_per_pass(k):
    _, (cfg, grid, forcing, st) = perturbed_case(nx=24, ny=20,
                                                 dtype="float64", seed=2)
    cfg = dataclasses.replace(cfg, steps_per_pass=k)
    out = make_stepper(grid, forcing, cfg)(st)
    ref = st
    for _ in range(k):
        ref = fb.fb_step(ref, grid, forcing, cfg)
    assert out.n == k and out.t == ref.t
    for f in "huv":
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      getattr(ref, f).numpy())
