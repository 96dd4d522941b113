"""The port's split barotropic / baroclinic step against
beom_tpu.stepping.split: each phase and the whole step at nz = 1 and 2
from a perturbed state (1e-13 x the reference field's scale, a few ulp at
f64), the twins of tests/test_parity.py's split legs against the f64 NumPy
oracle and the XLA path, the plain version of the fused split step against
beom_tpu's Pallas stepper in interpret mode as tests/unit/test_pallas.py
runs it, and the routing of scheme='split' through get_step, make_stepper
and the fused wrappers on CPU tensors."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.oracle import oracle_for
from beom_tpu.stencils.fused_fb import make_pallas_stepper
from beom_tpu.stepping import run_steps as j_run_steps
from beom_tpu.stepping import split as jsplit

from beom_tpu_torch.stencils import fused_fb
from beom_tpu_torch.stepping import get_step, make_stepper, run_steps, split

from tests.torch_parity import assert_close, perturbed_case, to_port

REL = 1e-13
SUB = ("eta_f", "ubar_f", "vbar_f", "ubar_avg", "vbar_avg")

# nz = 1, nz = 2, and nz = 2 with wet/dry, the open boundary, the sponge,
# the tide, quadratic bottom drag, nu4 and interfacial drag on
CASES = {
    "double_gyre": ("double_gyre", dict(nsub=4)),
    "two_layer": ("two_layer", dict(nsub=8)),
    "shelf_all_terms": ("shelf_forced", dict(nsub=6, nu4=1e6, r_int=1e-4)),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name, kw = CASES[request.param]
    return perturbed_case(name, seed=12, nx=40, ny=32, dtype="float64",
                          scheme="split", **kw)


def test_slow_phase_parity(case):
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = case
    ref = jsplit.slow_phase(jst, jgrid, jforcing, jcfg)
    out = split.slow_phase(st, grid, forcing, cfg)
    assert out._fields == ref._fields
    for name, a, b in zip(out._fields, out, ref):
        assert_close(a, b, REL, name)


def test_subcycle_phase_parity(case):
    """The port's subcycle from the reference's SlowPhase."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = case
    jsp = jsplit.slow_phase(jst, jgrid, jforcing, jcfg)
    sp = split.SlowPhase(*[torch.tensor(np.asarray(a)) for a in jsp])
    ref = jsplit.subcycle_phase(jsp, jgrid, jcfg)
    out = split.subcycle_phase(sp, grid, cfg)
    for name, a, b in zip(SUB, out, ref):
        assert_close(a, b, REL, name)


def test_subcycle_exchange_hooks(case):
    """pad1 / crop1 as a periodic 1-halo pad and its crop leave the
    subcycle unchanged bit for bit: every substep reaches one cell."""
    _, (cfg, grid, forcing, st) = case
    sp = split.slow_phase(st, grid, forcing, cfg)

    def pad1(a):
        a = torch.cat([a[..., -1:, :], a, a[..., :1, :]], dim=-2)
        return torch.cat([a[..., -1:], a, a[..., :1]], dim=-1)

    def crop1(a):
        return a[..., 1:-1, 1:-1]

    ref = split.subcycle_phase(sp, grid, cfg)
    out = split.subcycle_phase(sp, grid, cfg, pad1=pad1, crop1=crop1)
    for name, a, b in zip(SUB, out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_recompose_parity(case):
    """The port's recompose from the reference's SlowPhase and subcycle."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = case
    jsp = jsplit.slow_phase(jst, jgrid, jforcing, jcfg)
    jsub = jsplit.subcycle_phase(jsp, jgrid, jcfg)
    sp = split.SlowPhase(*[torch.tensor(np.asarray(a)) for a in jsp])
    sub = [torch.tensor(np.asarray(a)) for a in jsub]
    ref = jsplit.recompose(jsp, *jsub, jst.h, jgrid, jcfg)
    out = split.recompose(sp, *sub, st.h, grid, cfg)
    for name, a, b in zip(("h1", "u1", "v1"), out, ref):
        assert_close(a, b, REL, name)


@pytest.mark.parametrize("n", [0, 1])
def test_split_step_parity(case, n):
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = case
    jst = jst.replace(n=jst.n + n, t=jnp.asarray(4321.0))
    st = st.replace(n=n, t=np.float64(4321.0))
    ref = jsplit.split_step(jst, jgrid, jforcing, jcfg)
    out = split.split_step(st, grid, forcing, cfg)
    assert out.n == int(ref.n) == n + 1 and out.t == np.asarray(ref.t)
    for f in "huv":
        assert_close(getattr(out, f), getattr(ref, f), REL, f)


@pytest.mark.parametrize("name,n_steps,kw", [
    ("double_gyre", 300, dict(nsub=4)),
    ("two_layer", 200, dict(nsub=4)),
], ids=["split", "split_two_layer"])
def test_parity_split(name, n_steps, kw):
    """The twins of tests/test_parity.py::test_parity_split and
    test_parity_split_two_layer at 32x32 f64: within the oracle's envelope
    (h 1e-7, u/v 1e-10) and within 1e-10 relative of the XLA path."""
    jcase = jax_make_case(name, nx=32, ny=32, dtype="float64",
                          scheme="split", **kw)
    jcfg, jgrid, jforcing, jst = jcase
    cfg, grid, forcing, st = to_port(*jcase)
    out = run_steps(st, grid, forcing, cfg, n_steps)
    ref = j_run_steps(jst, jgrid, jforcing, jcfg, n_steps)
    ho, uo, vo = oracle_for(jcfg, jgrid, jforcing).run(
        np.asarray(jst.h), np.asarray(jst.u), np.asarray(jst.v), n_steps)
    np.testing.assert_allclose(out.h.numpy(), ho, rtol=0, atol=1e-7)
    np.testing.assert_allclose(out.u.numpy(), uo, rtol=0, atol=1e-10)
    np.testing.assert_allclose(out.v.numpy(), vo, rtol=0, atol=1e-10)
    assert np.abs(uo).max() > 1e-8        # the run did something
    for f in "huv":
        assert_close(getattr(out, f), getattr(ref, f), 1e-10, f)
    assert out.n == n_steps


@pytest.mark.parametrize("name,nsub", [("double_gyre", 6), ("two_layer", 4)])
def test_plain_split_matches_pallas_interpret(name, nsub):
    """3 steps at 128x160 with by=32, as tests/unit/test_pallas.py::
    test_pallas_split_parity[_2layer] runs the Pallas stepper: 1e-12 x
    max(scale, 1), its own bound."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = perturbed_case(
        name, nx=128, ny=160, dtype="float64", seed=13, scheme="split",
        nsub=nsub)
    jstep = make_pallas_stepper(jgrid, jforcing, jcfg, by=32, bx=64,
                                interpret=True)
    for _ in range(3):
        jst = jstep(jst)
    out = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, (grid, forcing),
                                       st.n, st.t, cfg, 3)
    for f, a in zip("huv", out):
        ref = np.asarray(getattr(jst, f))
        np.testing.assert_allclose(
            a.numpy(), ref, rtol=0,
            atol=1e-12 * max(np.abs(ref).max(), 1.0), err_msg=f)


def test_get_step_routes_split(case):
    _, (cfg, grid, forcing, st) = case
    assert get_step(cfg) is split.split_step
    out = run_steps(st, grid, forcing, cfg, 2)
    ref = split.split_step(split.split_step(st, grid, forcing, cfg), grid,
                           forcing, cfg)
    for f in "huv":
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      getattr(ref, f).numpy())


@pytest.mark.parametrize("k", [1, 3])
def test_fused_split_stepper_equals_eager_stepper(case, k):
    """make_stepper(backend='fused') with scheme='split' advances
    steps_per_pass steps; on CPU tensors it takes the plain version and
    launches nothing."""
    _, (cfg, grid, forcing, st) = case
    before = dict(fused_fb.SPLIT_LAUNCHES)
    fused = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused", steps_per_pass=k))(st)
    eager = st
    for _ in range(k):
        eager = split.split_step(eager, grid, forcing, cfg)
    assert (fused.n, fused.t) == (eager.n, eager.t)
    for f in "huv":
        np.testing.assert_array_equal(getattr(fused, f).numpy(),
                                      getattr(eager, f).numpy())
    assert fused_fb.SPLIT_LAUNCHES == before


def test_split_kernel_wrappers_compose_on_cpu(case):
    """split_slow, split_subcycle and split_recompose, the wrappers of the
    three kernels, chained on CPU tensors equal split_step bit for bit."""
    _, (cfg, grid, forcing, st) = case
    statics = (grid, forcing)
    sp = fused_fb.split_slow(st.h, st.u, st.v, statics, cfg)
    sub = fused_fb.split_subcycle(sp, st.h, st.u, st.v, statics, cfg)
    out = fused_fb.split_recompose(sp, sub, st.h, st.u, st.v, statics, st.t,
                                   cfg)
    ref = split.split_step(st, grid, forcing, cfg)
    for f, a in zip("huv", out):
        np.testing.assert_array_equal(a.numpy(), getattr(ref, f).numpy())
    # what the kernels hand over: cu, cv as the bottom layer's plane
    fields = fused_fb._slow_fields(sp, cfg)
    assert len(fields) == 13 and fields[11].shape == (cfg.ny, cfg.nx)
