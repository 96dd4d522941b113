"""Each function of the port's seven physics modules against beom_tpu's,
on a random perturbed two-layer state at 48x40 f64 with every term on:
wet/dry, OBC with a tide, sponge, nu2, nu4, both drags, wind.  The
forcing arrays are built by hand from a seed.  Tolerance: 1e-13 x the
reference field's scale."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from beom_tpu.core.config import Config as JConfig
from beom_tpu.core.grid import make_forcing as j_forcing
from beom_tpu.core.grid import make_grid as j_grid
from beom_tpu.core.state import init_state as j_init
from beom_tpu.physics import (continuity as jc, drag as jd, momentum as jm,
                              obc as jo, pressure as jp, viscosity as jv,
                              wetdry as jw)

from beom_tpu_torch.physics import (continuity as tc, drag as td,
                                    momentum as tm, obc as to, pressure as tp,
                                    viscosity as tv, wetdry as tw)

from tests.torch_parity import assert_close, perturb, to_port

NY, NX = 40, 48
REL = 1e-13


def _case(**overrides):
    rng = np.random.default_rng(11)
    kw = dict(nx=NX, ny=NY, dx=5e3, dy=4e3, nz=2, rho=(1026.0, 1027.5),
              f0=1e-4, beta=2e-11, dt=20.0, nu2=50.0, nu4=1e9, r_bot=1e-3,
              cd_bot=2.5e-3, r_int=1e-4, wetdry=True, wind=True,
              tides=(1.4e-4, 7e-5), obc=True, sponge=True,
              dtype="float64")
    kw.update(overrides)
    cfg = JConfig(**kw)
    # shallow shelf: part of the domain is thin enough to dry
    H = np.linspace(0.05, 30.0, NX)[None, :] * np.ones((NY, 1))
    H = H + rng.uniform(0.0, 0.2, (NY, NX))
    grid = j_grid(cfg, H)
    sign = rng.choice([-1.0, 0.0, 1.0], (NY, NX))
    forcing = j_forcing(
        cfg, taux=0.1 * rng.standard_normal((NY, NX)),
        tauy=0.1 * rng.standard_normal((NY, NX)),
        sponge=rng.uniform(0.0, 1e-4, (NY, NX)),
        h_ext=np.asarray(grid.H)[None].repeat(2, 0) / 2
        + rng.uniform(0.0, 0.1, (2, NY, NX)),
        obc_u=sign, obc_v=np.roll(sign, 3, 0),
        obc_h=(rng.uniform(size=(NY, NX)) > 0.8).astype(float),
        tide_amp=rng.uniform(0.0, 0.5, (2, NY, NX)),
        tide_phase=rng.uniform(0.0, 6.28, (2, NY, NX)))
    state = perturb(cfg, grid, j_init(cfg, grid), seed=7, amp_h=0.05,
                    amp_uv=0.3)
    # some cells thinner than h_dry / 2 h_dry so every wet/dry branch runs
    h = np.asarray(state.h) * np.where(rng.uniform(size=(2, NY, NX)) > 0.9,
                                       0.01, 1.0)
    state = state.replace(h=jnp.asarray(h), t=jnp.asarray(1234.5))
    ref = dict(cfg=cfg, grid=grid, forcing=forcing, state=state, h=state.h,
               u=state.u, v=state.v, t=state.t)
    pcfg, pgrid, pforcing, pst = to_port(cfg, grid, forcing, state)
    port = dict(cfg=pcfg, grid=pgrid, forcing=pforcing, state=pst, h=pst.h,
                u=pst.u, v=pst.v, t=pst.t)
    ref["wet"] = jw.wet_mask(ref["h"], grid, cfg)
    port["wet"] = tw.wet_mask(port["h"], pgrid, pcfg)
    return ref, port


# (label, reference function, port function, argument names)
CASES = [
    ("montgomery", jp.montgomery, tp.montgomery, "h grid cfg"),
    ("montgomery_rigid",
     lambda h, g, c: jp.montgomery(h, g, c, free_surface=False),
     lambda h, g, c: tp.montgomery(h, g, c, free_surface=False),
     "h grid cfg"),
    ("mass_fluxes", jc.mass_fluxes, tc.mass_fluxes, "h u v grid cfg"),
    ("continuity_rhs", jc.continuity_rhs, tc.continuity_rhs,
     "h u v grid cfg"),
    ("kinetic_energy", jm.kinetic_energy, tm.kinetic_energy, "u v"),
    ("pv_corner", jm.pv_corner, tm.pv_corner, "h u v grid cfg"),
    ("coriolis_advection", jm.coriolis_advection, tm.coriolis_advection,
     "h u v grid cfg"),
    ("lap_u", jv.lap_u, tv.lap_u, "u grid cfg"),
    ("lap_v", jv.lap_v, tv.lap_v, "v grid cfg"),
    ("viscosity", jv.viscosity, tv.viscosity, "u v grid cfg"),
    ("bottom_drag_coeff", jd.bottom_drag_coeff, td.bottom_drag_coeff,
     "h u v grid cfg"),
    ("wind", jd.wind, td.wind, "h grid forcing cfg"),
    ("interfacial_drag", jd.interfacial_drag, td.interfacial_drag,
     "h u v grid cfg"),
    ("eta_ext", lambda t, f, c: jo.eta_ext(t, f, c, jnp.float64),
     lambda t, f, c: to.eta_ext(t, f, c, __import__("torch").float64),
     "t forcing cfg"),
    ("sponge_rhs", jo.sponge_rhs, to.sponge_rhs, "h u v forcing cfg"),
    ("apply_flather", jo.apply_flather, to.apply_flather,
     "h u v grid forcing cfg t"),
    ("apply_clamp", jo.apply_clamp, to.apply_clamp, "h grid forcing cfg t"),
    ("wet_mask", jw.wet_mask, tw.wet_mask, "h grid cfg"),
    ("gate_u", jw.gate_u, tw.gate_u, "u wet grid"),
    ("gate_v", jw.gate_v, tw.gate_v, "v wet grid"),
]

# the config variants that switch a function onto another branch
VARIANTS = {
    "default": {},
    "linear_noslip": dict(adv_scheme="linear", slip="no"),
    "terms_off": dict(wetdry=False, obc=False, sponge=False, wind=False,
                      nu4=0.0, cd_bot=0.0, r_bot=0.0, tides=()),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def case(request):
    return _case(**VARIANTS[request.param])


@pytest.mark.parametrize("label,jfn,tfn,args",
                         CASES, ids=[c[0] for c in CASES])
def test_physics_function(case, label, jfn, tfn, args):
    ref, port = case
    names = args.split()
    r = jfn(*[ref[n] for n in names])
    p = tfn(*[port[n] for n in names])
    rs = r if isinstance(r, tuple) else (r,)
    ps = p if isinstance(p, tuple) else (p,)
    assert len(rs) == len(ps)
    for i, (a, b) in enumerate(zip(ps, rs)):
        if isinstance(b, float):        # viscosity's 0.0 when nu2 = nu4 = 0
            assert a == b
            continue
        assert_close(a, b, REL, f"{label}[{i}]")


def test_wetdry_branches_exercised(case):
    """The case really has dry cells, thin faces and clamped cells."""
    ref, _ = case
    h = np.asarray(ref["h"])
    assert (h < ref["cfg"].h_dry).any() and (h > 1.0).any()
    assert dataclasses.asdict(ref["cfg"])["nz"] == 2
