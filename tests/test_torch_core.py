"""beom_tpu_torch core against beom_tpu core: every C-grid operator, the
grid, forcing and rest state, and the double-gyre case arrays.  All are
bit-identical at f64 and f32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.core import ops as jops
from beom_tpu.core import state as jstate
from beom_tpu.core.config import Config as JConfig
from beom_tpu.core.grid import Forcing as JForcing
from beom_tpu.core.grid import Grid as JGrid
from beom_tpu.core.grid import make_grid as jax_make_grid
from beom_tpu.core.state import State as JState

from beom_tpu_torch import convert
from beom_tpu_torch.cases import make_case
from beom_tpu_torch.core import ops
from beom_tpu_torch.core import state as tstate
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import make_grid

OPS = ["sxp", "sxm", "syp", "sym", "d_xp", "d_xm", "d_yp", "d_ym",
       "a_xp", "a_xm", "a_yp", "a_ym"]
DTYPES = ["float64", "float32"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", OPS)
def test_op_bitwise(name, dtype):
    a = np.random.default_rng(3).standard_normal((3, 8, 16)).astype(dtype)
    args = (3.7e3,) if name.startswith("d_") else ()
    ref = np.asarray(getattr(jops, name)(jnp.asarray(a), *args))
    out = getattr(ops, name)(torch.tensor(a), *args).numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_double_gyre_case_bitwise(dtype):
    jcfg, jgrid, jforcing, jst = jax_make_case(
        "double_gyre", nx=64, ny=48, dtype=dtype)
    cfg, grid, forcing, st = make_case(
        "double_gyre", nx=64, ny=48, dtype=dtype, device="cpu")
    d = dataclasses.asdict(jcfg)
    d["backend"] = "eager"
    assert dataclasses.asdict(cfg) == d
    for obj, ref in ((grid, jgrid), (forcing, jforcing)):
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(
                getattr(obj, f.name).numpy(), np.asarray(getattr(ref, f.name)),
                err_msg=f.name)
            assert getattr(obj, f.name).dtype == getattr(torch, dtype)
    for f in "huv":
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)))
    assert st.n == int(jst.n) == 0
    assert st.t == np.asarray(jst.t) and st.t.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(tstate.eta(st, grid).numpy(),
                                  np.asarray(jstate.eta(jst, jgrid)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_and_init_state_from_arrays(dtype):
    """make_grid with an explicit (open) mask on a beta-plane, and
    init_state with given h0, u0, v0."""
    rng = np.random.default_rng(5)
    kw = dict(nx=24, ny=20, nz=2, rho=(1026.0, 1027.5), beta=2e-11,
              dtype=dtype)
    H = rng.uniform(-5.0, 40.0, (20, 24))
    mask = (rng.uniform(size=(20, 24)) > 0.2).astype(float)
    h0, u0, v0 = (rng.standard_normal((2, 20, 24)) for _ in range(3))
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jgrid = jax_make_grid(jcfg, H, mask)
    grid = make_grid(cfg, H, mask, device="cpu")
    for f in dataclasses.fields(jgrid):
        np.testing.assert_array_equal(getattr(grid, f.name).numpy(),
                                      np.asarray(getattr(jgrid, f.name)))
    jst = jstate.init_state(jcfg, jgrid, h0, u0, v0)
    st = tstate.init_state(cfg, grid, h0, u0, v0)
    for f in "huv":
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)))
    np.testing.assert_array_equal(tstate.init_state(cfg, grid).h.numpy(),
                                  np.asarray(jstate.init_state(jcfg,
                                                               jgrid).h))


def test_config_rules():
    assert Config().backend == "eager"
    Config(steps_per_pass=4)                     # any backend may block
    Config(steps_per_pass=4, backend="fused")
    with pytest.raises(ValueError, match="backend"):
        Config(backend="pallas")
    with pytest.raises(ValueError, match="steps_per_pass"):
        Config(steps_per_pass=2, scheme="rigid_lid")
    with pytest.raises(ValueError, match="rho"):
        Config(nz=2)
    assert Config(nz=2, rho=(1026.0, 1027.5)).gprime == pytest.approx(
        (9.81, 9.81 * 1.5 / 1027.0))


def test_convert_round_trip():
    """to_numpy builds beom_tpu's objects from the port's, and
    from_reference brings them back, bit for bit."""
    cfg, grid, forcing, st = make_case("double_gyre", nx=20, ny=16,
                                       dtype="float64", device="cpu",
                                       backend="fused")
    st = st.replace(n=3, t=np.float64(2.5))
    d, g, f, s = convert.to_numpy(cfg, grid, forcing, st)
    assert d["backend"] == "pallas"
    jcfg = JConfig(**d)
    jgrid = JGrid(**{k: jnp.asarray(v) for k, v in g.items()})
    jforcing = JForcing(**{k: jnp.asarray(v) for k, v in f.items()})
    jst = JState(**{k: jnp.asarray(v) for k, v in s.items()})
    ref = jax_make_case("double_gyre", nx=20, ny=16, dtype="float64",
                        backend="pallas")
    assert jcfg == ref[0]
    for a, b in ((jgrid, ref[1]), (jforcing, ref[2])):
        for fld in dataclasses.fields(b):
            np.testing.assert_array_equal(np.asarray(getattr(a, fld.name)),
                                          np.asarray(getattr(b, fld.name)))
    cfg2, grid2, forcing2, st2 = convert.from_reference(
        dataclasses.asdict(jcfg), jgrid, jforcing, jst, "cpu")
    assert cfg2 == cfg and (st2.n, st2.t) == (3, 2.5)
    for a, b in ((grid2, grid), (forcing2, forcing), (st2, st)):
        for name in ("h", "u", "v") if a is st2 else \
                [fld.name for fld in dataclasses.fields(b)]:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
