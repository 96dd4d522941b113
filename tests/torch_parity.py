"""Helpers for the beom_tpu_torch tests: one set of numpy inputs, made
from a seed, goes through the JAX reference and the port."""

from __future__ import annotations

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu_torch import convert


def to_port(cfg, grid, forcing, state, device="cpu"):
    """The port's (cfg, grid, forcing, state) from JAX objects."""
    return convert.from_reference(dataclasses.asdict(cfg), grid, forcing,
                                  state, device)


def perturb(cfg, grid, state, seed, amp_h=0.5, amp_uv=0.05):
    """The JAX state plus a seeded perturbation of h, u and v, masked like
    the fields it perturbs (from rest most terms start at zero)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.nz, cfg.ny, cfg.nx)
    dt = cfg.npdtype

    def noise(amp, m):
        return jnp.asarray((amp * rng.standard_normal(shape)).astype(dt)
                           * np.asarray(m))

    return state.replace(h=state.h + noise(amp_h, grid.mask),
                         u=state.u + noise(amp_uv, grid.mask_u),
                         v=state.v + noise(amp_uv, grid.mask_v))


def perturbed_case(name="double_gyre", seed=0, device="cpu", **kw):
    """(JAX case, port case) from one perturbed JAX case."""
    cfg, grid, forcing, state = jax_make_case(name, **kw)
    state = perturb(cfg, grid, state, seed)
    return (cfg, grid, forcing, state), to_port(cfg, grid, forcing, state,
                                                device)


def np_of(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def assert_close(port, ref, rel, what=""):
    """|port - ref| <= rel * max(|ref|) (the field scale)."""
    p, r = np_of(port), np_of(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    scale = max(float(np.abs(r).max()), 1e-300)
    err = float(np.abs(p - r).max())
    assert err <= rel * scale, f"{what}: max|diff| {err:.3e} > " \
        f"{rel:.1e} x scale {scale:.3e}"


def assert_state_close(port, ref, rel, what=""):
    """The port's h, u and v within rel of field scale of the reference
    state's.  The scale of u and v is the velocity's, max(|u|, |v|) of the
    reference: a component that stays at rest (v of a zonal jet) holds
    only round-off, which has no scale of its own."""
    speed = max(float(np.abs(np.asarray(ref.u)).max()),
                float(np.abs(np.asarray(ref.v)).max()))
    for f in "huv":
        p, r = np_of(getattr(port, f)), np.asarray(getattr(ref, f))
        scale = float(np.abs(r).max()) if f == "h" else speed
        err = float(np.abs(p - r).max())
        assert p.shape == r.shape and err <= rel * scale, \
            f"{f} {what}: max|diff| {err:.3e} > {rel:.1e} x scale " \
            f"{scale:.3e}"


def xla_twin(cfg, H, n_steps, port_out, mask=None, h0=None, u0=None,
             rel=1e-9):
    """beom_tpu's XLA path from the same numpy inputs (the port's Config,
    bathymetry, mask and initial h, u), n_steps steps, no forcing; the
    port's final state must lie within rel of it (assert_state_close)."""
    from beom_tpu.core.config import Config as JConfig
    from beom_tpu.core.grid import make_forcing, make_grid
    from beom_tpu.core.state import init_state
    from beom_tpu.stepping import run_steps

    d = dataclasses.asdict(cfg)
    d["backend"] = "xla"
    jcfg = JConfig(**d)
    jgrid = make_grid(jcfg, H, mask=mask)
    jst = run_steps(init_state(jcfg, jgrid, h0=h0, u0=u0), jgrid,
                    make_forcing(jcfg), jcfg, n_steps)
    assert_state_close(port_out, jst, rel,
                       f"after {n_steps} steps vs beom_tpu XLA")


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread: the long serial runs of small grids
    gain nothing from more, and lose to contention where test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
