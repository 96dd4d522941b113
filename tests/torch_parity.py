"""Helpers for the beom_tpu_torch tests: one set of numpy inputs, made
from a seed, goes through the JAX reference and the port."""

from __future__ import annotations

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
