"""Time-stepping schemes: the port's twin of beom_tpu/stepping/__init__.py.

`get_step(cfg)` dispatches cfg.scheme to a step function
step(state, grid, forcing, cfg) -> state for 'fb', 'split', 'rigid_lid'
and 'implicit_fs'.
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core.config import Config

_PROJECTION = ("rigid_lid", "implicit_fs")


def prepare_state(state, cfg: Config):
    """Attach the warm-start carry (State.phi) for the projection schemes;
    a no-op for fb/split or when already attached."""
    if (cfg.scheme in _PROJECTION and cfg.warm_start
            and state.phi is None):
        z = torch.zeros_like(state.h[0])
        return state.replace(phi=z, phi_prev=z)
    return state


def get_step(cfg: Config):
    if cfg.scheme == "fb":
        from beom_tpu_torch.stepping.fb import fb_step
        return fb_step
    if cfg.scheme in _PROJECTION:
        from beom_tpu_torch.stepping import projection
        return getattr(projection, f"{cfg.scheme}_step")
    if cfg.scheme == "split":
        from beom_tpu_torch.stepping.split import split_step
        return split_step
    raise ValueError(f"unknown scheme {cfg.scheme!r}")


def make_stepper(grid, forcing, cfg: Config):
    """step(state) -> state advancing cfg.steps_per_pass model steps.

    backend='fused' runs the hand-written kernels (their plain PyTorch
    versions on CPU tensors): fb and split through the fused steps of
    stencils/fused_fb.py, rigid_lid / implicit_fs through the phase
    kernels and the solver kernels of stencils/fused_projection.py.
    backend='eager' runs the step op by op.
    """
    step = get_step(cfg)
    k = cfg.steps_per_pass
    if cfg.backend == "fused" and cfg.scheme in _PROJECTION:
        from beom_tpu_torch.stencils.fused_projection import (
            make_fused_projection_stepper)
        return make_fused_projection_stepper(grid, forcing, cfg)
    if cfg.backend == "fused":
        from beom_tpu_torch.stencils.fused_fb import make_fused_stepper
        return make_fused_stepper(grid, forcing, cfg)

    def stepper(state):
        for _ in range(k):
            state = step(state, grid, forcing, cfg)
        return state

    return stepper


def run_steps(state, grid, forcing, cfg: Config, n_steps: int):
    """Advance n_steps of cfg.scheme op by op."""
    step = get_step(cfg)
    state = prepare_state(state, cfg)
    for _ in range(n_steps):
        state = step(state, grid, forcing, cfg)
    return state
