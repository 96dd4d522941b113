"""Time-stepping schemes: the port's twin of beom_tpu/stepping/__init__.py.

`get_step(cfg)` dispatches cfg.scheme to a step function
step(state, grid, forcing, cfg) -> state.  Only 'fb' is ported so far.
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core.config import Config

# where each scheme that is not yet ported sits in ROADMAP.md's queue 1
_NOT_PORTED = {
    "split": "ROADMAP queue 1 item 10 (slice 3: stepping/split.py)",
    "rigid_lid": "ROADMAP queue 1 item 11 (slice 4: stepping/projection.py)",
    "implicit_fs": "ROADMAP queue 1 item 11 (slice 4: stepping/projection.py)",
}


def _not_ported(cfg: Config):
    return NotImplementedError(
        f"scheme={cfg.scheme!r} is not ported to beom_tpu_torch yet: "
        f"{_NOT_PORTED[cfg.scheme]}")


def prepare_state(state, cfg: Config):
    """Attach the warm-start carry (State.phi) for the projection schemes;
    a no-op for fb/split or when already attached."""
    if (cfg.scheme in ("rigid_lid", "implicit_fs") and cfg.warm_start
            and state.phi is None):
        z = torch.zeros(state.h.shape[1:], dtype=state.h.dtype,
                        device=state.h.device)
        return state.replace(phi=z, phi_prev=z)
    return state


def get_step(cfg: Config):
    if cfg.scheme == "fb":
        from beom_tpu_torch.stepping.fb import fb_step
        return fb_step
    if cfg.scheme in _NOT_PORTED:
        raise _not_ported(cfg)
    raise ValueError(f"unknown scheme {cfg.scheme!r}")


def make_stepper(grid, forcing, cfg: Config):
    """step(state) -> state advancing cfg.steps_per_pass model steps.

    backend='fused' runs the hand-written fused step kernel
    (stencils/fused_fb.py, its plain PyTorch version on CPU tensors);
    backend='eager' runs fb_step op by op.
    """
    step = get_step(cfg)
    k = cfg.steps_per_pass
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
