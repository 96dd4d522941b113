"""Wetting and drying masks: the port's twin of beom_tpu/physics/wetdry.py
(eager PyTorch only).

A layer cell is wet when its thickness exceeds cfg.h_dry; land cells are
never wet.  A velocity face between a wet and a dry cell only admits flow
from the wet side.
"""

from __future__ import annotations

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid


def wet_mask(h: torch.Tensor, grid: Grid, cfg: Config) -> torch.Tensor:
    """Per-layer wetness (nz, ny, nx) in {0.0, 1.0}."""
    return (h > cfg.h_dry).to(h.dtype) * grid.mask


def _gate(w, wet, shifted_wet, face_mask):
    wl, wr = wet, shifted_wet
    both = wl * wr
    only_l = wl * (1.0 - wr)   # water on the low side: only outward flow
    only_r = wr * (1.0 - wl)   # water on the high side: only inward flow
    gated = (both * w + only_l * torch.clamp_min(w, 0.0)
             + only_r * torch.clamp_max(w, 0.0))
    return face_mask * gated


def gate_u(u: torch.Tensor, wet: torch.Tensor, grid: Grid) -> torch.Tensor:
    """One-sided gating of u at wet/dry faces (identity if all wet)."""
    return _gate(u, wet, ops.sxp(wet), grid.mask_u)


def gate_v(v: torch.Tensor, wet: torch.Tensor, grid: Grid) -> torch.Tensor:
    return _gate(v, wet, ops.syp(wet), grid.mask_v)
