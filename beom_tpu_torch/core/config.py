"""Static run configuration: the port's twin of beom_tpu/core/config.py.

A frozen dataclass with the same field names and defaults, so one dict
builds either package's `Config`.  Two fields take the port's own values:

  * backend: 'eager' runs the step op by op in PyTorch (the twin of the
    JAX 'xla' path); 'fused' runs it through the hand-written CUDA kernel
    of stencils/fused_fb.py (the twin of 'pallas').  On CPU tensors the
    fused path runs the kernel's plain PyTorch version.
  * steps_per_pass: model steps one step() call advances, on either
    backend.

The reference's two TPU-only rules (a halo-versus-band-height check and
steps_per_pass <= 2 under a mesh) do not apply here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Config:
    # --- grid ---
    nx: int = 128                 # interior cells in x (cell centers)
    ny: int = 128                 # interior cells in y
    dx: float = 10e3              # [m] uniform spacing
    dy: float = 10e3              # [m]
    nz: int = 1                   # number of layers, surface -> bottom

    # --- stratification ---
    rho: Tuple[float, ...] = (1027.0,)   # layer densities, len == nz
    rho0: float = 1027.0          # Boussinesq reference density
    g: float = 9.81               # [m/s^2]

    # --- rotation ---
    f0: float = 1.0e-4            # [1/s] Coriolis at the southern edge
    beta: float = 0.0             # [1/(m s)] df/dy

    # --- time stepping ---
    dt: float = 300.0             # [s] (baroclinic) step
    scheme: str = "fb"            # 'fb' | 'split' | 'rigid_lid' | 'implicit_fs'
    nsub: int = 8                 # barotropic subcycles per step ('split')

    # --- elliptic solver ---
    solver: str = "cg"            # 'cg' | 'redblack' | 'mg'
    solver_tol: float = 1.0e-10
    solver_maxiter: int = 500
    sor_omega: float = 1.7
    precond: str = "auto"         # 'auto' | 'jacobi' | 'ssor' | 'mg'
    precond_sweeps: int = 1
    warm_start: bool = True

    # --- physics coefficients ---
    adv_scheme: str = "sadourny_energy"   # 'sadourny_energy' | 'linear'
    nu2: float = 0.0              # [m^2/s]  Laplacian viscosity
    nu4: float = 0.0              # [m^4/s]  biharmonic viscosity
    slip: str = "free"            # 'free' | 'no'
    r_bot: float = 0.0            # [m/s]  linear bottom drag
    cd_bot: float = 0.0           # [-]    quadratic bottom drag
    r_int: float = 0.0            # [m/s]  interfacial drag

    # --- wetting / drying ---
    wetdry: bool = False
    h_dry: float = 0.05           # [m] a layer cell thinner than this is dry
    h_min: float = 1.0e-3         # [m] floor thickness the limiter protects

    # --- forcing ---
    wind: bool = False            # apply (taux, tauy) to layer 1
    tides: Tuple[float, ...] = ()  # constituent frequencies [rad/s]

    # --- open boundaries / sponge ---
    obc: bool = False
    sponge: bool = False

    # --- numerics ---
    dtype: str = "float32"        # 'float32' | 'float64'
    backend: str = "eager"        # 'eager' | 'fused'
    steps_per_pass: int = 1       # model steps per step() call

    # --- distribution ---
    mesh_x: int = 1
    mesh_y: int = 1
    halo: int = 2
    halo_impl: str = "ppermute"

    # --- io / diagnostics cadence ---
    diag_every: int = 0           # steps between diagnostics (0 = off)
    snap_every: int = 0           # steps between snapshots (0 = off)

    def __post_init__(self):
        if len(self.rho) != self.nz:
            raise ValueError(
                f"len(rho)={len(self.rho)} must equal nz={self.nz}")
        if any(b - a < 0 for a, b in zip(self.rho, self.rho[1:])):
            raise ValueError("rho must be non-decreasing surface -> bottom "
                             "(statically stable stratification)")
        if self.scheme not in ("fb", "split", "rigid_lid", "implicit_fs"):
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.slip not in ("free", "no"):
            raise ValueError(f"unknown slip {self.slip!r}")
        if self.adv_scheme not in ("sadourny_energy", "linear"):
            raise ValueError(f"unknown adv_scheme {self.adv_scheme!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.backend not in ("eager", "fused"):
            raise ValueError(
                f"unknown backend {self.backend!r} ('eager' | 'fused')")
        if self.nx % self.mesh_x or self.ny % self.mesh_y:
            raise ValueError("nx/ny must divide evenly over the device mesh")
        if self.halo_impl not in ("ppermute", "rdma"):
            raise ValueError(f"unknown halo_impl {self.halo_impl!r}")
        if self.solver not in ("cg", "redblack", "mg"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.solver == "mg" and self.mesh_x * self.mesh_y > 1:
            raise ValueError(
                "solver='mg' (standalone multigrid cycles) is single-device;"
                " under a mesh use solver='cg' with precond='mg'")
        if self.precond not in ("auto", "jacobi", "ssor", "mg"):
            raise ValueError(f"unknown precond {self.precond!r}")
        if self.steps_per_pass < 1:
            raise ValueError("steps_per_pass must be >= 1")
        if self.steps_per_pass > 1 and self.scheme not in ("fb", "split"):
            raise ValueError(
                "steps_per_pass > 1 needs scheme='fb'|'split': the "
                "projection schemes solve a global elliptic problem "
                "every step")

    # -- derived ----------------------------------------------------------

    @property
    def gprime(self) -> Tuple[float, ...]:
        """Reduced gravities (g, g'_2, ..., g'_nz), index 0 the full g."""
        gp = [self.g]
        for k in range(1, self.nz):
            gp.append(self.g * (self.rho[k] - self.rho[k - 1]) / self.rho0)
        return tuple(gp)

    @property
    def npdtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

