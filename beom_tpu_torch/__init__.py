"""beom_tpu_torch: the PyTorch / CUDA port of beom_tpu.

A layered shallow-water ocean model on an Arakawa C grid, held against
the JAX package beom_tpu, which stays the reference.  Plain tensor code
is PyTorch; each TPU kernel of beom_tpu becomes a kernel written by hand
for NVIDIA Hopper (sources in csrc/, built with nvcc at first use).  The
package imports torch and numpy, never jax.

Layout (module paths and names mirror beom_tpu's):
  core/      Config, Grid, Forcing, State; the C-grid operator algebra
  physics/   continuity, momentum, pressure, viscosity, drag, OBC, wet-dry
  stepping/  the forward-backward, the split barotropic / baroclinic and
             the rigid-lid / implicit-free-surface projection steppers;
             make_stepper
  solvers/   the elliptic solvers (CG, red-black SOR, multigrid), single
             device
  stencils/  the kernels' wrappers beside their plain versions: the fused
             fb step (K1) and split step (K1s), the projection phases
             (K3a, K3b), the red-black sweep and operator pass (K4a, K4b),
             the coarse multigrid stack (K5), the fused CG (K6)
  cases/     the double gyre, the two-layer gyre, the rigid-lid gyre, the
             wetting-drying coast, the forced shelf
  diag/      energy/mass diagnostics, NaN guard
  io/        snapshots (the reference's npz layout), TOML + overrides
  run.py     the chunked run loop and CLI
  convert.py arrays across from and back to beom_tpu
"""

__version__ = "0.1.0"
