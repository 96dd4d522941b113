"""beom_tpu_torch: the PyTorch / CUDA port of beom_tpu.

A layered shallow-water ocean model on an Arakawa C grid, held against
the JAX package beom_tpu, which stays the reference.  Plain tensor code
is PyTorch; each TPU kernel of beom_tpu becomes a kernel written by hand
for NVIDIA Hopper (sources in csrc/, built with nvcc at first use).  The
package imports torch and numpy, never jax.

Layout (module paths and names mirror beom_tpu's):
  core/      Config, Grid, Forcing, State; the C-grid operator algebra
  physics/   continuity, momentum, pressure, viscosity, drag, OBC, wet-dry
  stepping/  the forward-backward stepper; make_stepper
  stencils/  the fused fb step kernel (K1) and its plain version
  cases/     the double gyre
  diag/      energy/mass diagnostics, NaN guard
  io/        snapshots (the reference's npz layout), TOML + overrides
  run.py     the chunked run loop and CLI
  convert.py arrays across from and back to beom_tpu
"""

__version__ = "0.1.0"
