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
  solvers/   the elliptic solvers (CG, red-black SOR, multigrid), with the
             hooks their distributed forms over a mesh take
  parallel/  the device mesh (sharded fields, one controlling process),
             the halo exchange and mesh reductions, the distributed
             steppers and solvers, per-shard diagnostics
  stencils/  the kernels' wrappers beside their plain versions: the fused
             fb step (K1) and split step (K1s), the projection phases
             (K3a, K3b), the red-black sweep and operator pass (K4a, K4b),
             the coarse multigrid stack (K5), the fused CG (K6), the shard
             kernels under a mesh around the fb and split bodies and the
             projection phases (K7), the halo pad (K8)
  cases/     the double gyre, the two-layer gyre, the rigid-lid gyre, the
             wetting-drying coast, the forced shelf
  diag/      energy/mass diagnostics, NaN guard
  io/        snapshots (the reference's npz layout) and raw snapshots (its
             headerless binary), TOML (load_toml, load_toml_case) +
             overrides; native.py, the async snapshot writer (ctypes over
             csrc/snapwriter.cpp, built with g++ into build/native/)
  parallel/multihost.py  the multi-process bootstrap on torch.distributed
             and gather_to_host
  viz/       quicklook PNGs and diagnostic series (needs matplotlib, which
             no other module imports)
  run.py     the chunked run loop and CLI
  entry.py   entry() (one fused step of the 256^2 gyre) and
             dryrun_multichip(n) (the reference's seven mesh legs on n
             shards of one device)
  convert.py arrays across from and back to beom_tpu

Importing the package builds no kernel: each is built at its first
launch.
"""

__version__ = "0.1.0"

from beom_tpu_torch.core.config import Config, default_config  # noqa: F401
from beom_tpu_torch.core.grid import Grid, make_grid  # noqa: F401
from beom_tpu_torch.core.state import State, init_state  # noqa: F401
