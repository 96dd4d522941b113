"""The mesh's elliptic solve on the card's kernels: the projection step's
pressure solve of a mesh of shards, run on the gathered grid of the
shards.

The reference solves on the mesh with XLA ops under shard_map
(beom_tpu/parallel/dist.py::_dist_solve: CG with a halo-pipelined matvec
and one mesh reduction per iteration, or red-black sweeps); it has no
Pallas kernel there, and the port's eager twin (parallel/dist.py) runs a
few hundred launches per CG iteration and shard.  That solve computes the
global solve: with Jacobi the preconditioner is pointwise, the
distributed multigrid cycle is the single-device cycle on the gathered
field when the hierarchies match (multigrid.mesh_levels), and red-black
colours the global checkerboard.  So where the shards lie on CUDA cards,
`make_mesh_solve` copies the right-hand side and the warm start of every
shard into the global layout on the mesh's first card, runs one of the
port's hand-written kernels there, and copies x back into the shards'
stacked layout (the layout K7's phase B reads without a copy):

  jacobi    K6-Jacobi (stencils/cg_fused.py, csrc/cg_jacobi.cu), one
            launch per solve: precond='jacobi', and 'auto' with lam != 0;
  mg        K6-mg (csrc/cg_fused.cu on csrc/mg_cycle.cuh), one launch per
            solve, on the mesh's own hierarchy and cycle
            (multigrid.mesh_levels: block-local coarsening down to
            MIN_LOCAL cells per shard side; gamma 2 on every transition,
            nu 2, nu_coarse 24, no de-mean: make_dist_mg_precond's):
            precond='mg', and 'auto' with lam = 0;
  redblack  K4a's sweep mode (stencils/redblack.py, csrc/rb_sweep.cu):
            solver_maxiter red-then-black sweeps at cfg.sor_omega in
            passes of up to RB_SWEEPS sweeps, no residual test, as
            _dist_redblack;
  eager     precond='ssor' has no kernel on the mesh: _dist_solve, eager
            over the shards, a route chosen by the configuration and
            named by describe(), never a fallback.

The sums of K6 run in its fixed order, not in the eager mesh's (per-shard
torch.sum, then the mesh sum): x agrees with the eager mesh solve to the
solver's tolerance and its iteration count within a few.  On CPU shards
the mesh's solve is the eager _dist_solve, the plain version;
`make_gathered_solve` runs the gathered route on CPU shards too, through
the kernels' plain versions, which is how the tests hold it.  On CUDA a
build or launch failure raises.

Shards on several cards: the right-hand side and the warm start of each
card's blocks are copied to the first card, and x back to each card, by
PyTorch's cross-device copies on the devices' current streams, which
order the two devices' streams against each other by events (the
phases' side streams are joined to the current streams after each K7
round, mesh.CardStreams); the other cards wait on those events, not on
the host.  Peer access between the first card and every other one is
required (RuntimeError otherwise); nothing is staged through the host.
"""

from __future__ import annotations

import dataclasses

import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid
from beom_tpu_torch.parallel.mesh import Mesh, Sharded, device_type, gather
from beom_tpu_torch.solvers import elliptic
from beom_tpu_torch.solvers import multigrid as mg

# the mesh's multigrid hierarchy stops at this many cells per shard side
# (multigrid.make_dist_mg_precond's min_local), its cycle is W at every
# transition
MIN_LOCAL = 8
MESH_GAMMA = 2
# sweeps per K4a launch of the red-black route
RB_SWEEPS = 8


def route(cfg: Config, lam: float) -> str:
    """The mesh solve's route for cfg and lam: 'jacobi', 'mg', 'redblack'
    or 'eager' (precond='ssor'); solver='mg' is refused under a mesh, as
    _dist_solve refuses it."""
    if cfg.solver == "redblack":
        return "redblack"
    if cfg.solver == "mg":
        raise NotImplementedError(
            "solver='mg' (standalone multigrid cycles) is single-device; "
            "under a mesh use solver='cg' with precond='mg'")
    pre = cfg.precond
    if pre == "auto":
        pre = "mg" if lam == 0.0 else "jacobi"
    if pre == "ssor":
        return "eager"
    if pre not in ("jacobi", "mg"):
        raise ValueError(f"unknown precond {pre!r}")
    return pre


def rb_passes(maxiter: int) -> list:
    """Sweeps of each K4a launch of the red-black route: maxiter in passes
    of RB_SWEEPS, the remainder last."""
    full, rest = divmod(maxiter, RB_SWEEPS)
    return [RB_SWEEPS] * full + ([rest] if rest else [])


def describe(cfg: Config, mesh_shape, lam: float) -> str:
    """The mesh solve's route and kernel for cfg on a mesh of mesh_shape =
    (NY, NX) shards."""
    r = route(cfg, lam)
    if r == "eager":
        return ("the eager mesh solve over the shards (parallel/dist.py::"
                "_dist_solve): precond='ssor' has no kernel on the mesh")
    where = ("on the gathered grid of the shards on the mesh's first card "
             "(the eager mesh solve on CPU shards)")
    if r == "jacobi":
        return f"K6-Jacobi (cg_jacobi.cu), one launch per solve, {where}"
    if r == "redblack":
        n = len(rb_passes(cfg.solver_maxiter))
        return (f"K4a's sweep mode (rb_sweep.cu), {n} launches of at most "
                f"{RB_SWEEPS} sweeps for {cfg.solver_maxiter}, {where}")
    shapes = mg.level_shapes((cfg.ny, cfg.nx), MIN_LOCAL, tuple(mesh_shape))
    return (f"K6-mg (cg_fused.cu) on the mesh's hierarchy, {len(shapes)} "
            f"levels {shapes[0]} to {shapes[-1]}, gamma {MESH_GAMMA} at "
            f"every transition, one launch per solve, {where}")


def gather_field(a: Sharded, cards, out: torch.Tensor) -> torch.Tensor:
    """The sharded 2-D field a in the global layout `out` (ny, nx): each
    card's blocks as one stacked part, copied to out's device and placed
    by one strided copy."""
    from beom_tpu_torch.stencils import dist_band

    NY, NX = a.mesh.shape["y"], a.mesh.shape["x"]
    ly, lx = a.shape[-2:]
    whole = out.view(NY, ly, NX, lx)
    for c in cards:
        part = dist_band.stack_part(a, c.shards).to(out.device)
        (j0, i0), (cmy, cmx) = c.origin, c.shape
        whole[j0:j0 + cmy, :, i0:i0 + cmx].copy_(
            part.view(cmy, cmx, ly, lx).transpose(1, 2))
    return out


def scatter_field(x: torch.Tensor, mesh: Mesh, cards) -> Sharded:
    """The global field x (ny, nx) as a sharded field whose blocks are
    views of each card's stacked part (dist_band.unstack_parts), the
    layout the shard kernels read without a copy."""
    from beom_tpu_torch.stencils import dist_band

    if len(cards) == 1:
        return dist_band.unstack(dist_band.stack_card(x, mesh, cards[0]),
                                 mesh)
    return dist_band.unstack_parts(
        [dist_band.stack_card(x, mesh, c).to(c.device) for c in cards], mesh,
        cards)


def _check_peers(cards) -> None:
    """Raise RuntimeError, naming the pair, where the first card and
    another cannot read each other's memory: the route copies between
    them in place."""
    home = torch.device(cards[0].device)
    for c in cards[1:]:
        d = torch.device(c.device)
        if d == home:
            continue
        for a, b in ((home, d), (d, home)):
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"{a} cannot read the memory of {b} (no peer access "
                    "between them): the mesh's solve gathers its shards "
                    "on the first card")


def make_gathered_solve(grid_l: Grid, cfg: Config, mesh: Mesh, lam: float,
                        cards=None):
    """solve(b, x0) -> x: the mesh's solve on the gathered grid of the
    shards (route(cfg, lam), not 'eager'), on the first of `cards`
    (dist_band.MeshKernels' cards, default the mesh's own).  On CUDA
    shards the kernels, on CPU shards their plain versions.  grid_l: the
    shards' unpadded statics.  solve.gathered(a) is the sharded a in the
    global layout on the first card, solve.kernel K6's solve of it (None
    for red-black), solve.levels the multigrid hierarchy (None but for
    'mg')."""
    from beom_tpu_torch.stencils import cg_fused, dist_band, redblack

    r = route(cfg, lam)
    if r == "eager":
        raise ValueError("precond='ssor' has no gathered route: the mesh "
                         "solves it eagerly (make_mesh_solve)")
    cards = dist_band._cards_of(mesh, cards)
    home = torch.device(cards[0].device)
    if home.type == "cuda":
        _check_peers(cards)
    grid = Grid(**{f.name: gather(getattr(grid_l, f.name), home)
                   for f in dataclasses.fields(Grid)})
    mask = grid.mask
    steps, k6, hierarchy = [], None, None
    if r == "redblack":
        Hu, Hv = [a.contiguous() for a in elliptic.face_depths(grid)]
        passes = rb_passes(cfg.solver_maxiter)

        def run(b, x0):
            b = b * mask
            x = torch.zeros_like(b) if x0 is None else x0 * mask
            for k in passes:
                x = redblack.rb_sweep(x, b, Hu, Hv, mask, cfg.dx, cfg.dy,
                                      lam=lam, k=k, omega=cfg.sor_omega)
            return x
    else:
        if r == "mg":
            hierarchy = (mg.mesh_levels(grid, cfg, lam, (
                mesh.shape["y"], mesh.shape["x"]), MIN_LOCAL), MESH_GAMMA)
        k6 = cg_fused.make_cg_solve(grid, cfg, lam=lam, precond=r,
                                    hierarchy=hierarchy)
        steps = k6.steps

        def run(b, x0):
            # no read-back of the iteration count: the host queues on
            return k6(b, x0, count=False).x

    def gathered(a: Sharded) -> torch.Tensor:
        return gather_field(a, cards, cg_fused.padded(mask.shape, mask))

    def solve(b: Sharded, x0=None) -> Sharded:
        return scatter_field(run(gathered(b), None if x0 is None
                                 else gathered(x0)), mesh, cards)

    solve.route, solve.steps, solve.gathered, solve.kernel = (r, steps,
                                                              gathered, k6)
    solve.levels = None if hierarchy is None else hierarchy[0]
    return solve


def make_mesh_solve(grid_l: Grid, grid_p1: Grid, cfg: Config, mesh: Mesh,
                    lam: float, cards=None):
    """solve(b, x0) -> x, the projection step's pressure solve of the
    fused mesh stepper, built once per stepper: on CUDA shards the
    gathered route on the card's kernels (make_gathered_solve), on CPU
    shards and for precond='ssor' the eager _dist_solve over the shards.
    grid_l / grid_p1: the shards' statics, unpadded and padded by 1.
    solve.route names the route ('eager' on CPU shards), solve.describe()
    it and its kernel."""
    from beom_tpu_torch.parallel import dist

    r = route(cfg, lam)
    if r == "eager" or device_type(mesh) == "cpu":
        def solve(b, x0=None):
            return dist._dist_solve(b, grid_l, grid_p1, cfg, lam=lam, x0=x0)
        solve.route = "eager"
        solve.steps = []
    else:
        solve = make_gathered_solve(grid_l, cfg, mesh, lam, cards)
    solve.describe = lambda: describe(
        cfg, (mesh.shape["y"], mesh.shape["x"]), lam)
    return solve
