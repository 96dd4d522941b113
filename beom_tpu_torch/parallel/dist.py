"""Distributed time stepping over a 2-D mesh of shards: the port's twin of
beom_tpu/parallel/dist.py.

Strategy ("a global roll equals a local roll on a halo-padded shard",
core/ops.py): the step halo-pads the prognostic fields with the neighbour
exchange of parallel/halo.py, runs the identical single-device step code
on the padded blocks against halo-padded static fields (grid and forcing,
padded once at setup), and crops the halo off the result.  The halo must
cover the stencil radius of one step:

    fb          required_halo: 5 (7 with the biharmonic; + 2 with wet/dry
                or the open boundary)
    split       the slow phase on the fb halo, then one 1-halo exchange of
                the three 2-D fields per substep: the halo does not grow
                with nsub
    rigid_lid / implicit_fs: the momentum radius for the provisional step,
                then inside CG a halo-pipelined matvec (thin edge slices)
                and one mesh reduction per iteration

The step code sees sharded fields (parallel/mesh.Sharded), which run it
once per shard; only the collectives cross shards.  `make_dist_stepper`
returns step_fn(state) -> state on a sharded State.  backend='fused' runs
all four schemes through the shard kernels (stencils/dist_band.py, K7): fb
and split wholly on the shards, rigid_lid and implicit_fs with the phase
kernels around this module's pressure_rhs and the mesh's solve on the card
on the gathered grid of the shards (stencils/mesh_solve.py: K6, or K4a's
sweeps); halo_impl='rdma' runs every pad2d of the eager tier through the
halo-pad kernel (stencils/halo_pad.py, K8).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State
from beom_tpu_torch.parallel import halo
from beom_tpu_torch.parallel.mesh import (Mesh, Sharded, _map_fields,
                                          shard_pytree)
from beom_tpu_torch.physics import continuity
from beom_tpu_torch.solvers import elliptic
from beom_tpu_torch.stepping import fb as fb_mod
from beom_tpu_torch.stepping import get_step, prepare_state
from beom_tpu_torch.stepping.projection import (barotropic_transport,
                                                warm_x0)


def required_halo(cfg: Config) -> int:
    """Stencil radius of one full step, per enabled term (the reference's
    measured cones: fb <= 3, biharmonic <= 4, wet/dry and Flather within
    the fb cone, + 2 margin for threshold flips).  The 1-vs-N equivalence
    tests are the ground truth."""
    base = 5
    if cfg.nu4 != 0.0:
        base += 2
    if cfg.wetdry or cfg.obc:
        base += 2
    # split: the slow phase's radius only; the subcycle exchanges its
    # three 2-D fields once per substep (_dist_split_step)
    return base


def _is_field(a) -> bool:
    return isinstance(a, (torch.Tensor, Sharded)) and a.ndim >= 2


def _pad_tree(tree, w):
    return _map_fields(tree, lambda a: halo.pad2d(a, w) if _is_field(a)
                       else a)


def _crop_tree(tree, w):
    return _map_fields(tree, lambda a: halo.crop2d(a, w) if _is_field(a)
                       else a)


def pad_statics(grid: Grid, forcing: Forcing, cfg: Config, mesh: Mesh,
                w: int):
    """Shard Grid / Forcing and halo-pad them once: each shard's block
    carries its own halo ring."""
    return (_pad_tree(shard_pytree(grid, mesh), w),
            _pad_tree(shard_pytree(forcing, mesh), w))


def _dist_padded_step(state: State, pgrid: Grid, pforcing: Forcing,
                      cfg: Config, w: int) -> State:
    """The generic pad-run-crop distributed step (fb)."""
    step = get_step(cfg)
    ps = State(h=halo.pad2d(state.h, w), u=halo.pad2d(state.u, w),
               v=halo.pad2d(state.v, w), t=state.t, n=state.n)
    out = step(ps, pgrid, pforcing, cfg)
    return State(h=halo.crop2d(out.h, w), u=halo.crop2d(out.u, w),
                 v=halo.crop2d(out.v, w), t=out.t, n=out.n)


def _edge_recv(p, axis: int, axis_name: str):
    """(recv_lo, recv_hi): the neighbour grid lines adjacent to each
    shard's low / high edge along `axis`, the same lines halo.pad_axis
    would deliver, as thin slices (one strip each way).  With one shard on
    the axis it is the local wrap."""
    lo = p.narrow(axis, 0, 1)
    hi = p.narrow(axis, p.shape[axis] - 1, 1)
    if p.mesh.shape[axis_name] == 1:
        return hi, lo
    return (halo.send(hi, axis_name, up=True),
            halo.send(lo, axis_name, up=False))


def _edge_fix(q, p, Hu, Hu_w, Hv, Hv_s, rdx2, rdy2, mask=None):
    """Patch the four 1-wide edge strips of a neighbour sum q evaluated
    with local periodic rolls, whose wrap used the wrong neighbour:

        q[:, -1] += Hu   (recv_e - p[:, 0])  / dx^2      (east edge)
        q[:, 0]  += Hu_w (recv_w - p[:, -1]) / dx^2      (west edge)

    and likewise in y (times `mask` where given).  The 5-point operator
    has no corner coupling, so the two axes are independent."""
    E, Wst = (slice(None), slice(-1, None)), (slice(None), slice(0, 1))
    N, S = (slice(-1, None), slice(None)), (slice(0, 1), slice(None))
    if p.mesh.shape["x"] > 1:
        recv_w, recv_e = _edge_recv(p, 1, "x")
        ce = Hu[E] * (recv_e - p[Wst]) * rdx2
        cw = Hu_w[Wst] * (recv_w - p[E]) * rdx2
        if mask is not None:
            ce, cw = mask[E] * ce, mask[Wst] * cw
        q[E].add_(ce)
        q[Wst].add_(cw)
    if p.mesh.shape["y"] > 1:
        recv_s, recv_n = _edge_recv(p, 0, "y")
        cn = Hv[N] * (recv_n - p[S]) * rdy2
        cs = Hv_s[S] * (recv_s - p[N]) * rdy2
        if mask is not None:
            cn, cs = mask[N] * cn, mask[S] * cs
        q[N].add_(cn)
        q[S].add_(cs)
    return q


def _local_faces(grid_p1: Grid):
    """(Hu, Hv, Hu_w, Hv_s) on the local block from the 1-halo statics."""
    Hu_p, Hv_p = elliptic.face_depths(grid_p1)
    return (halo.crop2d(Hu_p, 1), halo.crop2d(Hv_p, 1),
            halo.crop2d(ops.sxm(Hu_p), 1), halo.crop2d(ops.sym(Hv_p), 1))


def _cg_matvec(p, grid_p1: Grid, cfg: Config, lam: float):
    """Distributed A p, halo-pipelined: the Laplacian is evaluated on the
    unpadded local block with periodic rolls, which depends on no
    exchange, and only the four 1-wide edge strips, whose local wrap used
    the wrong neighbour, are patched from thin exchanged slices
    (_edge_fix).  A test pins that only thin slices move."""
    rdx2, rdy2 = 1.0 / cfg.dx ** 2, 1.0 / cfg.dy ** 2
    Hu, Hv, Hu_w, Hv_s = _local_faces(grid_p1)
    mask = halo.crop2d(grid_p1.mask, 1)

    q = (Hu * ops.sxp(p) + Hu_w * ops.sxm(p)
         - (Hu + Hu_w) * p) * rdx2 \
        + (Hv * ops.syp(p) + Hv_s * ops.sym(p)
           - (Hv + Hv_s) * p) * rdy2
    if lam != 0.0:
        q = q - lam * p
    q = q * mask
    return _edge_fix(q, p, Hu, Hu_w, Hv, Hv_s, rdx2, rdy2, mask=mask)


def _make_mg_nbr():
    """nbr(lv, p) of the distributed multigrid (make_dist_mg_precond): the
    off-diagonal neighbour sum, halo-pipelined like _cg_matvec.  lv.Hu_w /
    lv.Hv_s hold the exchanged true west / south faces
    (build_dist_levels), so only the neighbour values need patching."""
    def nbr(lv, p):
        nb = (lv.Hu * ops.sxp(p) + lv.Hu_w * ops.sxm(p)) * lv.rdx2 \
            + (lv.Hv * ops.syp(p) + lv.Hv_s * ops.sym(p)) * lv.rdy2
        return _edge_fix(nb, p, lv.Hu, lv.Hu_w, lv.Hv, lv.Hv_s, lv.rdx2,
                         lv.rdy2)
    return nbr


def _global_checkerboard(shape, dtype, mesh: Mesh) -> Sharded:
    """Red cells of the global checkerboard on every local block: each
    shard offsets its local indices by its mesh coordinates."""
    ny_l, nx_l = shape[-2:]
    blocks = []
    for s, dev in enumerate(mesh.devices):
        cj, ci = mesh.coords(s)
        jj = torch.arange(ny_l, device=dev)[:, None] + cj * ny_l
        ii = torch.arange(nx_l, device=dev)[None, :] + ci * nx_l
        blocks.append((((ii + jj) % 2) == 0).to(dtype).expand(shape)
                      .contiguous())
    return Sharded(blocks, mesh)


def _dist_redblack(b, grid_l: Grid, grid_p1: Grid, cfg: Config, lam=0.0,
                   x0=None):
    """Red-black SOR with halo-pipelined neighbour sums per half-sweep and
    no global reduction at all: each half-sweep computes the local 5-point
    neighbour sum with periodic rolls and patches the four 1-wide edge
    strips (_edge_fix).  The checkerboard colouring is global."""
    Hu_p, Hv_p = elliptic.face_depths(grid_p1)
    rdx2, rdy2 = 1.0 / cfg.dx ** 2, 1.0 / cfg.dy ** 2
    inv_diag = halo.crop2d(elliptic._rb_inv_diag(Hu_p, Hv_p, rdx2, rdy2,
                                                 lam), 1)
    omega = cfg.sor_omega
    board = _global_checkerboard(b.shape, b.dtype, b.mesh)
    red = board * grid_l.mask
    black = (1.0 - board) * grid_l.mask
    Hu, Hv, Hu_w, Hv_s = _local_faces(grid_p1)

    b = b * grid_l.mask
    x = torch.zeros_like(b) if x0 is None else x0 * grid_l.mask

    def halfsweep(x, colour):
        nb = (Hu * ops.sxp(x) + Hu_w * ops.sxm(x)) * rdx2 \
            + (Hv * ops.syp(x) + Hv_s * ops.sym(x)) * rdy2
        nb = _edge_fix(nb, x, Hu, Hu_w, Hv, Hv_s, rdx2, rdy2)
        x_gs = (b - nb) * inv_diag
        return torch.where(colour > 0, (1.0 - omega) * x + omega * x_gs,
                           x) * grid_l.mask

    for _ in range(cfg.solver_maxiter):
        x = halfsweep(x, red)
        x = halfsweep(x, black)
    return x


def _dist_solve(b, grid_l: Grid, grid_p1: Grid, cfg: Config, lam=0.0,
                x0=None):
    if cfg.solver == "redblack":
        return _dist_redblack(b, grid_l, grid_p1, cfg, lam=lam, x0=x0)
    if cfg.solver == "mg":
        raise NotImplementedError(
            "solver='mg' (standalone multigrid cycles) is single-device; "
            "under a mesh use solver='cg' with precond='mg' (the "
            "distributed multigrid-preconditioned CG, one reduction per "
            "iteration)")
    return _dist_cg(b, grid_l, grid_p1, cfg, lam=lam, x0=x0).x


def _dist_cg(b, grid_l: Grid, grid_p1: Grid, cfg: Config, lam=0.0,
             x0=None) -> elliptic.CGResult:
    """_dist_solve's CG with cfg.precond: the whole CGResult."""
    kw = {}
    pre = cfg.precond
    if pre == "auto":
        pre = "mg" if lam == 0.0 else "jacobi"
    if pre == "mg":
        # distributed geometric multigrid: block-local face coarsening
        # keeps every level on the same mesh
        from beom_tpu_torch.solvers import multigrid
        kw["precond"] = multigrid.make_dist_mg_precond(
            grid_p1, cfg, lam, pad=halo.pad2d, crop=halo.crop2d,
            gsum=lambda a: halo.psum2(torch.sum(a)),
            red_fn=functools.partial(_global_checkerboard, mesh=b.mesh),
            nbr=_make_mg_nbr())
    elif pre == "ssor":
        red = _global_checkerboard(b.shape, b.dtype, b.mesh) * grid_l.mask
        kw["precond"] = elliptic.make_ssor_precond(
            grid_p1, cfg, lam=lam,
            pad1=lambda a: halo.pad2d(a, 1),
            crop1=lambda a: halo.crop2d(a, 1), red=red)
    _, inv_diag_p1 = elliptic.jacobi_diag(grid_p1, cfg, lam)
    return elliptic.cg_solve(
        b, grid_l, cfg, x0=x0, lam=lam, dot=halo.dist_dot,
        dots=halo.dist_dots,
        matvec=functools.partial(_cg_matvec, grid_p1=grid_p1, cfg=cfg,
                                 lam=lam),
        inv_diag=halo.crop2d(inv_diag_p1, 1), **kw)


def pressure_lam(cfg: Config) -> float:
    """lam of the projection step's elliptic operator div(H grad) - lam:
    0 for the rigid lid, 1 / (g dt^2) for the implicit free surface."""
    if cfg.scheme == "rigid_lid":
        return 0.0
    return 1.0 / (cfg.g * cfg.dt * cfg.dt)


def pressure_rhs(state: State, divU, grid_l: Grid, cfg: Config):
    """(rhs, x0) of the projection step's elliptic solve on the mesh from
    div(U*): the rigid lid's right-hand side with its anomaly de-meaned
    over the wet cells (two mesh reductions), or the implicit free
    surface's Helmholtz problem; x0 the warm start from the carry (for
    the implicit free surface eta^n where there is none).  grid_l is the
    local statics."""
    dt = cfg.dt
    warm = warm_x0(state, cfg)
    if cfg.scheme == "rigid_lid":
        anom = (torch.sum(state.h, dim=0) - grid_l.H) * grid_l.mask
        anom = anom - grid_l.mask * (halo.dist_dot(anom, grid_l.mask)
                                     / halo.dist_dot(grid_l.mask,
                                                     grid_l.mask))
        return (divU - anom / dt) / dt, warm
    eta_n = (torch.sum(state.h, dim=0) - grid_l.H) * grid_l.mask
    rhs = -pressure_lam(cfg) * (eta_n - dt * divU)
    return rhs, eta_n if warm is None else warm


def solve_pressure(state: State, divU, grid_l: Grid, grid_p1: Grid,
                   cfg: Config):
    """The eager mesh step's elliptic solve: pressure_rhs's problem solved
    by _dist_solve, eager over the shards (the fused mesh stepper solves
    the same problem on the card, stencils/mesh_solve.py).  grid_l is the
    local statics, grid_p1 the statics padded by 1."""
    rhs, x0 = pressure_rhs(state, divU, grid_l, cfg)
    return _dist_solve(rhs, grid_l, grid_p1, cfg, lam=pressure_lam(cfg),
                       x0=x0)


def _dist_projection_step(state: State, pgrid: Grid, pforcing: Forcing,
                          cfg: Config, w: int) -> State:
    """Distributed rigid-lid / implicit-FS step: stepping/projection.py
    with explicit halo plumbing.  The provisional momentum on the w-padded
    block, the elliptic solve with the pipelined matvec and the mesh
    dots, the correction and the continuity on small pads."""
    dt = cfg.dt
    grid_l = _crop_tree(pgrid, w)        # local unpadded statics
    grid_p1 = _crop_tree(pgrid, w - 1)   # 1-halo statics for the solve
    rigid = cfg.scheme == "rigid_lid"

    # --- provisional momentum on the padded block ----------------------
    ps = State(h=halo.pad2d(state.h, w), u=halo.pad2d(state.u, w),
               v=halo.pad2d(state.v, w), t=state.t, n=state.n)
    u_sp, v_sp = fb_mod.momentum_update(ps.h, ps, pgrid, pforcing, cfg,
                                        free_surface=False)

    # --- elliptic right-hand side (valid on the local block) -----------
    Up, Vp = barotropic_transport(ps.h, u_sp, v_sp, pgrid)
    divU_p = (ops.d_xm(Up, cfg.dx) + ops.d_ym(Vp, cfg.dy)) * pgrid.mask
    divU = halo.crop2d(divU_p, w)

    phi = solve_pressure(state, divU, grid_l, grid_p1, cfg)
    gfac = dt if rigid else cfg.g * dt

    # --- barotropic correction (1-halo gradient) ------------------------
    phi_p1 = halo.pad2d(phi, 1)
    dphix = halo.crop2d(ops.d_xp(phi_p1, cfg.dx), 1) * grid_l.mask_u
    dphiy = halo.crop2d(ops.d_yp(phi_p1, cfg.dy), 1) * grid_l.mask_v
    u_s = halo.crop2d(u_sp, w)
    v_s = halo.crop2d(v_sp, w)
    u1 = (u_s - gfac * dphix[None]) * grid_l.mask_u
    v1 = (v_s - gfac * dphiy[None]) * grid_l.mask_v

    # --- layer continuity + finalize on a small pad ---------------------
    out = _dist_continuity_finalize(state, state.h, u1, v1, pgrid,
                                    pforcing, cfg, w)
    if state.phi is not None:
        out = out.replace(phi=phi, phi_prev=state.phi)
    return out


def _dist_continuity_finalize(state: State, h, u1, v1, pgrid: Grid,
                              pforcing: Forcing, cfg: Config, w: int,
                              h1_override=None) -> State:
    """The shared tail: per-layer continuity with (u1, v1) from thickness
    h (skipped when h1_override is given), then the wet/dry gates and
    Flather, all on a small exchanged pad (radius <= 4)."""
    w2 = 4
    grid_w2 = _crop_tree(pgrid, w - w2)
    forcing_w2 = _crop_tree(pforcing, w - w2)
    up = halo.pad2d(u1, w2)
    vp = halo.pad2d(v1, w2)
    if h1_override is None:
        hp = halo.pad2d(h, w2)
        dh = continuity.continuity_rhs(hp, up, vp, grid_w2, cfg)
        h1p = (hp + cfg.dt * dh) * grid_w2.mask
    else:
        h1p = halo.pad2d(h1_override, w2) * grid_w2.mask
    outp = fb_mod.finalize(h1p, up, vp, state, grid_w2, forcing_w2, cfg)
    return State(h=halo.crop2d(outp.h, w2), u=halo.crop2d(outp.u, w2),
                 v=halo.crop2d(outp.v, w2), t=outp.t, n=outp.n)


def _dist_split_step(state: State, pgrid: Grid, pforcing: Forcing,
                     cfg: Config, w: int) -> State:
    """Distributed split step: the slow phase padded once on the fb halo,
    then the barotropic subcycle with one 2-D-field halo exchange per
    substep (radius-1 hooks): the halo does not grow with nsub."""
    from beom_tpu_torch.stepping import split as split_mod

    grid_l = _crop_tree(pgrid, w)
    ps = State(h=halo.pad2d(state.h, w), u=halo.pad2d(state.u, w),
               v=halo.pad2d(state.v, w), t=state.t, n=state.n)
    sp_p = split_mod.slow_phase(ps, pgrid, pforcing, cfg)
    sp = split_mod.SlowPhase(*[halo.crop2d(a, w) for a in sp_p])

    eta_f, ubar_f, vbar_f, ub_a, vb_a = split_mod.subcycle_phase(
        sp, grid_l, cfg,
        pad1=lambda a: halo.pad2d(a, 1),
        crop1=lambda a: halo.crop2d(a, 1))

    # recompose: u1 / v1 and the column rescale are pointwise; only the
    # continuity advection needs a small pad
    dt = cfg.dt
    u1 = ((sp.up + dt * sp.du_p + ubar_f[None])
          / (1.0 + dt * sp.cu)) * grid_l.mask_u
    v1 = ((sp.vp + dt * sp.dv_p + vbar_f[None])
          / (1.0 + dt * sp.cv)) * grid_l.mask_v

    w2 = 4
    grid_w2 = _crop_tree(pgrid, w - w2)
    u_adv = (halo.pad2d(sp.up, w2)
             + halo.pad2d(ub_a, w2)[None]) * grid_w2.mask_u
    v_adv = (halo.pad2d(sp.vp, w2)
             + halo.pad2d(vb_a, w2)[None]) * grid_w2.mask_v
    hp = halo.pad2d(state.h, w2)
    dh = continuity.continuity_rhs(hp, u_adv, v_adv, grid_w2, cfg)
    h1 = halo.crop2d((hp + dt * dh) * grid_w2.mask, w2)

    col = torch.clamp_min(ops.sum_k(h1), cfg.h_min)
    target = torch.clamp_min(grid_l.H + eta_f, 0.0) * grid_l.mask
    h1 = h1 * torch.where(col > cfg.h_min, target / col, 1.0)[None]

    return _dist_continuity_finalize(state, state.h, u1, v1, pgrid,
                                     pforcing, cfg, w, h1_override=h1)


def make_dist_stepper(grid: Grid, forcing: Forcing, cfg: Config, mesh: Mesh,
                      n_inner: int = 1, cards=None) -> Callable:
    """step_fn(state) -> state on a sharded State, advancing n_inner
    passes of cfg.steps_per_pass steps per call.

    backend='fused' runs the shard kernels (K7) for every scheme, one
    launch per card of the mesh (`cards`: dist_band.MeshKernels'): fb and
    split through make_dist_fused_stepper, rigid_lid and implicit_fs
    through make_dist_fused_projection_stepper (the phase kernels around
    pressure_rhs and the mesh's solve on the card,
    stencils/mesh_solve.py).  backend='eager' runs the halo-exchanging
    steps above, every pad2d through cfg.halo_impl.
    """
    if cfg.backend == "fused":
        from beom_tpu_torch.stencils import dist_band
        make = dist_band.make_dist_fused_stepper
        if cfg.scheme in ("rigid_lid", "implicit_fs"):
            make = dist_band.make_dist_fused_projection_stepper
        pass_fn = make(grid, forcing, cfg, mesh, cards=cards)

        def fused_fn(state):
            for _ in range(n_inner):
                state = pass_fn(state)
            return state

        return fused_fn

    w = max(cfg.halo, required_halo(cfg))
    ny_l = cfg.ny // mesh.shape["y"]
    nx_l = cfg.nx // mesh.shape["x"]
    if w > ny_l or w > nx_l:
        raise ValueError(
            f"halo {w} exceeds local block ({ny_l}, {nx_l}); use fewer "
            "devices or a larger grid")
    pgrid, pforcing = pad_statics(grid, forcing, cfg, mesh, w)

    if cfg.scheme in ("rigid_lid", "implicit_fs"):
        inner = functools.partial(_dist_projection_step, cfg=cfg, w=w)
    elif cfg.scheme == "split":
        inner = functools.partial(_dist_split_step, cfg=cfg, w=w)
    else:
        inner = functools.partial(_dist_padded_step, cfg=cfg, w=w)

    def step_fn(state):
        state = prepare_state(state, cfg)   # attach the phi carry if needed
        with halo.impl(cfg.halo_impl):
            for _ in range(n_inner * cfg.steps_per_pass):
                state = inner(state, pgrid=pgrid, pforcing=pforcing)
        return state

    return step_fn
