"""The whole preconditioned CG solve in one launch (K6) and its plain
PyTorch version.

Two CUDA kernels replace the TPU kernel
beom_tpu/stencils/cg_vmem.py::_cg_kernel: the single-reduction
Chronopoulos-Gear CG of solvers/elliptic.cg_solve, with its nullspace
deflation for lam = 0, runs to convergence in one cooperative launch with
grid-wide syncs.  `csrc/cg_jacobi.cu` takes the Jacobi preconditioner: one
pass over tiles of the grid and one grid sync per iteration, the pointwise
updates of the next iteration fused into the matvec (its pass schedule is
emulated on the host by `cg_solve_tiled`).  `csrc/cg_fused.cu` takes one
multigrid cycle per iteration (by default the fused gamma schedule on
the levels of min_size 16; the caller's levels and gamma where given, as
the mesh's solve gives its hierarchy; nu = 2, nu_coarse = 24, no
de-mean; walked in the kernel as
stencils/mg_coarse.py flattens it: two tiled passes per visit of a level
above the shared-memory tier, the tier's levels on one CTA).  The
reference keeps the solver state in VMEM and so runs the kernel only up
to about 1024^2 f32; here the state lives in device memory and the
kernels run at every size.

`make_cg_solve(...)` returns solve(b, x0=None) -> CGResult.  CPU tensors
take the plain version, `cg_solve_plain` (elliptic.cg_solve with the
Jacobi preconditioner or the eager cycle); CUDA tensors take a kernel or
raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid
from beom_tpu_torch.solvers import elliptic
from beom_tpu_torch.solvers import multigrid as mg
from beom_tpu_torch.solvers.elliptic import CGResult

# kernel launches made by the solves; a run reads it to show that its
# main path went through the kernel
LAUNCHES = 0

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_NDOT = 6          # partial sums per CTA (csrc/mg_cycle.cuh NDOT)
# the in-kernel multigrid cycle (the reference's make_vmem_cg_solve)
MG_NU, MG_NU_COARSE, MG_MIN_SIZE = 2, 24, 16
# the Jacobi kernel's staging (csrc/cg_jacobi.cu): NPLANE planes of a
# tile's ext rows in at most SMEM_TILE bytes and MAX_EXT_ROWS rows, each row
# as 16-byte chunks; the planner's cost of a tile beyond its points, and
# of a row beyond its width (a row starts mid-sector: 32-byte sectors of 8
# float32 values)
NPLANE, SMEM_TILE, MAX_EXT_ROWS = 8, 100 * 1024, 128
TILE_COST, ROW_COST = 128, 7
# the H100's resident CTAs of the Jacobi kernel (132 SMs, one each): the
# tile plan the CPU emulation takes by default
H100_CTAS = 132


def mg_levels(grid: Grid, cfg: Config, lam):
    """(levels, gamma) of the kernel's multigrid preconditioner."""
    levels = mg.build_levels(grid, cfg, lam, min_size=MG_MIN_SIZE)
    return levels, mg.fused_gamma_schedule(levels, 2)


def cg_solve_plain(b, grid: Grid, cfg: Config, x0=None, lam=0.0,
                   tol: Optional[float] = None,
                   maxiter: Optional[int] = None,
                   precond: str = "jacobi", hierarchy=None) -> CGResult:
    """The plain version of the kernels: elliptic.cg_solve with Jacobi, or
    with one eager cycle on hierarchy = (levels, gamma) (default
    mg_levels) as the preconditioner."""
    pre = None
    if precond == "mg":
        levels, gamma = hierarchy or mg_levels(grid, cfg, lam)
        pre = mg.cycle_precond(levels, lam, MG_NU, MG_NU_COARSE, gamma)
    return elliptic.cg_solve(b, grid, cfg, x0=x0, lam=lam, tol=tol,
                             maxiter=maxiter, precond=pre)


def row_stride(w: int, itemsize: int) -> int:
    """Elements of a staged row of a tile w columns wide (the kernel's
    row_stride): the 16-byte chunks of its columns and halo, two more for
    the halo columns that wrap."""
    vec = 16 // itemsize
    return vec * ((w + 2 * vec) // vec + 2)


@functools.lru_cache(maxsize=None)
def tile_plan(ny: int, nx: int, ctas: int, itemsize: int):
    """(nty, ntx): the Jacobi kernel's tiles, nty x ntx of balanced sizes
    (tile (ty, tx) owns rows [ty ny // nty, (ty + 1) ny // nty) and the
    same split of the columns), each staged with its halo in the kernel's
    shared memory.  The CTAs take tiles t, t + ctas, ...; the plan
    minimises the rounds of tiles times the largest tile's cost (its
    points with the halo, a row's partial sector, a tile's fixed cost),
    then the tile count."""
    best = None
    for ntx in range(1, nx + 1):
        wmax = -(-nx // ntx)
        rows = SMEM_TILE // (NPLANE * row_stride(wmax, itemsize) * itemsize)
        hmax_fit = min(rows, MAX_EXT_ROWS) - 2
        if hmax_fit < 1:
            continue
        # from the fewest rows of tiles that fit to at most 8 rounds
        lo = -(-ny // hmax_fit)
        nty = np.arange(lo, max(lo, min(ny, 8 * ctas // ntx)) + 1)
        hmax = -(-ny // nty)
        rounds = -(-(nty * ntx) // ctas)
        cost = rounds * ((hmax + 2) * (wmax + 2 + ROW_COST) + TILE_COST)
        k = int(np.lexsort((nty * ntx, cost))[0])
        cand = (int(cost[k]), int(nty[k]) * ntx, int(nty[k]), ntx)
        if best is None or cand < best:
            best = cand
    if best is None:
        raise ValueError(f"no tile plan for {ny} x {nx}")
    return best[2], best[3]


def tile_bounds(n: int, nt: int, t: int):
    """[start, stop) of tile t of nt over n points (the kernel's Tile)."""
    return t * n // nt, (t + 1) * n // nt


def padded(shape, like):
    """An uninitialised tensor of `shape` whose storage starts on 16
    bytes and runs 16 bytes past its end: the Jacobi kernel stages its
    fields in 16-byte chunks."""
    n = int(np.prod(shape))
    buf = torch.empty(n + 16 // like.element_size(), dtype=like.dtype,
                      device=like.device)
    return buf[:n].view(shape)


def jacobi_operands(grid: Grid, cfg: Config, lam):
    """(Hu, Hv, pm) of the Jacobi kernel, pm = inv_diag * mask, in padded
    storage; raises unless the mask is 0/1 and pm != 0 exactly where it
    is 1 (the kernel reads the mask as pm != 0)."""
    mask = grid.mask
    Hu, Hv = elliptic.face_depths(grid)
    _, inv_diag = elliptic.jacobi_diag(grid, cfg, lam)
    pm = inv_diag * mask
    if not bool(((mask == 0) | (mask == 1)).all()) \
            or not torch.equal(pm != 0, mask != 0):
        raise ValueError("fused CG: the Jacobi kernel needs a 0/1 mask with "
                         "inv_diag != 0 at wet cells")
    out = []
    for t in (Hu, Hv, pm):
        out.append(padded(t.shape, t))
        out[-1].copy_(t)
    return out


def cg_solve_tiled(b, grid: Grid, cfg: Config, x0=None, lam=0.0,
                   tol: Optional[float] = None,
                   maxiter: Optional[int] = None, tiles=None,
                   record=None) -> CGResult:
    """A host emulation of csrc/cg_jacobi.cu's schedule, in its order of
    operations (not its order of sums): the set-up, then one pass per
    iteration over the nty x ntx tiles of `tiles` (default the H100's
    plan), each recomputing u' = pm r' on its tile and one-cell halo from
    bank `pass % 2` of r, w and s, writing its own points of the other
    bank of r, w, s and p, and w' = A u' from the halo tile; x takes two
    passes' steps on odd passes, rounded as one pass at a time would.
    record(pass, tile, rows, cols, u_ext), if given, sees each tile's u'
    with its halo (rows and cols: the global indices).  The tests hold it
    against cg_solve_plain and the reference's VMEM kernel; the main path
    never calls it."""
    dtype = b.dtype
    ny, nx = b.shape
    tol = max(cfg.solver_tol if tol is None else tol,
              30.0 * float(torch.finfo(dtype).eps))
    maxiter = cfg.solver_maxiter if maxiter is None else maxiter
    nty, ntx = tile_plan(ny, nx, H100_CTAS, b.element_size()) \
        if tiles is None else tiles
    Hu, Hv, pm = jacobi_operands(grid, cfg, lam)
    m = (pm != 0).to(dtype)
    deflate = lam == 0.0
    rdx, rdy = 1.0 / cfg.dx, 1.0 / cfg.dy
    tiny = torch.finfo(dtype).tiny
    x0 = torch.zeros_like(b) if x0 is None else x0

    def lap(qc, qe, qw, qn, qs, hu, huw, hv, hvs):
        out = (hu * ((qe - qc) * rdx) - huw * ((qc - qw) * rdx)) * rdx \
            + (hv * ((qn - qc) * rdy) - hvs * ((qc - qs) * rdy)) * rdy
        return out - lam * qc if lam != 0.0 else out

    def shifted(a, dy, dx):
        return torch.roll(a, (-dy, -dx), (0, 1))

    def safe_div(num, den):
        mag = max(abs(den), tiny)
        return num / (-mag if den < 0 else mag)

    nwet, bmean, xmean = 1.0, 0.0, 0.0
    if deflate:
        nwet = max(float((m * m).sum()), 1.0)
        bmean = float(((b * m) * m).sum()) / nwet
        xmean = float((x0 * m).sum()) / nwet

    def defl(v, mean):
        return (v - m * mean) * m if deflate else v * m

    x = defl(x0, xmean)
    bd = defl(b * m, bmean)
    ax = lap(x, shifted(x, 0, 1), shifted(x, 0, -1), shifted(x, 1, 0),
             shifted(x, -1, 0), Hu, shifted(Hu, 0, -1), Hv,
             shifted(Hv, -1, 0)) * m
    r = [(bd - ax) * m, torch.empty_like(b)]
    w = [torch.zeros_like(b), torch.empty_like(b)]
    s = [torch.zeros_like(b), torch.empty_like(b)]
    p = [torch.zeros_like(b), torch.empty_like(b)]
    threshold = (tol * tol) * max(float((bd * bd).sum()), tiny)

    alpha = alpha_prev = beta = gamma = rr = rmean = umean = 0.0
    k = 0
    for pas in range(maxiter + 1):
        src, dst = pas % 2, 1 - pas % 2
        v = [0.0] * 6
        for ty in range(nty):
            y0, y1 = tile_bounds(ny, nty, ty)
            rows = torch.arange(y0 - 1, y1 + 1) % ny
            for tx in range(ntx):
                x0_, x1_ = tile_bounds(nx, ntx, tx)
                cols = torch.arange(x0_ - 1, x1_ + 1) % nx

                def ext(a):
                    return a[rows][:, cols]

                r0, w0, s0, pme = ext(r[src]), ext(w[src]), ext(s[src]), \
                    ext(pm)
                me = (pme != 0).to(dtype)
                u0 = pme * r0
                ri = (r0 - rmean * me) * me if deflate else r0 * me
                ui = (u0 - umean * me) * me if deflate else u0 * me
                si = w0 + beta * s0
                rn = ri - alpha * si
                un = pme * rn
                if record is not None:
                    record(pas, (ty, tx), rows, cols, un)
                own = (slice(y0, y1), slice(x0_, x1_))
                o = (slice(1, -1), slice(1, -1))
                pi = ui[o] + beta * p[src][own]
                p[dst][own] = pi
                if src:
                    x[own] = (x[own] + alpha_prev * p[src][own]) \
                        + alpha * pi
                s[dst][own] = si[o]
                r[dst][own] = rn[o]
                hu, hv = ext(Hu), ext(Hv)
                qc = un[o]
                wn = lap(qc, un[1:-1, 2:], un[1:-1, :-2], un[2:, 1:-1],
                         un[:-2, 1:-1], hu[o], hu[1:-1, :-2], hv[o],
                         hv[:-2, 1:-1]) * me[o]
                w[dst][own] = wn
                for j, t in enumerate((rn[o] * qc, wn * qc, rn[o] * rn[o],
                                       rn[o] * me[o], qc * me[o],
                                       wn * me[o])):
                    v[j] += float(t.sum())
        alpha_prev = alpha
        gamma_n, delta, rr_n = v[0], v[1], v[2]
        if deflate:
            gamma_n = v[0] - v[3] * v[4] / nwet
            delta = v[1] - v[5] * v[4] / nwet
            rr_n = v[2] - v[3] * v[3] / nwet
            rmean, umean = v[3] / nwet, v[4] / nwet
        if pas == 0:
            alpha, beta = safe_div(gamma_n, delta), 0.0
        else:
            beta_n = safe_div(gamma_n, gamma)
            alpha = safe_div(gamma_n,
                             delta - beta_n * safe_div(gamma_n, alpha))
            beta = beta_n
            k += 1
        gamma, rr = gamma_n, rr_n
        if not (k < maxiter and rr > threshold):
            break
    if pas % 2 == 0:        # the last pass's step
        x = x + alpha_prev * p[1]
    return CGResult(x=x * m, iters=k,
                    resnorm=torch.tensor(rr, dtype=dtype))


def _lib(name: str, dtype, argtypes):
    """The library `name` and its entry for dtype, with its arguments."""
    from beom_tpu_torch.stencils import build

    lib = build.load(name)
    fn = getattr(lib, f"beom_{name}_{_DTYPES[dtype]}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _query(name: str, what: str, dtype) -> int:
    """A launch-shape query of library `name` on the current device."""
    from beom_tpu_torch.stencils import build

    lib = build.load(name)
    q = getattr(lib, f"beom_{name}_{what}_{_DTYPES[dtype]}")
    q.argtypes = [ctypes.POINTER(ctypes.c_int)]
    q.restype = ctypes.c_int
    n = ctypes.c_int(0)
    build.check(lib, q(ctypes.byref(n)), f"{name} {what} query")
    return n.value


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# b x0 Hu Hv pm x p0 p1 r0 r1 w0 w1 s0 s1 partials iters resnorm; ny nx
# maxiter deflate nty ntx blocks; inv_dx inv_dy lam tol2 tiny; stamps stream
_JACOBI_ARGS = [_P] * 17 + [_I] * 7 + [_D] * 5 + [_P] * 2
# b x0 Hu Hv mask x r u w p s partials; partials_len; iters resnorm; ny nx
# maxiter deflate; inv_dx inv_dy lam tol2 tiny; the cycle's tables (4
# pointers, 5 ints); bc0 stamps stream
_MG_ARGS = [_P] * 12 + [_I] + [_P] * 2 + [_I] * 4 + [_D] * 5 + [_P] * 4 \
    + [_I] * 5 + [_P] * 3


def make_cg_solve(grid: Grid, cfg: Config, lam: float = 0.0,
                  precond: Optional[str] = None,
                  tol: Optional[float] = None,
                  maxiter: Optional[int] = None, hierarchy=None):
    """solve(b, x0=None) -> CGResult, the whole preconditioned CG in one
    kernel launch.  precond: the cfg.precond='auto' rule by default (mg
    for the lam = 0 solve, jacobi otherwise); 'ssor' is not offered in the
    kernel and becomes 'jacobi', as in the reference.  hierarchy: the
    multigrid cycle's (levels, gamma), default mg_levels (the mesh's solve
    gives multigrid.mesh_levels with gamma 2).  solve.steps is the
    multigrid cycle's flattened step list (empty with Jacobi), on the CPU
    the H100's.  solve(..., stamps=stamps.Stamps()) is the launch's
    opt-in timing mode (stencils/stamps.py); solve(..., count=False) does
    not read the iteration count back (CGResult.iters None on CUDA), so
    the call returns without waiting for the card."""
    from beom_tpu_torch.stencils.mg_coarse import (BC, H100_SMEM, XC,
                                                   CycleTables, plan)

    precond = cfg.precond if precond is None else precond
    if precond == "auto":
        precond = "mg" if lam == 0.0 else "jacobi"
    if precond == "ssor":
        precond = "jacobi"
    if precond not in ("jacobi", "mg"):
        raise ValueError(f"unknown precond {precond!r}")
    use_mg = precond == "mg"
    mask = grid.mask
    dtype = mask.dtype
    tol_eff = max(cfg.solver_tol if tol is None else tol,
                  30.0 * float(torch.finfo(dtype).eps))
    maxiter = cfg.solver_maxiter if maxiter is None else maxiter
    on_cpu = mask.device.type == "cpu"
    if not on_cpu:
        if mask.device.type != "cuda":
            raise NotImplementedError(
                f"the fused CG runs on cuda or cpu, not {mask.device.type}")
        if dtype not in _DTYPES:
            raise ValueError(f"fused CG: dtype {dtype}")
    steps, levels = [], None
    if use_mg:
        levels, gamma = hierarchy or mg_levels(grid, cfg, lam)
        if on_cpu:
            smem = H100_SMEM
        else:
            with torch.cuda.device(mask.device):
                smem = _query("cg_fused", "smem", dtype)
        tier, steps = plan(levels, lam, MG_NU, MG_NU_COARSE, gamma, False,
                           smem)
    if not on_cpu:
        # everything a launch needs but its vectors, once: the library,
        # the grid it launches, the statics, the scalar arguments
        with torch.cuda.device(mask.device):
            if use_mg:
                Hu, Hv = elliptic.face_depths(grid)
                statics = [t.contiguous() for t in (Hu, Hv, mask)]
                tables = CycleTables(levels, steps, MG_NU, tier)
                ctas = _query("cg_fused", "blocks", dtype)
                lib, fn = _lib("cg_fused", dtype, _MG_ARGS)
            else:
                statics = jacobi_operands(grid, cfg, lam)
                ctas = _query("cg_jacobi", "ctas", dtype)
                nty, ntx = tile_plan(cfg.ny, cfg.nx, ctas,
                                     mask.element_size())
                lib, fn = _lib("cg_jacobi", dtype, _JACOBI_ARGS)
        n_part = 2 * _NDOT * ctas
        shape_args = (cfg.ny, cfg.nx, maxiter, int(lam == 0.0))
        scalars = (1.0 / cfg.dx, 1.0 / cfg.dy, lam, tol_eff * tol_eff,
                   float(torch.finfo(dtype).tiny))
        # the Jacobi kernel's banks p0 p1 r0 r1 w0 w1 s0 s1, each on 16
        # bytes and padded
        stride = -(-(mask.numel() + 16) // 64) * 64

    def solve(b, x0=None, stamps=None, count=True) -> CGResult:
        global LAUNCHES
        if on_cpu:
            if b.device.type != "cpu":
                raise ValueError("fused CG: b is not on the grid's device")
            return cg_solve_plain(b, grid, cfg, x0=x0, lam=lam, tol=tol,
                                  maxiter=maxiter, precond=precond,
                                  hierarchy=(levels, gamma) if use_mg
                                  else None)
        from beom_tpu_torch.stencils import build

        x0 = torch.zeros_like(b) if x0 is None else x0
        for a in (b, x0):
            if a.device != mask.device or a.dtype != dtype \
                    or not a.is_contiguous() or a.shape != mask.shape:
                raise ValueError(
                    "fused CG: b and x0 must be contiguous "
                    f"{dtype} tensors of {tuple(mask.shape)} on "
                    f"{mask.device}")
        dev = b.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            stamp_ptr = None if stamps is None else stamps.arm(dev)
            x = padded(b.shape, b)
            iters = torch.empty(1, dtype=torch.int32, device=dev)
            # apart from the work vectors: the result keeps resnorm
            partials = torch.empty(n_part + 1, dtype=dtype, device=dev)
            resnorm = partials[-1:]
            ptrs = [a.data_ptr() for a in [b, x0] + statics + [x]]
            if use_mg:
                work = torch.empty(4 * b.numel(), dtype=dtype, device=dev)
                # r, u (the cycle's output XC), w, p, s
                work_ptrs = [work.data_ptr(), tables.field(0, XC).data_ptr()
                             ] + [work[k * b.numel():].data_ptr()
                                  for k in (1, 2, 3)]
                code = fn(*ptrs, *work_ptrs, partials.data_ptr(), n_part,
                          iters.data_ptr(), resnorm.data_ptr(), *shape_args,
                          *scalars, *tables.args(),
                          tables.field(0, BC).data_ptr(), stamp_ptr, stream)
            else:
                work = torch.empty(8 * stride, dtype=dtype, device=dev)
                code = fn(*ptrs, *[work[k * stride:].data_ptr()
                                   for k in range(8)],
                          partials.data_ptr(), iters.data_ptr(),
                          resnorm.data_ptr(), *shape_args, nty, ntx, ctas,
                          *scalars, stamp_ptr, stream)
            build.check(lib, code, "fused CG kernel launch")
            LAUNCHES += 1
            if stamps is not None:
                stamps.fill()
        # count=False: iters None, and no wait for the card
        return CGResult(x=x, iters=int(iters.item()) if count else None,
                        resnorm=resnorm[0])

    solve.steps = steps
    return solve
