"""Blocked red-black SOR (K4a), the single-pass operator (K4b), and their
plain PyTorch versions.

The CUDA kernels of `csrc/rb_sweep.cu` replace the TPU kernels of
beom_tpu/stencils/redblack_pallas.py:
  * K4a, one kernel in three modes (the reference's _rb_kernel, built by
    make_level_sweep, and the residual test of make_pallas_rb_solve's
    loop).  `rb_sweep`: k red-black sweeps in one pass over device memory,
    with residual=True also r = b - A x of the result in
    multigrid.operator's order (the multigrid pre-smoother).  `solve_pass`:
    the blocked solve's pass, k sweeps and then r = (b - A x) mask in
    laplacian_H's order and sum r^2 on the device, behind the solve's test;
    `rb_pass` is the same pass without the test.  Every launch is exactly k
    strict red-black sweeps at any size (the kernel streams rows through a
    pipeline of half-sweeps, each computed from the x of the one before);
    the residual is exact.  The plain versions are k sweeps of
    solvers/elliptic.rb_sweeps, then b - multigrid.operator(x) or
    (b - laplacian_H(x)) mask and torch.sum;
  * K4b, `apply_op` (make_apply_kernel): A x or b - A x in one pass; the
    plain version is multigrid.operator.

`make_fused_rb_solve` (the reference's make_pallas_rb_solve) runs passes
of k sweeps while |b - A x|^2 > tol^2 |b|^2, at most `max_passes`: one
residual pass tests the initial x, then each pass sweeps and tests its
own result on the device.  A pass launched after the test has stopped the
solve copies x and counts nothing, so the host reads the test once per
batch of passes (`READ_EVERY`; the first batch is the last solve's pass
count), and the x returned is the plain loop's (`rb_solve_plain`).

On CPU tensors each kernel takes its plain version; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid
from beom_tpu_torch.solvers import elliptic
from beom_tpu_torch.solvers.multigrid import operator

# kernel launches made by K4a (every mode) and apply_op (K4b); passes of
# the blocked solves that did work, passes launched after the test had
# stopped a solve, solves run (one residual launch each) and host reads of
# their test; a run reads them to show that its main path went through the
# kernels, one K4a launch per pass
LAUNCHES = 0
APPLY_LAUNCHES = 0
PASSES = 0
IDLE = 0
SOLVES = 0
READS = 0
# passes launched between two host reads of a solve's test after its first
# batch
READ_EVERY = 8

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_MODES = {"sweep": 0, "mg_residual": 1, "solve": 2}


def operator_plain(x, Hu, Hv, mask, dx: float, dy: float, lam=0.0):
    """A x, masked, in multigrid.operator's op order."""
    return operator(x, Hu, ops.sxm(Hu), Hv, ops.sym(Hv), mask,
                    1.0 / dx ** 2, 1.0 / dy ** 2, lam)


def rb_sweep_plain(x, b, Hu, Hv, mask, dx: float, dy: float, *,
                   lam=0.0, k: int = 1, omega: float = 1.0,
                   reverse: bool = False, residual: bool = False):
    """k red-black sweeps, and with `residual` (x, (b - A x) mask): the
    plain PyTorch version of the kernel."""
    x = elliptic.rb_sweeps(x, b, Hu, Hv, mask, dx, dy, lam=lam,
                           omega=omega, sweeps=k, reverse=reverse)
    if not residual:
        return x
    return x, (b - operator_plain(x, Hu, Hv, mask, dx, dy, lam)) * mask


def rb_pass_plain(x, b, Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
                  k: int = 8, omega: float = 1.0):
    """The blocked solve's pass: k red-black sweeps (none for k = 0), then
    r = (b - A x) mask in laplacian_H's order; returns (x, r, sum r^2)."""
    if k > 0:
        x = elliptic.rb_sweeps(x, b, Hu, Hv, mask, dx, dy, lam=lam,
                               omega=omega, sweeps=k)
    r = (b - elliptic.laplacian(x, Hu, Hv, mask, dx, dy, lam=lam)) * mask
    return x, r, torch.sum(r * r)


def apply_op_plain(x, b, Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
                   mode: str = "residual"):
    """A x (mode 'matvec') or (b - A x) mask (mode 'residual')."""
    ax = operator_plain(x, Hu, Hv, mask, dx, dy, lam)
    return ax if mode == "matvec" else (b - ax) * mask


def _entry(kind: str, dtype):
    from beom_tpu_torch.stencils import build

    lib = build.load("rb_sweep")
    fn = getattr(lib, f"beom_{kind}_{_DTYPES[dtype]}")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = {
        "rb_pass": [P] * 8 + [I] + [P] * 3 + [I] * 8 + [D] * 5 + [I]
        + [D] * 2 + [P],
        "rb_plan": [I] * 4 + [P],
        "apply_op": [P] * 6 + [I] * 3 + [D] * 3 + [P]}[kind]
    fn.restype = I
    return lib, fn


def plan(ny: int, nx: int, k: int, mode: str, dtype, device=None) -> dict:
    """K4a's launch plan on the card: strip t, chunk ch, halo w, loaded
    width wd, static ring rows, grid (gx, gy), shared bytes and threads
    per CTA."""
    from beom_tpu_torch.stencils import build

    with torch.cuda.device(device):
        lib, fn = _entry("rb_plan", dtype)
        out = (ctypes.c_int * 9)()
        build.check(lib, fn(ny, nx, k, _MODES[mode], out), "rb_sweep plan")
    return dict(zip(("t", "ch", "w", "wd", "s_ring", "gx", "gy", "smem",
                     "threads"), out))


def _check_operands(what, x, tensors):
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"{what} runs on cuda or cpu, not {x.device.type}")
    ny, nx = tensors[-1].shape
    for a in tensors:
        if a.device != x.device or a.dtype != x.dtype \
                or not a.is_contiguous() or a.shape != (ny, nx):
            raise ValueError(
                f"{what}: every operand must be a contiguous "
                f"{x.dtype} tensor of ({ny}, {nx}) on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {x.dtype}")
    return ny, nx


class SolveState:
    """The device state of a blocked solve: two slots of (sum r^2, whether
    the next pass runs, passes that did work), read from one and written to
    the other by the parity of the pass; the per-CTA partial sums and the
    ticket of the CTAs done with a pass."""

    def __init__(self, like, k: int):
        """The state of a solve of passes of k sweeps on tensors like
        `like` (on the card: one partial per CTA of the widest launch)."""
        n_blocks = 1 if like.device.type == "cpu" else _solve_blocks(like, k)
        self.state = torch.zeros(8, dtype=torch.float64, device=like.device)
        self.part = torch.zeros(n_blocks, dtype=torch.float64,
                                device=like.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=like.device)

    def read(self, slot: int):
        """(whether the next pass runs, passes that did work, sum r^2) of
        a slot: one host read."""
        v = self.state.tolist()
        return v[2 + slot] != 0.0, int(v[4 + slot]), v[slot]


def _launch(x, b, Hu, Hv, mask, dx, dy, *, mode, lam, k, omega, reverse,
            out, r_out, st=None, thr=None, parity=0, first=False,
            max_passes=0):
    global LAUNCHES
    from beom_tpu_torch.stencils import build

    ny, nx = _check_operands("red-black pass", x, (x, b, Hu, Hv, mask))
    if st is not None and (thr.dtype != x.dtype or thr.device != x.device
                           or st.state.device != x.device):
        raise ValueError("red-black pass: the solve's state and threshold "
                         f"must lie on {x.device}, the threshold {x.dtype}")
    with torch.cuda.device(x.device):
        lib, fn = _entry("rb_pass", x.dtype)
        ptr = [a.data_ptr() if a is not None else None
               for a in (out, r_out)]
        solve = st is not None
        code = fn(x.data_ptr(), b.data_ptr(), Hu.data_ptr(), Hv.data_ptr(),
                  mask.data_ptr(), *ptr,
                  st.part.data_ptr() if solve else None,
                  st.part.numel() if solve else 0,
                  st.state.data_ptr() if solve else None,
                  st.ticket.data_ptr() if solve else None,
                  thr.data_ptr() if solve else None, ny, nx, k,
                  _MODES[mode], int(reverse), parity, int(first), max_passes,
                  1.0 / dx ** 2, 1.0 / dy ** 2, 1.0 / dx, 1.0 / dy, lam,
                  int(lam != 0.0), omega, 1.0 - omega,
                  torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, code, "rb_sweep kernel launch")
        LAUNCHES += 1


def rb_sweep(x, b, Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
             k: int = 1, omega: float = 1.0, reverse: bool = False,
             residual: bool = False):
    """k red-black SOR sweeps of A x = b from x (black-red colour order
    when `reverse`) in one launch; returns the new x, or with `residual`
    (x, (b - A x) mask)."""
    if x.device.type == "cpu":
        return rb_sweep_plain(x, b, Hu, Hv, mask, dx, dy, lam=lam, k=k,
                              omega=omega, reverse=reverse,
                              residual=residual)
    out = torch.empty_like(x)
    r = torch.empty_like(x) if residual else None
    _launch(x, b, Hu, Hv, mask, dx, dy,
            mode="mg_residual" if residual else "sweep", lam=lam, k=k,
            omega=omega, reverse=reverse, out=out, r_out=r)
    return (out, r) if residual else out


def _solve_blocks(x, k: int) -> int:
    """CTAs of the solve mode's launches at k and k = 0 (the first test)."""
    plans = [plan(*x.shape, kk, "solve", x.dtype, x.device)
             for kk in (0, k)]
    return max(p["gx"] * p["gy"] for p in plans)


def rb_pass(x, b, Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
            k: int = 8, omega: float = 1.0):
    """One pass of the blocked solve's kernel, without its test: k sweeps,
    then (x, r, s) with r = (b - A x) mask in laplacian_H's order and s
    the device's sum of r^2 (in float64 on the card)."""
    if x.device.type == "cpu":
        return rb_pass_plain(x, b, Hu, Hv, mask, dx, dy, lam=lam, k=k,
                             omega=omega)
    st = SolveState(x, k)
    out = torch.empty_like(x) if k > 0 else None
    r = torch.empty_like(x)
    thr = torch.zeros((), dtype=x.dtype, device=x.device)
    _launch(x, b, Hu, Hv, mask, dx, dy, mode="solve", lam=lam, k=k,
            omega=omega, reverse=False, out=out, r_out=r, st=st, thr=thr,
            first=True, max_passes=1)
    return (x if out is None else out), r, st.state[1]


def solve_pass_plain(x, b, Hu, Hv, mask, dx: float, dy: float, st, thr, *,
                     lam=0.0, k: int = 8, omega: float = 1.0,
                     parity: int = 0, first: bool = False,
                     max_passes: int = 1):
    """The plain version of `solve_pass`, on the state's tensor."""
    s = st.state
    pi, po = parity, 1 - parity
    if not first and s[2 + pi] == 0.0:
        s[po::2][:3] = s[pi::2][:3].clone()
        return x
    x, _, rr = rb_pass_plain(x, b, Hu, Hv, mask, dx, dy, lam=lam, k=k,
                             omega=omega)
    n = (0.0 if first else float(s[4 + pi])) + (1.0 if k > 0 else 0.0)
    s[po] = float(rr)
    s[2 + po] = 1.0 if bool(rr > thr) and n < max_passes else 0.0
    s[4 + po] = n
    return x


def solve_pass(x, b, Hu, Hv, mask, dx: float, dy: float, st, thr, *,
               lam=0.0, k: int = 8, omega: float = 1.0, parity: int = 0,
               first: bool = False, max_passes: int = 1):
    """One pass of the blocked solve behind its test, on the solve's state
    `st` (a SolveState): unless `first`, it runs only if the state's slot
    `parity` says so, and otherwise returns x unchanged; it writes slot
    1 - parity.  k = 0 (with `first`) is the test of the initial x."""
    if x.device.type == "cpu":
        return solve_pass_plain(x, b, Hu, Hv, mask, dx, dy, st, thr,
                                lam=lam, k=k, omega=omega, parity=parity,
                                first=first, max_passes=max_passes)
    out = torch.empty_like(x) if k > 0 else None
    _launch(x, b, Hu, Hv, mask, dx, dy, mode="solve", lam=lam, k=k,
            omega=omega, reverse=False, out=out, r_out=None, st=st, thr=thr,
            parity=parity, first=first, max_passes=max_passes)
    return x if out is None else out


def apply_op(x, b, Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
             mode: str = "residual"):
    """A x (mode 'matvec'; b is not read) or (b - A x) mask (mode
    'residual') in one launch."""
    global APPLY_LAUNCHES
    if mode not in ("residual", "matvec"):
        raise ValueError(f"unknown mode {mode!r}")
    if x.device.type == "cpu":
        return apply_op_plain(x, b, Hu, Hv, mask, dx, dy, lam=lam, mode=mode)
    from beom_tpu_torch.stencils import build

    matvec = mode == "matvec"
    ops_in = (x, Hu, Hv, mask) if matvec else (x, b, Hu, Hv, mask)
    ny, nx = _check_operands("operator pass", x, ops_in)
    with torch.cuda.device(x.device):
        lib, fn = _entry("apply_op", x.dtype)
        out = torch.empty_like(x)
        code = fn(x.data_ptr(), None if matvec else b.data_ptr(),
                  Hu.data_ptr(), Hv.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), ny, nx, int(matvec), 1.0 / dx ** 2,
                  1.0 / dy ** 2, lam,
                  torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, code, "apply_op kernel launch")
        APPLY_LAUNCHES += 1
    return out


def make_level_sweep(Hu, Hv, mask, dx: float, dy: float, *,
                     lam=0.0, k: int = 1, omega: float = 1.0,
                     reverse: bool = False, residual: bool = False):
    """sweep(x, b) -> x (or (x, r) with `residual`): k red-black sweeps in
    one pass on a periodic (ny, nx) level given by its face depths and
    mask."""
    def sweep(x, b):
        return rb_sweep(x, b, Hu, Hv, mask, dx, dy, lam=lam, k=k,
                        omega=omega, reverse=reverse, residual=residual)

    return sweep


def make_apply_kernel(Hu, Hv, mask, dx: float, dy: float, *, lam=0.0,
                      mode: str = "residual"):
    """The operator pass on one level: apply(x, b) -> (b - A x) mask for
    mode 'residual', apply(x) -> A x for mode 'matvec'."""
    if mode == "matvec":
        def apply(x):
            return apply_op(x, None, Hu, Hv, mask, dx, dy, lam=lam,
                            mode=mode)
    else:
        def apply(x, b):
            return apply_op(x, b, Hu, Hv, mask, dx, dy, lam=lam, mode=mode)
    return apply


def _solve_setup(grid: Grid, cfg: Config, tol: Optional[float]):
    """(tol clamped to 30 eps of cfg.dtype, Hu, Hv) of a blocked solve."""
    tol = cfg.solver_tol if tol is None else tol
    tol = max(tol, 30.0 * float(torch.finfo(cfg.tdtype).eps))
    Hu, Hv = elliptic.face_depths(grid)
    return tol, Hu.contiguous(), Hv.contiguous()


def _threshold(b, tol: float):
    return (tol * tol) * torch.clamp_min(torch.sum(b * b),
                                         torch.finfo(b.dtype).tiny)


def make_fused_rb_solve(grid: Grid, cfg: Config, lam=0.0, k: int = 8,
                        tol: Optional[float] = None, max_passes: int = 200):
    """solve(b, x0=None) -> x: passes of k sweeps while
    |b - A x|^2 > tol^2 |b|^2 (tol clamped to 30 eps of cfg.dtype), at most
    max_passes, each testing its own result on the device; the host reads
    the test once per batch of passes."""
    tol, Hu, Hv = _solve_setup(grid, cfg, tol)
    mask = grid.mask
    args = (Hu, Hv, mask, cfg.dx, cfg.dy)
    kw = dict(lam=lam, omega=cfg.sor_omega, max_passes=max_passes)
    held = {}       # the state, and the last solve's pass count

    def solve(b, x0=None):
        global PASSES, IDLE, SOLVES, READS
        b = b * mask
        x = torch.zeros_like(b) if x0 is None else x0 * mask
        thr = _threshold(b, tol)
        if "st" not in held:
            held["st"] = SolveState(b, k)
        st = held["st"]
        x = solve_pass(x, b, *args, st, thr, k=0, parity=0, first=True,
                       **kw)
        SOLVES += 1
        parity, launched, done = 1, 0, 0
        batch = held.get("passes", READ_EVERY)
        while launched < max_passes:
            for _ in range(min(batch, max_passes - launched)):
                x = solve_pass(x, b, *args, st, thr, k=k, parity=parity,
                               **kw)
                parity ^= 1
                launched += 1
            go, done, _ = st.read(parity)     # host read
            READS += 1
            if not go:
                break
            batch = READ_EVERY
        PASSES += done
        IDLE += launched - done
        held["passes"] = max(done, 1)
        return x

    return solve


def rb_solve_plain(b, grid: Grid, cfg: Config, lam=0.0, x0=None, k: int = 8,
                   tol: Optional[float] = None, max_passes: int = 200):
    """The plain version of the blocked solve, the reference's loop with
    one host read per pass: test |b - A x|^2 > tol^2 |b|^2, then k plain
    sweeps, at most max_passes times.  Returns (x, passes)."""
    tol, Hu, Hv = _solve_setup(grid, cfg, tol)
    mask = grid.mask
    b = b * mask
    x = torch.zeros_like(b) if x0 is None else x0 * mask
    thr = _threshold(b, tol)
    passes = 0
    for _ in range(max_passes):
        r = (b - elliptic.laplacian_H(x, Hu, Hv, grid, cfg, lam=lam)) * mask
        if not bool(torch.sum(r * r) > thr):      # host read
            break
        x = rb_sweep_plain(x, b, Hu, Hv, mask, cfg.dx, cfg.dy, lam=lam, k=k,
                           omega=cfg.sor_omega)
        passes += 1
    return x, passes


def solve_fused(b, grid: Grid, cfg: Config, lam=0.0, x0=None, k: int = 8,
                tol: Optional[float] = None, max_passes: int = 200):
    """One-shot convenience wrapper over make_fused_rb_solve."""
    return make_fused_rb_solve(grid, cfg, lam=lam, k=k, tol=tol,
                               max_passes=max_passes)(b, x0=x0)
