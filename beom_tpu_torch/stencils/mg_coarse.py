"""The coarse multigrid stack in one launch (K5), the flattened cycle it
shares with the multigrid half of K6, and its plain PyTorch version.

The CUDA kernel `csrc/mg_coarse.cu` replaces the TPU kernel
beom_tpu/stencils/mg_pallas.py::_coarse_kernel (make_coarse_stack_call):
the whole recursive gamma-cycle of solvers/multigrid.py::_vcycle on a
tail of the level hierarchy, from x = 0, in one launch.  The host
flattens the cycle once into a list of steps (`cycle_steps`), each one
pass over one level; `CycleTables` holds the levels' fields, their work
fields and the steps on the card; the kernel walks the list with a grid
sync between steps (csrc/mg_cycle.cuh), except among levels of at most
`solo_points` points, which one CTA runs with block barriers.

`make_coarse_stack_call(levels, lam, ...)` returns call(b) -> x.  On CPU
tensors it runs the plain version, the eager _vcycle on the same levels
and gamma; on CUDA tensors it launches the kernel or raises.  Without the
de-mean the kernel mirrors the eager cycle op for op; the de-mean's sums
run in another order than torch.sum's.
"""

from __future__ import annotations

import ctypes

import torch

from beom_tpu_torch.solvers import multigrid as mg

# kernel launches made by the coarse-stack calls; a run reads it to show
# that its main path went through the kernel
LAUNCHES = 0

# levels of at most this many points run on one CTA (csrc/mg_cycle.cuh).
# A solo step reads its level from L2 with 256 threads, so it pays only
# where a level has about one point per thread: on the H100 at 2048^2 f32
# a K6-mg iteration took 6.92 ms with 16^2, 7.57 with 32^2, 10.92 with
# 64^2 and 8.21 ms with no solo level (PERF.md)
SOLO_POINTS = 16 * 16

# step ops and a level's work fields, as csrc/mg_cycle.cuh numbers them
OP_ZERO, OP_SWEEP, OP_RESID, OP_RESTRICT, OP_DEMEAN, OP_ADD, OP_PROLONG = \
    range(7)
BC, XC, RC, X, R = range(6, 11)
RED, BLACK, FROM_ZERO = 0, 1, 2
NDOT = 6            # partial sums per CTA (csrc/mg_cycle.cuh NDOT)

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def cycle_steps(levels, lam, nu: int, nu_coarse: int, gamma, demean: bool,
                solo_points: int = SOLO_POINTS):
    """The passes of _vcycle(levels, 0, b, lam, nu, nu_coarse, demean,
    gamma) without smoothers, coarse delegation or K-cycle, as a list of
    (op, level, a, b, c, solo).  Level 0 reads its right-hand side from
    its BC field and leaves x in its XC field."""
    last = len(levels) - 1
    solo = [int(lv.mask.numel() <= solo_points) for lv in levels]
    dm = lam == 0.0 and demean
    steps = []

    def add(op, lev, a=0, b=0, c=0):
        steps.append((op, lev, a, b, c, solo[lev]))

    def sweeps(lev, x, b, colours, n, zero):
        for _ in range(n):
            for colour in colours:
                add(OP_SWEEP, lev, x, b, colour | (FROM_ZERO if zero else 0))
                zero = False
        return zero

    def visit(k, b, x):
        if k == last:
            nf = nu_coarse // 2
            zero = sweeps(k, x, b, (RED, BLACK), nf, True)
            if sweeps(k, x, b, (BLACK, RED), nu_coarse - nf, zero):
                add(OP_ZERO, k, x)
            return
        if sweeps(k, x, b, (RED, BLACK), nu, True):
            add(OP_ZERO, k, x)
        add(OP_RESID, k, x, b, R)
        add(OP_RESTRICT, k, R, BC)
        if dm:
            add(OP_DEMEAN, k + 1, BC)
        visit(k + 1, BC, XC)
        for _ in range(mg._gamma_at(gamma, k) - 1):
            add(OP_RESID, k + 1, XC, BC, RC)
            visit(k + 1, RC, X)
            add(OP_ADD, k + 1, XC, X)
        if dm:
            add(OP_DEMEAN, k + 1, XC)
        add(OP_PROLONG, k, x, XC)
        sweeps(k, x, b, (BLACK, RED), nu, False)

    visit(0, BC, XC)
    return steps


def grid_syncs(steps) -> int:
    """Grid syncs one walk of `steps` costs: one after every step but a
    solo one followed by a solo one, and one inside every de-mean that
    is not solo."""
    n = 0
    for i, st in enumerate(steps):
        solo_next = i + 1 < len(steps) and steps[i + 1][5]
        n += 0 if (st[5] and solo_next) else 1
        n += int(st[0] == OP_DEMEAN and not st[5])
    return n


class CycleTables:
    """A cycle's tables on the card: per level the pointers of Hu, Hv,
    Hu_w, Hv_s, mask, inv_diag and of five work fields (allocated here),
    (ny, nx), (rdx2, rdy2, nwet), and the steps."""

    def __init__(self, levels, steps):
        dev, dtype = levels[0].mask.device, levels[0].mask.dtype
        self.fields = []
        rows = []
        for lv in levels:
            f = [t.contiguous() for t in (lv.Hu, lv.Hv, lv.Hu_w, lv.Hv_s,
                                          lv.mask, lv.inv_diag)]
            f += [torch.zeros_like(lv.mask) for _ in range(5)]
            self.fields.append(f)
            rows.append([t.data_ptr() for t in f])
        self.ptrs = torch.tensor(rows, dtype=torch.int64, device=dev)
        self.dims = torch.tensor([list(lv.mask.shape) for lv in levels],
                                 dtype=torch.int32, device=dev)
        self.scal = torch.tensor([[lv.rdx2, lv.rdy2, float(lv.nwet)]
                                  for lv in levels], dtype=dtype, device=dev)
        self.steps = torch.tensor(steps, dtype=torch.int32, device=dev)
        self.nsteps = len(steps)

    def field(self, level: int, which: int):
        return self.fields[level][which]

    def args(self):
        """(ptrs, dims, scal, steps, nsteps) for a kernel launch."""
        return (self.ptrs.data_ptr(), self.dims.data_ptr(),
                self.scal.data_ptr(), self.steps.data_ptr(), self.nsteps)


def coarse_stack_plain(levels, b, lam, nu: int = 2, nu_coarse: int = 24,
                       gamma=2, demean: bool = True):
    """The plain version of the kernel: the eager cycle on `levels`."""
    return mg._vcycle(levels, 0, b, lam, nu, nu_coarse, demean=demean,
                      gamma=gamma)


def _entry(dtype):
    from beom_tpu_torch.stencils import build

    lib = build.load("mg_coarse")
    name = f"beom_mg_coarse_{_DTYPES[dtype]}"
    fn = getattr(lib, name)
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = [P] * 4 + [I, D, P, I, P]
    fn.restype = I
    blocks = getattr(lib, name.replace("coarse", "coarse_blocks"))
    blocks.argtypes = [ctypes.POINTER(ctypes.c_int)]
    blocks.restype = I
    return lib, fn, blocks


def _grid_blocks(dtype) -> int:
    """The number of CTAs a launch of the kernel uses on this card."""
    from beom_tpu_torch.stencils import build

    lib, _, blocks = _entry(dtype)
    n = ctypes.c_int(0)
    build.check(lib, blocks(ctypes.byref(n)), "mg_coarse occupancy query")
    return n.value


def make_coarse_stack_call(levels, lam, nu: int = 2, nu_coarse: int = 24,
                           gamma=2, demean: bool = True,
                           solo_points: int = SOLO_POINTS):
    """call(b) -> x: one recursive gamma-cycle on `levels` (a tail of a
    multigrid.build_levels hierarchy) from x0 = 0, in one launch on CUDA
    tensors.  call.steps is the flattened cycle."""
    mask = levels[0].mask
    steps = cycle_steps(levels, lam, nu, nu_coarse, gamma, demean,
                        solo_points)
    tables = None
    if mask.device.type == "cuda":
        if mask.dtype not in _DTYPES:
            raise ValueError(f"coarse stack: dtype {mask.dtype}")
        with torch.cuda.device(mask.device):
            tables = CycleTables(levels, steps)
            partials = torch.empty(2 * NDOT * _grid_blocks(mask.dtype),
                                   dtype=mask.dtype, device=mask.device)

    def call(b):
        global LAUNCHES
        if b.device.type == "cpu":
            return coarse_stack_plain(levels, b, lam, nu, nu_coarse, gamma,
                                      demean)
        if b.device.type != "cuda" or tables is None:
            raise NotImplementedError(
                f"the coarse stack runs on cuda or cpu, not {b.device} with "
                f"levels on {mask.device}")
        if b.device != mask.device or b.dtype != mask.dtype \
                or b.shape != mask.shape:
            raise ValueError("coarse stack: b must be a "
                             f"{mask.dtype} tensor of {tuple(mask.shape)} "
                             f"on {mask.device}")
        from beom_tpu_torch.stencils import build

        with torch.cuda.device(b.device):
            lib, fn, _ = _entry(b.dtype)
            tables.field(0, BC).copy_(b)
            code = fn(*tables.args(), float(lam), partials.data_ptr(),
                      partials.numel(),
                      torch.cuda.current_stream(b.device).cuda_stream)
            build.check(lib, code, "mg_coarse kernel launch")
            LAUNCHES += 1
            return tables.field(0, XC).clone()

    call.steps = steps
    return call
