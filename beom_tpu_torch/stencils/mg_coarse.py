"""The coarse multigrid stack in one launch (K5), the flattened cycle it
shares with the multigrid half of K6, and its plain PyTorch version.

The CUDA kernel `csrc/mg_coarse.cu` replaces the TPU kernel
beom_tpu/stencils/mg_pallas.py::_coarse_kernel (make_coarse_stack_call):
the whole recursive gamma-cycle of solvers/multigrid.py::_vcycle on a
tail of the level hierarchy, from x = 0, in one launch.  The host
flattens the cycle once into a list of steps (`cycle_steps`); the kernel
walks the list with a grid sync between steps (csrc/mg_cycle.cuh), in two
tiers:

  * the levels above the shared-memory tier: each visit is two tiled
    passes, `OP_PRE` (the pre-smoothing, the residual and its restriction)
    and `OP_POST` (the prolongation with its correction and the
    post-smoothing), each over tiles with a halo in shared memory;
  * the tier: from level `tier` down, the levels whose fields fit one
    CTA's shared memory together (`tier_level`).  The coarse correction
    under one visit of the level above, recursion and gamma loop
    included, runs on one CTA out of shared memory between `OP_TIER_IN`
    (which loads the tier's statics and its right-hand side) and
    `OP_TIER_OUT` (which writes the correction back), with block barriers
    in place of grid syncs.

`CycleTables` holds the levels' fields, their work fields and the steps
on the card.

`make_coarse_stack_call(levels, lam, ...)` returns call(b) -> x.  On CPU
tensors it runs the plain version, the eager _vcycle on the same levels
and gamma; on CUDA tensors it launches the kernel or raises.  Without the
de-mean the kernel mirrors the eager cycle op for op; the de-mean's sums
run in another order than torch.sum's.
"""

from __future__ import annotations

import ctypes

import torch

from beom_tpu_torch.core import ops
from beom_tpu_torch.solvers import multigrid as mg

# kernel launches made by the coarse-stack calls; a run reads it to show
# that its main path went through the kernel
LAUNCHES = 0

# step ops and a level's fields, as csrc/mg_cycle.cuh numbers them
(OP_ZERO, OP_SWEEP, OP_RESID, OP_RESTRICT, OP_DEMEAN, OP_ADD, OP_PROLONG,
 OP_PRE, OP_POST, OP_TIER_IN, OP_TIER_OUT, OP_SWEEPS) = range(12)
BC, XC, RC, X, R = range(4, 9)
PLANES = 9          # Hu, Hv, mask, inv_diag and the five work fields
RED, BLACK, FROM_ZERO = 0, 1, 2
NDOT = 6            # partial sums per CTA (csrc/mg_cycle.cuh NDOT)
THREADS = 512       # threads per CTA of the cycle kernels (CYCLE_THREADS)
LEVEL_TABLE = 16 * 128   # the kernels' level table in shared memory
# the opt-in shared memory of one H100 CTA: the plan shown to a caller on
# the CPU is the one the kernels would run there
H100_SMEM = 232448

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def tier_level(shapes, itemsize: int, smem: int) -> int:
    """The first level of the shared-memory tier: the largest level whose
    sub-hierarchy (its PLANES fields and every coarser level's) fits in
    `smem` bytes beside the block reduction's scratch and the level
    table; len(shapes) when not even the coarsest fits."""
    room = smem - NDOT * THREADS * itemsize - LEVEL_TABLE
    need, top = 0, len(shapes)
    for k in reversed(range(len(shapes))):
        ny, nx = shapes[k]
        need += PLANES * ny * nx * itemsize
        if need > room:
            break
        top = k
    return top


def tier_bytes(shapes, itemsize: int, tier: int) -> int:
    """Shared memory the tier's levels take."""
    return sum(PLANES * ny * nx * itemsize for ny, nx in shapes[tier:])


def cycle_steps(levels, lam, nu: int, nu_coarse: int, gamma, demean: bool,
                tier=None):
    """The passes of _vcycle(levels, 0, b, lam, nu, nu_coarse, demean,
    gamma) without smoothers, coarse delegation or K-cycle, as a list of
    (op, level, a, b, c, in_tier).  Level 0 reads its right-hand side
    from its BC field and leaves x in its XC field.  `tier`: the first
    level of the shared-memory tier (None: no tier).  Only len(levels)
    is read.

    A visit of a level above the tier is OP_PRE, which leaves the
    pre-smoothed x in R (c = 1: its right-hand side RC is first made from
    XC and BC, the gamma loop's residual), and OP_POST, which smooths
    (R + P correction) mask into x (c = 1: the correction is XC + X of the
    level below, the gamma loop's last add).  A tiled pass reads no field
    it writes, as its tiles overlap.  The coarse correction under a visit
    of the level above the tier is OP_TIER_IN, the tier's steps,
    OP_TIER_OUT.  In the tier, and on the coarsest level outside it, a
    visit is made of the plain half-sweeps (in the tier a run of them,
    colours alternating, is one OP_SWEEPS: c = first colour | FROM_ZERO |
    count << 2), residual, restriction and prolongation."""
    last = len(levels) - 1
    tier = len(levels) if tier is None else tier
    dm = lam == 0.0 and demean
    steps = []

    def add(op, lev, a=0, b=0, c=0):
        steps.append((op, lev, a, b, c, int(lev >= tier)))

    def sweeps(lev, x, b, colours, n, zero):
        if lev >= tier and n > 0:
            # in the tier one step: 2n half-sweeps from colours[0] on
            add(OP_SWEEPS, lev, x, b,
                colours[0] | (FROM_ZERO if zero else 0) | 2 * n << 2)
            return False
        for _ in range(n):
            for colour in colours:
                add(OP_SWEEP, lev, x, b, colour | (FROM_ZERO if zero else 0))
                zero = False
        return zero

    def correction(k, fuse_add):
        """Level k's coarse correction, into XC of level k + 1 from BC
        there; True when the gamma loop's last add is left to the
        caller's OP_POST."""
        if dm:
            add(OP_DEMEAN, k + 1, BC)
        visit(k + 1, BC, XC)
        g = mg._gamma_at(gamma, k)
        for i in range(g - 1):
            visit(k + 1, RC, X, resid_in=True)
            if fuse_add and not dm and i == g - 2:
                return True
            add(OP_ADD, k + 1, XC, X)
        if dm:
            add(OP_DEMEAN, k + 1, XC)
        return False

    def visit(k, b, x, resid_in=False):
        fused = k < min(tier, last)
        if resid_in and not fused:
            add(OP_RESID, k, XC, BC, RC)
        if k == last:
            nf = nu_coarse // 2
            zero = sweeps(k, x, b, (RED, BLACK), nf, True)
            if sweeps(k, x, b, (BLACK, RED), nu_coarse - nf, zero):
                add(OP_ZERO, k, x)
            return
        if fused:
            add(OP_PRE, k, R, b, int(resid_in))
        else:
            if sweeps(k, x, b, (RED, BLACK), nu, True):
                add(OP_ZERO, k, x)
            add(OP_RESID, k, x, b, R)
            add(OP_RESTRICT, k, R, BC)
        if k + 1 == tier:
            add(OP_TIER_IN, k + 1, BC)
            correction(k, False)
            add(OP_TIER_OUT, k + 1, XC)
            pending = False
        else:
            pending = correction(k, fused)
        if fused:
            add(OP_POST, k, x, b, int(pending))
        else:
            add(OP_PROLONG, k, x, XC)
            sweeps(k, x, b, (BLACK, RED), nu, False)

    if tier == 0:
        add(OP_TIER_IN, 0, BC)
    visit(0, BC, XC)
    if tier == 0:
        add(OP_TIER_OUT, 0, XC)
    return steps


def grid_syncs(steps) -> int:
    """Grid syncs one walk of `steps` costs: one after every step but a
    tier step followed by a tier step, and one inside every de-mean
    outside the tier."""
    n = 0
    for i, st in enumerate(steps):
        tier_next = i + 1 < len(steps) and steps[i + 1][5]
        n += 0 if (st[5] and tier_next) else 1
        n += int(st[0] == OP_DEMEAN and not st[5])
    return n


def pack(step) -> int:
    """A step as the kernels read it: one int."""
    op, lev, a, b, c, in_tier = step
    if not (0 <= c < 1024 and 0 <= lev < 16):
        raise ValueError(f"cycle step {step}: out of the packed range")
    return op | lev << 4 | a << 8 | b << 12 | c << 16 | in_tier << 26


def level_shapes(levels):
    return [tuple(lv.mask.shape) for lv in levels]


class CycleTables:
    """A cycle's tables on the card: per level the pointers of Hu, Hv,
    mask, inv_diag and of five work fields (allocated here), (ny, nx),
    (rdx2, rdy2, nwet), and the steps.  The kernels read the west and
    south face depths as the neighbours' Hu and Hv, so the levels' Hu_w
    and Hv_s must be those periodic shifts (multigrid.build_levels)."""

    def __init__(self, levels, steps, nu: int, tier: int):
        dev, dtype = levels[0].mask.device, levels[0].mask.dtype
        self.fields = []
        rows = []
        for lv in levels:
            if not (torch.equal(lv.Hu_w, ops.sxm(lv.Hu))
                    and torch.equal(lv.Hv_s, ops.sym(lv.Hv))):
                raise ValueError("cycle tables: Hu_w / Hv_s are not the "
                                 "periodic shifts of Hu / Hv")
            f = [t.contiguous() for t in (lv.Hu, lv.Hv, lv.mask,
                                          lv.inv_diag)]
            f += [torch.zeros_like(lv.mask) for _ in range(5)]
            self.fields.append(f)
            rows.append([t.data_ptr() for t in f])
        self.ptrs = torch.tensor(rows, dtype=torch.int64, device=dev)
        self.dims = torch.tensor(level_shapes(levels), dtype=torch.int32,
                                 device=dev)
        self.scal = torch.tensor([[lv.rdx2, lv.rdy2, float(lv.nwet)]
                                  for lv in levels], dtype=dtype, device=dev)
        self.steps = torch.tensor([pack(st) for st in steps],
                                  dtype=torch.int32, device=dev)
        self.nsteps, self.nlev, self.nu, self.tier = (len(steps), len(levels),
                                                      nu, tier)
        self.tier_bytes = tier_bytes(level_shapes(levels),
                                     levels[0].mask.element_size(), tier)

    def field(self, level: int, which: int):
        return self.fields[level][which]

    def args(self):
        """(ptrs, dims, scal, steps, nsteps, nlev, nu, tier, tier_bytes)
        for a kernel launch."""
        return (self.ptrs.data_ptr(), self.dims.data_ptr(),
                self.scal.data_ptr(), self.steps.data_ptr(), self.nsteps,
                self.nlev, self.nu, self.tier, self.tier_bytes)


def plan(levels, lam, nu: int, nu_coarse: int, gamma, demean: bool,
         smem: int, tier=None):
    """(tier, steps) of a cycle on `levels` for a card with `smem` bytes
    of shared memory per CTA: `tier` None takes the largest tier that
    fits; a tier that does not fit raises."""
    shapes = level_shapes(levels)
    top = tier_level(shapes, levels[0].mask.element_size(), smem)
    tier = top if tier is None else tier
    if not top <= tier <= len(levels):
        raise ValueError(f"cycle: a tier from level {tier} of "
                         f"{len(levels)} does not fit {smem} bytes of shared "
                         f"memory (from level {top} does)")
    return tier, cycle_steps(levels, lam, nu, nu_coarse, gamma, demean, tier)


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
    fn.argtypes = [P] * 4 + [I] * 5 + [D, P, I, P, P]
    fn.restype = I
    for query in ("blocks", "smem"):
        q = getattr(lib, name.replace("coarse", f"coarse_{query}"))
        q.argtypes = [ctypes.POINTER(ctypes.c_int)]
        q.restype = I
    return lib, fn


def _query(dtype, what: str) -> int:
    """The CTAs a launch of the kernel uses on this card ('blocks'), or
    the shared memory each has ('smem')."""
    from beom_tpu_torch.stencils import build

    lib, _ = _entry(dtype)
    n = ctypes.c_int(0)
    q = getattr(lib, f"beom_mg_coarse_{what}_{_DTYPES[dtype]}")
    build.check(lib, q(ctypes.byref(n)), f"mg_coarse {what} query")
    return n.value


def make_coarse_stack_call(levels, lam, nu: int = 2, nu_coarse: int = 24,
                           gamma=2, demean: bool = True, tier=None):
    """call(b) -> x: one recursive gamma-cycle on `levels` (a tail of a
    multigrid.build_levels hierarchy) from x0 = 0, in one launch on CUDA
    tensors.  tier: the first level of the shared-memory tier (None: the
    largest that fits the card; len(levels): none).  call.steps is the
    flattened cycle, call.tier its tier (on the CPU the H100's)."""
    mask = levels[0].mask
    tables = None
    if mask.device.type == "cuda":
        if mask.dtype not in _DTYPES:
            raise ValueError(f"coarse stack: dtype {mask.dtype}")
        with torch.cuda.device(mask.device):
            tier, steps = plan(levels, lam, nu, nu_coarse, gamma, demean,
                               _query(mask.dtype, "smem"), tier)
            tables = CycleTables(levels, steps, nu, tier)
            partials = torch.empty(2 * NDOT * _query(mask.dtype, "blocks"),
                                   dtype=mask.dtype, device=mask.device)
    else:
        tier, steps = plan(levels, lam, nu, nu_coarse, gamma, demean,
                           H100_SMEM, tier)

    def call(b, stamps=None):
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
            lib, fn = _entry(b.dtype)
            tables.field(0, BC).copy_(b)
            code = fn(*tables.args(), float(lam), partials.data_ptr(),
                      partials.numel(),
                      None if stamps is None else stamps.arm(b.device),
                      torch.cuda.current_stream(b.device).cuda_stream)
            build.check(lib, code, "mg_coarse kernel launch")
            LAUNCHES += 1
            if stamps is not None:
                stamps.fill()
            return tables.field(0, XC).clone()

    call.steps, call.tier = steps, tier
    return call
