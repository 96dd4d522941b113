"""The multigrid kernels' plain PyTorch versions (what their wrappers run
on CPU tensors) against beom_tpu at f64: K4a's residual mode against the
exact half-sweeps and operator, K4b against make_apply_kernel, K5 against
make_coarse_stack_call and K6-mg against make_vmem_cg_solve(precond='mg'),
the Pallas kernels in interpret mode as tests/unit/ runs them.  And the
flattened cycle the CUDA kernels walk (stencils/mg_coarse.cycle_steps),
executed here step by step with the eager operations, against the eager
cycle, bit for bit.  The CUDA kernels themselves are held against the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.solvers import multigrid as jmg
from beom_tpu.stencils.cg_vmem import make_vmem_cg_solve
from beom_tpu.stencils.mg_pallas import make_coarse_stack_call as j_coarse
from beom_tpu.stencils.redblack_pallas import make_apply_kernel as j_apply

from beom_tpu_torch.solvers import elliptic as el
from beom_tpu_torch.solvers import multigrid as mg
from beom_tpu_torch.stencils import cg_fused, mg_coarse, redblack
from beom_tpu_torch.stencils.mg_coarse import (
    BC, OP_ADD, OP_DEMEAN, OP_POST, OP_PRE, OP_PROLONG, OP_RESID,
    OP_RESTRICT, OP_SWEEP, OP_SWEEPS, OP_TIER_IN, OP_TIER_OUT, OP_ZERO, R,
    RC, X, XC)

from tests.torch_parity import assert_close, to_port


def _problem(nx, ny, seed=4):
    jcase = jax_make_case("rigid_lid", nx=nx, ny=ny, dtype="float64")
    cfg, grid, _, _ = to_port(*jcase)
    m = np.asarray(jcase[1].mask)
    rng = np.random.default_rng(seed)
    b = (rng.standard_normal(m.shape)
         + np.sin(np.linspace(0, 4 * np.pi, m.shape[0]))[:, None]) * m
    return jcase[0], jcase[1], cfg, grid, b


@pytest.fixture(scope="module")
def sq():
    return _problem(64, 64)


@pytest.fixture(scope="module")
def ragged():
    return _problem(200, 136)


def _lam(cfg, kind):
    return 0.0 if kind == "neumann" else 1.0 / (cfg.g * cfg.dt ** 2)


@pytest.mark.parametrize("mode", ["residual", "matvec"])
@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_apply_plain_matches_pallas(sq, mode, kind):
    """K4b's plain version against make_apply_kernel in interpret mode:
    the same operator in the same order, within 1e-13 x scale (XLA
    compiles the interpreted kernel body and may contract its multiply-
    adds; the eager operations, tested bit for bit in
    test_torch_multigrid.py, do not)."""
    jcfg, jgrid, cfg, grid, b = sq
    lam = _lam(cfg, kind)
    jl, tl = jmg.build_levels(jgrid, jcfg, lam)[0], \
        mg.build_levels(grid, cfg, lam)[0]
    rng = np.random.default_rng(2)
    x = rng.standard_normal(b.shape) * np.asarray(jgrid.mask)
    ref_fn = j_apply(jl.Hu, jl.Hv, jl.mask, jcfg.dx, jcfg.dy, lam=lam,
                     mode=mode, interpret=True)
    fn = redblack.make_apply_kernel(tl.Hu, tl.Hv, tl.mask, cfg.dx, cfg.dy,
                                    lam=lam, mode=mode)
    before = redblack.APPLY_LAUNCHES
    if mode == "matvec":
        ref, out = ref_fn(jnp.asarray(x)), fn(torch.tensor(x))
    else:
        ref = ref_fn(jnp.asarray(x), jnp.asarray(b))
        out = fn(torch.tensor(x), torch.tensor(b))
    assert redblack.APPLY_LAUNCHES == before       # CPU: plain version
    assert_close(out, ref, 1e-13, mode)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_sweep_residual_plain_matches_exact_cycle_ops(sq, kind, reverse):
    """K4a with residual=True, plain version, on levels 0 and 1: x equals
    nu = 2 sweeps of beom_tpu's _halfsweep and r its _apply_A residual,
    bit for bit.  The reference's Pallas kernel lags at its band seams
    by design, so the exact operations are the reference here."""
    jcfg, jgrid, cfg, grid, b = sq
    lam = _lam(cfg, kind)
    jls, tls = jmg.build_levels(jgrid, jcfg, lam), \
        mg.build_levels(grid, cfg, lam)
    rng = np.random.default_rng(5)
    for jl, tl in zip(jls[:2], tls[:2]):
        shape = tuple(tl.mask.shape)
        x0 = rng.standard_normal(shape) * tl.mask.numpy()
        rhs = rng.standard_normal(shape) * tl.mask.numpy()
        xj = jnp.asarray(x0)
        colours = (jl.black, jl.red) if reverse else (jl.red, jl.black)
        for _ in range(2):
            for c in colours:
                xj = jmg._halfsweep(jl, xj, jnp.asarray(rhs), c)
        rj = (jnp.asarray(rhs) - jmg._apply_A(jl, xj, lam)) * jl.mask
        sweep = redblack.make_level_sweep(tl.Hu, tl.Hv, tl.mask, tl.dx,
                                          tl.dy, lam=lam, k=2, omega=1.0,
                                          reverse=reverse, residual=True)
        x, r = sweep(torch.tensor(x0), torch.tensor(rhs))
        np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(r.numpy(), np.asarray(rj))


def _interpret(levels, steps, b, lam, nu=2):
    """Execute a flattened cycle with the eager operations, one step at a
    time, as the CUDA kernels do.  Work fields start as NaN, so a step
    that reads a field no step wrote shows in the result; the tier has
    fields of its own, made at OP_TIER_IN (its right-hand side copied in)
    and read back at OP_TIER_OUT."""
    def fresh(lvs):
        return [{w: torch.full_like(lv.mask, float("nan"))
                 for w in (BC, XC, RC, X, R)} for lv in lvs]

    def sweep(lv, x, rhs, colours):
        for _ in range(nu):
            for colour in colours:
                x = mg._halfsweep(lv, x, rhs, colour)
        return x

    work, tier = fresh(levels), None
    work[0][BC] = b
    for op, k, a, bb, c, in_tier in steps:
        if op == OP_TIER_IN:
            tier = [None] * k + fresh(levels[k:])
            tier[k][a] = work[k][a].clone()
        store = tier if in_tier else work
        lv, w = levels[k], store[k]
        if op == OP_TIER_IN:
            pass
        elif op == OP_TIER_OUT:
            work[k][a] = tier[k][a].clone()
            tier = None
        elif op == OP_ZERO:
            w[a] = torch.zeros_like(lv.mask)
        elif op == OP_SWEEP:
            x = torch.zeros_like(lv.mask) if c & 2 else w[a]
            w[a] = mg._halfsweep(lv, x, w[bb], lv.black if c & 1 else lv.red)
        elif op == OP_SWEEPS:
            for h in range(c >> 2):
                x = torch.zeros_like(lv.mask) if h == 0 and c & 2 else w[a]
                w[a] = mg._halfsweep(lv, x, w[bb],
                                     lv.black if (c ^ h) & 1 else lv.red)
        elif op == OP_RESID:
            w[c] = (w[bb] - mg._apply_A(lv, w[a], lam)) * lv.mask
        elif op == OP_RESTRICT:
            store[k + 1][bb] = mg._restrict2(w[a]) * levels[k + 1].mask
        elif op == OP_DEMEAN:
            w[a] = (w[a] - lv.mask * (torch.sum(w[a]) / lv.nwet)) * lv.mask
        elif op == OP_ADD:
            w[a] = w[a] + w[bb]
        elif op == OP_PROLONG:
            w[a] = (w[a] + mg._prolong2(store[k + 1][bb])) * lv.mask
        elif op == OP_PRE:
            if c:
                w[bb] = (w[BC] - mg._apply_A(lv, w[XC], lam)) * lv.mask
            x = sweep(lv, torch.zeros_like(lv.mask), w[bb],
                      (lv.red, lv.black))
            w[a] = x
            r = (w[bb] - mg._apply_A(lv, x, lam)) * lv.mask
            store[k + 1][BC] = mg._restrict2(r) * levels[k + 1].mask
        elif op == OP_POST:
            src = store[k + 1][XC]
            if c:
                src = src + store[k + 1][X]
            x = (w[R] + mg._prolong2(src)) * lv.mask
            w[a] = sweep(lv, x, w[bb], (lv.black, lv.red))
        else:
            raise AssertionError(f"unknown step op {op}")
    return work[0][XC]


@pytest.mark.parametrize("gamma,demean,nu_coarse", [
    (2, True, 24), ((2, 1), False, 24), (1, True, 3), ((2, 2, 1), True, 0)])
@pytest.mark.parametrize("which", ["sq", "ragged"])
def test_flattened_cycle_equals_eager(sq, ragged, which, gamma, demean,
                                      nu_coarse):
    """cycle_steps executed step by step equals _vcycle bit for bit (W, V,
    mixed schedules, de-mean on and off, an odd and a zero coarse sweep
    count, the ragged hierarchy down to its odd 25x17 level), with the
    tier the kernels take on an H100 at f64."""
    jcfg, jgrid, cfg, grid, b = sq if which == "sq" else ragged
    levels = mg.build_levels(grid, cfg, 0.0)
    tier = mg_coarse.tier_level(mg_coarse.level_shapes(levels), 8,
                                mg_coarse.H100_SMEM)
    assert 0 < tier < len(levels)
    steps = mg_coarse.cycle_steps(levels, 0.0, 2, nu_coarse, gamma, demean,
                                  tier)
    ref = mg._vcycle(levels, 0, torch.tensor(b), 0.0, 2, nu_coarse,
                     demean=demean, gamma=gamma)
    out = _interpret(levels, steps, torch.tensor(b), 0.0)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("nu", [2, 1, 0])
@pytest.mark.parametrize("gamma,demean", [
    (2, True), ((2, 1), False), (3, False), ((1, 2), True)])
@pytest.mark.parametrize("from_end", [0, 1, 2, "all"])
@pytest.mark.parametrize("which", ["sq", "ragged"])
def test_flattened_cycle_with_every_tier_equals_eager(
        sq, ragged, which, from_end, gamma, demean, nu):
    """The flattened cycle with the shared-memory tier over no level, the
    coarsest, ..., every level (the whole cycle one tier visit), with and
    without the fused passes' add and right-hand side, equals _vcycle bit
    for bit."""
    _, _, cfg, grid, b = sq if which == "sq" else ragged
    levels = mg.build_levels(grid, cfg, 0.0)
    tier = 0 if from_end == "all" else len(levels) - from_end
    steps = mg_coarse.cycle_steps(levels, 0.0, nu, 5, gamma, demean, tier)
    ops_seen = {st[0] for st in steps}
    assert (OP_TIER_IN in ops_seen) == (tier < len(levels))
    assert (OP_PRE in ops_seen) == (tier >= 1)
    ref = mg._vcycle(levels, 0, torch.tensor(b), 0.0, nu, 5, demean=demean,
                     gamma=gamma)
    out = _interpret(levels, steps, torch.tensor(b), 0.0, nu)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_grid_sync_count():
    """The sync count of a flattened cycle: tier-to-tier steps are free,
    every other step costs one, a de-mean outside the tier one more."""
    S, OP = 1, OP_SWEEP
    steps = [(OP, 0, 0, 0, 0, 0), (OP_DEMEAN, 0, 0, 0, 0, 0),
             (OP, 1, 0, 0, 0, S), (OP, 1, 0, 0, 0, S),
             (OP_DEMEAN, 1, 0, 0, 0, S), (OP, 0, 0, 0, 0, 0)]
    assert mg_coarse.grid_syncs(steps) == 1 + 2 + 0 + 0 + 1 + 1


# grid syncs per walk of the 2048^2 hierarchies' plans on an H100 (PERF.md
# section 6): the K6-mg cycle (fused gamma schedule, no de-mean) and K5 on
# the 512^2 tail (de-mean on), before this design 1139 and 335 at f32
@pytest.mark.parametrize("itemsize,tier,k6,k5", [
    (4, (64, 64), 78, 33), (8, (32, 32), 158, 73)])
def test_grid_syncs_of_the_2048_plans(itemsize, tier, k6, k5):
    shapes = [(2048 >> i,) * 2 for i in range(8)]
    gamma = (2, 2, 2, 2, 2, 1, 1)
    top = mg_coarse.tier_level(shapes, itemsize, mg_coarse.H100_SMEM)
    assert shapes[top] == tier
    assert (mg_coarse.tier_bytes(shapes, itemsize, top)
            + mg_coarse.LEVEL_TABLE
            + mg_coarse.NDOT * mg_coarse.THREADS * itemsize
            <= mg_coarse.H100_SMEM)
    steps = mg_coarse.cycle_steps(shapes, 0.0, 2, 24, gamma, False, top)
    assert mg_coarse.grid_syncs(steps) == k6
    tail = shapes[2:]
    steps = mg_coarse.cycle_steps(
        tail, 0.0, 2, 24, gamma[2:], True,
        mg_coarse.tier_level(tail, itemsize, mg_coarse.H100_SMEM))
    assert mg_coarse.grid_syncs(steps) == k5


@pytest.mark.parametrize("demean", [True, False])
@pytest.mark.parametrize("which", ["sq", "ragged"])
def test_coarse_stack_plain_matches_pallas(sq, ragged, which, demean):
    """K5's plain version against make_coarse_stack_call in interpret mode
    on the whole hierarchy (tests/unit/test_multigrid.py runs it so), with
    the fused gamma schedule: 1e-12 x scale (the reference's transfers are
    matmuls, its 1/dx^2 is rounded through dx)."""
    jcfg, jgrid, cfg, grid, b = sq if which == "sq" else ragged
    jl = jmg.build_levels(jgrid, jcfg, 0.0)
    tl = mg.build_levels(grid, cfg, 0.0)
    gamma = mg.fused_gamma_schedule(tl, 2)
    ref = j_coarse(jl, 0.0, gamma=gamma, demean=demean,
                   interpret=True)(jnp.asarray(b))
    before = mg_coarse.LAUNCHES
    call = mg_coarse.make_coarse_stack_call(tl, 0.0, gamma=gamma,
                                            demean=demean)
    out = call(torch.tensor(b))
    assert mg_coarse.LAUNCHES == before
    assert_close(out, ref, 1e-12, "coarse stack")


@pytest.mark.parametrize("kind", ["neumann", "helmholtz"])
def test_cg_mg_plain_matches_vmem_kernel(sq, kind):
    """K6 with the multigrid preconditioner, plain version, against
    make_vmem_cg_solve(precond='mg') in interpret mode, with
    tests/unit/test_cg_vmem.py's bounds: the iteration counts within 1,
    the true residual within 20 x tol |b|, x within 1e-6 x scale."""
    jcfg, jgrid, cfg, grid, b = sq
    lam = _lam(cfg, kind)
    ref = make_vmem_cg_solve(jgrid, jcfg, lam=lam, precond="mg",
                             interpret=True)(jnp.asarray(b))
    before = cg_fused.LAUNCHES
    solve = cg_fused.make_cg_solve(grid, cfg, lam=lam, precond="mg")
    res = solve(torch.tensor(b))
    assert cg_fused.LAUNCHES == before
    assert 0 < res.iters <= 30
    assert abs(res.iters - int(ref.iters)) <= 1
    bt = torch.tensor(b)
    Hu, Hv = el.face_depths(grid)
    r = (bt - el.laplacian_H(res.x, Hu, Hv, grid, cfg, lam=lam)) * grid.mask
    if lam == 0.0:
        r = (r - grid.mask * r.sum() / grid.mask.sum()) * grid.mask
    assert float(r.norm()) <= 20 * cfg.solver_tol * float(bt.norm())
    x_ref = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=0,
                               atol=1e-6 * np.abs(x_ref).max())
    # the kernel's cycle: the fused schedule, no de-mean
    levels, gamma = cg_fused.mg_levels(grid, cfg, lam)
    assert gamma == mg.fused_gamma_schedule(levels, 2)
    assert solve.steps == mg_coarse.cycle_steps(
        levels, lam, 2, 24, gamma, False, mg_coarse.tier_level(
            mg_coarse.level_shapes(levels), 8, mg_coarse.H100_SMEM))


def test_cg_mg_warm_start(sq):
    """A warm start from the cold solution takes at most one iteration."""
    _, _, cfg, grid, b = sq
    solve = cg_fused.make_cg_solve(grid, cfg, lam=0.0)     # auto -> mg
    cold = solve(torch.tensor(b))
    assert solve(torch.tensor(b), x0=cold.x).iters <= 1


def test_composed_precond_equals_eager_cycle(ragged):
    """make_mg_precond(smoother='fused') on CPU tensors (K4a with its
    residual on the fine levels, K5 on the <= coarse_size tail, their
    plain versions) equals the eager cycle with the same gamma schedule,
    bit for bit.  coarse_size 64 puts 200x136 and 100x68 above the tail,
    and min_ny 64 (as at 2048^2 the default 256) gives level 1 K4a."""
    _, _, cfg, grid, b = ragged
    levels = mg.build_levels(grid, cfg, 0.0)
    gamma = mg.fused_gamma_schedule(levels, 2)
    coarse = mg.make_fused_coarse(levels, 0.0, 2, 24, demean=False,
                                  coarse_size=64, gamma=gamma)
    assert coarse[0] == 2
    smooth = mg.make_fused_smoothers(levels, 2, 0.0, min_ny=64,
                                     stop=coarse[0])
    assert [s is not None for s in smooth] == [True, True, False, False]
    fused = mg.cycle_precond(levels, 0.0, 2, 24, gamma, smooth, coarse)
    eager = mg.cycle_precond(levels, 0.0, 2, 24, gamma)
    r = torch.tensor(b)
    np.testing.assert_array_equal(fused(r).numpy(), eager(r).numpy())
