"""Entry points: the port's twin of __graft_entry__.py.

`entry(device=None)` returns `(fn, (state,))`, one step of the flagship
configuration (the 1-layer double gyre at 256^2) through the fused
backend: on the card one call of `fn` is one launch of K1's single-step
kernel, on the CPU K1's plain version.

`dryrun_multichip(n)` runs the reference's seven legs of the distributed
step on a mesh of n shards: the eager tier (halo exchange op by op), the
shard kernels (K7: the fb step, its pass of 2 steps, the split step, the
projection phases around the mesh's elliptic solve) and the mesh solves.
The shards spread over the visible cards as the reference spreads them
over n devices: one rectangle of shards per card (card_placement; with
one card, or a device named, every shard on it, so "multichip" there
means n shards through the mesh path on one card).  The reference's
in-kernel halo exchange ("pallas+rdma") is K7 reading the neighbour
shards' rows in its stacked layout (across cards through their
pointers), so no leg needs the halo kernel (K8).  Every leg keeps the
reference's grid size and settings.

`run_leg(..., seed=s)` starts a leg from its case's state perturbed by s,
and `one_device_twins` pairs what a fused leg computed on the mesh with
what one device computes from the same state (K1 / K1s for a whole leg,
K3a / K3b for the projection phases): chip_smoke.py's phase 26 and the
card's tests hold the pairs bit for bit.

Both run on the card unless the caller passes a CPU device; with no card
they raise.

    python -m beom_tpu_torch.entry [n]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def entry(device=None):
    """(fn, (state,)): fn(state) is one fused step of the 256^2 double
    gyre."""
    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import device_of
    from beom_tpu_torch.stepping import make_stepper

    cfg, grid, forcing, state = make_case(
        "double_gyre", nx=256, ny=256, backend="fused",
        device=device_of(device))
    return make_stepper(grid, forcing, cfg), (state,)


def mesh_shape(n_devices: int):
    """n factored into a (my, mx) mesh, as square as possible."""
    my = int(np.floor(np.sqrt(n_devices)))
    while n_devices % my:
        my -= 1
    return my, n_devices // my


def card_grid(my: int, mx: int, n_cards: int):
    """The grid (cy, cx) of cards an (my, mx) mesh spreads over: the most
    cards, at most n_cards, that cut the mesh into equal rectangles (cy
    divides my, cx divides mx), and of those the squarest rectangle."""
    best = None
    for cy in range(1, my + 1):
        for cx in range(1, mx + 1):
            if my % cy or mx % cx or cy * cx > n_cards:
                continue
            key = (cy * cx, -abs(my // cy - mx // cx), cx)
            if best is None or key > best[0]:
                best = (key, (cy, cx))
    return best[1]


def card_placement(my: int, mx: int, cards: list) -> list:
    """The device of each shard of an (my, mx) mesh spread over `cards`:
    card_grid's rectangles, card (a, b) of the grid on cards[a cx + b]
    (the cards left over take none)."""
    cy, cx = card_grid(my, mx, len(cards))
    cmy, cmx = my // cy, mx // cx
    return [cards[(j // cmy) * cx + i // cmx]
            for j in range(my) for i in range(mx)]


@dataclasses.dataclass(frozen=True)
class Leg:
    """One leg of the dry run: make_case(case, nx=32 mx, ny=rows * my,
    **kw), with the mesh's shape in its Config unless config_mesh is
    False (the reference's first leg), stepped by make_dist_stepper with
    n_inner (2 model steps in all, as every leg of the reference)."""
    label: str
    case: str
    rows: int
    kw: tuple
    n_inner: int = 2
    config_mesh: bool = True

    def build(self, my: int, mx: int, device, **over):
        from beom_tpu_torch.cases import make_case

        kw = dict(self.kw, **over)
        if self.config_mesh:
            kw.update(mesh_y=my, mesh_x=mx)
        return make_case(self.case, nx=32 * mx, ny=self.rows * my,
                         device=device, **kw)


# the reference's legs (__graft_entry__.py), 'xla' -> eager and
# 'pallas' -> fused
LEGS = (
    Leg("eager", "double_gyre", 32, (("halo", 2),), config_mesh=False),
    Leg("fused", "double_gyre", 48, (("backend", "fused"),)),
    Leg("fused tb2", "double_gyre", 48,
        (("backend", "fused"), ("steps_per_pass", 2)), n_inner=1),
    Leg("split fused", "double_gyre", 48,
        (("backend", "fused"), ("scheme", "split"), ("nsub", 2))),
    Leg("rigid_lid fused+dist-MG-CG", "rigid_lid", 48,
        (("backend", "fused"),)),
    Leg("implicit_fs eager+dist-redblack", "double_gyre", 32,
        (("scheme", "implicit_fs"), ("solver", "redblack"),
         ("solver_maxiter", 40), ("halo", 2))),
    Leg("implicit_fs fused+dist-CG", "double_gyre", 48,
        (("scheme", "implicit_fs"), ("backend", "fused"))),
)


def perturb(cfg, grid, state, seed: int):
    """state plus a seeded perturbation of h, u and v under their masks:
    from the case's state at rest the first steps leave most terms at
    zero, and a wrong kernel would stay finite."""
    rng = np.random.default_rng(seed)

    def noise(amp, mask):
        a = amp * rng.standard_normal((cfg.nz, cfg.ny, cfg.nx))
        return torch.tensor(a.astype(cfg.npdtype), device=mask.device) * mask

    return state.replace(h=state.h + noise(0.5, grid.mask),
                         u=state.u + noise(0.05, grid.mask_u),
                         v=state.v + noise(0.05, grid.mask_v))


def run_leg(leg: Leg, mesh, device, seed=None, **over) -> dict:
    """Build the leg on `mesh` (from its case's state perturbed by `seed`
    where one is given), take its steps, check them; returns the leg's
    record: cfg, grid, forcing, the initial state and the final (sharded)
    one, the shard kernels' launches (dist_band.LAUNCHES moved by the leg)
    and, for a fused leg, the mesh plan."""
    from beom_tpu_torch.parallel.dist import make_dist_stepper
    from beom_tpu_torch.parallel.mesh import gather, shard_state
    from beom_tpu_torch.stencils import dist_band

    my, mx = mesh.shape["y"], mesh.shape["x"]
    cfg, grid, forcing, state = leg.build(my, mx, device, **over)
    if seed is not None:
        state = perturb(cfg, grid, state, seed)
    step = make_dist_stepper(grid, forcing, cfg, mesh, n_inner=leg.n_inner)
    plan = (dist_band.mesh_plan(cfg, cfg.tdtype, mesh)
            if cfg.backend == "fused" else None)
    before = dict(dist_band.LAUNCHES)
    out = step(shard_state(state, mesh))
    launches = {k: v - before[k] for k, v in dist_band.LAUNCHES.items()
                if v != before[k]}
    if out.n != 2:
        raise AssertionError(f"{leg.label}: n = {out.n}, not 2")
    for f in "huv":
        if not bool(torch.isfinite(gather(getattr(out, f))).all()):
            raise AssertionError(f"{leg.label}: {f} is not finite")
    return dict(leg=leg, cfg=cfg, grid=grid, forcing=forcing, state=state,
                out=out, launches=launches, plan=plan, mesh=mesh)


def one_device_twins(rec, seed: int = 0) -> list:
    """What a fused leg's record (run_leg) holds against one device:
    [(what, mesh fields, single-device fields)], pairs that the card
    computes to the same bits.

    fb, tb2 and split: the leg's gathered final h, u and v against the
    same steps of the single-device fused stepper (K1, K1s) from the
    leg's initial state.  rigid_lid and implicit_fs: the mesh's elliptic
    solve sums in another order than one device's, so the legs' steps
    differ in the last bits; their shard kernels are held instead, at
    both parities from the leg's initial state: shard_proj_a and
    shard_proj_b at the leg's mesh plan against K3a and K3b, phase B on a
    pressure made from `seed`."""
    from beom_tpu_torch.parallel.mesh import gather, shard
    from beom_tpu_torch.stencils import dist_band
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import make_stepper

    leg, cfg, mesh = rec["leg"], rec["cfg"], rec["mesh"]
    grid, forcing, st = rec["grid"], rec["forcing"], rec["state"]
    one = dataclasses.replace(cfg, mesh_y=1, mesh_x=1)
    if cfg.scheme in ("fb", "split"):
        step = make_stepper(grid, forcing, one)
        ref = st
        for _ in range(leg.n_inner):
            ref = step(ref)
        return [(f"{leg.label}: {ref.n} steps", [
            gather(getattr(rec["out"], f)) for f in "huv"],
            [getattr(ref, f) for f in "huv"])]
    pstatics, K = dist_band._held(grid, forcing, cfg, mesh)
    sh = [shard(getattr(st, f), mesh) for f in "huv"]
    rng = np.random.default_rng(seed)
    p = torch.tensor((0.1 * rng.standard_normal((cfg.ny, cfg.nx))).astype(
        cfg.npdtype), device=st.h.device) * grid.mask
    statics = (grid, forcing)
    pairs = []
    for n in (0, 1):
        a = dist_band.shard_proj_a(*sh, pstatics, n, cfg, kernels=K)
        one_a = fp.proj_a(st.h, st.u, st.v, statics, n, one)
        b = dist_band.shard_proj_b(sh[0], a[0], a[1], shard(p, mesh),
                                   pstatics, st.t, cfg, kernels=K)
        one_b = fp.proj_b(st.h, one_a[0], one_a[1], p, statics, st.t, one)
        pairs += [(f"{leg.label}: phase A, n = {n}",
                   [gather(x) for x in a], list(one_a)),
                  (f"{leg.label}: phase B, n = {n}",
                   [gather(x) for x in b], list(one_b))]
    return pairs


def dryrun_multichip(n_devices: int, device=None) -> list:
    """The seven legs on an n-shard mesh, spread over the visible cards as
    the reference spreads it over n devices: one rectangle of shards per
    card (card_placement; one card holds them all, and a named device
    too); prints a line per leg and returns their records (run_leg)."""
    from beom_tpu_torch.parallel.mesh import make_mesh
    from beom_tpu_torch.run import device_of

    dev = device_of(device)
    my, mx = mesh_shape(n_devices)
    cards = [dev]
    if device is None and dev.type == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    mesh = make_mesh(my, mx, devices=card_placement(my, mx, cards))
    records = []
    for leg in LEGS:
        rec = run_leg(leg, mesh, dev)
        cfg = rec["cfg"]
        print(f"dryrun_multichip: {leg.label} mesh=({my},{mx}) "
              f"grid=({cfg.ny},{cfg.nx}) steps=2 OK", flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    import sys
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
