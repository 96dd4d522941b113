#!/usr/bin/env python3
"""Smoke run of beom_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: a CUDA card must be present; prints its name and power limit
  2. build: compiles every kernel under beom_tpu_torch/csrc/ with nvcc,
     one process per source, all started together; K1's build lines
  3. K1 against its plain PyTorch version on the card, from a perturbed
     rest state: 256^2 f64 (20 steps, <= 1e-12 x field scale), f32 at
     256^2 and 2048^2 (1 step <= 4 ulp of field scale, 100 steps
     <= 1e-5 relative), 200x136 f64 (sizes not multiples of the tile),
     linear / no-slip f64; the plan of each (its launches per pass); one
     launch of the pass kernel of kb steps (the plan's kb, and kb = 4)
     bitwise equal to kb single-step launches from both parities at
     256^2 and 2048^2 f32 and 256^2 f64, and steps_per_pass=4 bitwise
     equal to 4 single steps
  4. main path: beom_tpu_torch.run.run on the 2048^2 f32 double gyre,
     backend='fused', steps_per_pass=4, 400 steps, diagnostics every
     100: finite diagnostics, max_speed > 0, K1 launched as the plan
     says per pass (its pass kernel), final fields within 1e-5 relative
     of 400 eager steps, and ms per step and grid-points/s of a second run
  5. times at 2048^2 f32 of the 4-step pass (the plan's launches, and the
     pass kernel of kb = 4 in one launch) beside four single-step
     launches and the plain version
  6. build lines of the projection kernels: K3a/K3b (projection.cu),
     K4a (rb_sweep.cu), K6 with Jacobi (cg_jacobi.cu)
  7. the projection kernels against their plain versions on the card,
     on the perturbed rigid-lid gyre: K3a and K3b as the plan runs them
     (the staged kernels, fused_projection.plan, printed) and as the
     single-step kernels, bit for bit, at 256^2 f64, 256^2 and 2048^2
     f32, 200x136 f64 and linear / no-slip, both sweep parities, with
     K3a's epilogue (the solve's right-hand side and warm start, with
     both carries, phi alone and none) bit for bit the eager
     composition; K4a bit for
     bit at 256^2 f64, 200x136 f64, 201x137 f64 with every cell wet (the
     periodic seams join cells of one colour) and 2048^2 f32, k = 1, 2, 8,
     forward and reverse, with and without the multigrid residual, lam =
     0 and > 0, and the blocked solve's pass (k = 0, 1, 2, 8: x and r bit
     for bit, sum r^2 against torch.sum); K6 with Jacobi at 256^2 f64,
     201x137 f64 wet everywhere, 200x136 f64 coastal_wetdry and 2048^2
     f32, lam = 0 and 1/(g dt^2), cold and warm: the true residual, x
     against the plain CG, the iteration counts within 1, two launches
     bitwise equal
  8. the projection path: run() on the 2048^2 f32 rigid-lid gyre with
     backend='fused', (a) scheme='implicit_fs' (CG + Jacobi: K3a, K6,
     K3b), 20 steps, and (b) solver='redblack' (K3a, K4a's solve mode,
     K3b), 10 steps: finite diagnostics, max_speed > 0, max|sum h - H|
     bounded, the launch counts (on (b) one K4a launch per pass and per
     solve, no eager operator), 3 fused steps against 3 eager steps, and
     (b)'s solve against the plain per-pass loop (pass count, x)
  9. times at 2048^2 f32: K3a, K3b (the plan's, beside the single-step
     kernels on the device, and K3a with its epilogue), a K4a sweep pass
     and solve pass and a K6 solve beside their plain versions; the
     host's us per launch of the stepper's held launches (Phases.a,
     a_rhs, b); for K6 also the kernel's own
     span from %globaltimer stamps (the launch's timing mode) beside the
     events around the call and its time under torch.profiler, and us per
     iteration; ms/step of (a) and (b) through run(), (b)'s busy share
     under torch.profiler, and (a) and (b) by part (step_parts: the device
     time of K3a, K3b, the solve and each glue kernel per step, the idle
     share, the idle gaps by the parts around them)
 10. build lines of the multigrid kernels: K4a's residual mode and K4b
     (rb_sweep.cu), K5 (mg_coarse.cu), K6-mg (cg_fused.cu, both sharing
     mg_cycle.cuh)
 11. the multigrid kernels against their plain versions at 256^2 f64,
     2048^2 f32 and 200x136 f64, lam = 0 and > 0: K4a with its residual
     (forward and reverse) and K4b (both modes) bit for bit; K5 on the
     512^2 tail of the 2048^2 hierarchy and on the whole 200x136 one,
     de-mean off (bit for bit) and on (bounded), two launches equal; K6
     with the multigrid preconditioner against the plain PCG (iterations
     within 1, x bounded, bitwise reproducible, a warm start from the
     solution <= 1 iteration); the composed fused preconditioner against
     the eager cycle with the same gamma schedule
 12. the multigrid paths: run() on the 2048^2 f32 rigid lid with (c) its
     default solve (CG + multigrid: K3a, K6, K3b), 20 steps, and (d)
     solver='mg' (K3a, K4b, K4a on levels 0 and 1, K5, K3b), 10 steps:
     the launch counts against the cycles, finite diagnostics,
     max|sum h - H| bounded, 1 fused step against 1 eager one (an eager
     step takes 12 to 28 s with the machine's host)
 13. times at 2048^2 f32: K4a with its residual, K4b, K5 (with and
     without its shared-memory tier), a K6-mg solve (per iteration), a
     solver='mg' solve (per cycle) beside their plain versions, K5's and
     K6-mg's span by their stamps beside the events and the profiler, (c)
     and (d) in ms/step through run(), (d)'s busy share under torch.profiler,
     and the grid syncs per K6-mg cycle and per K5 visit beside those of
     the walk before the tier

 14. build lines of the fb and split builds of the other cases (fb_step.cu
     and split_step.cu, one library per combination of compile-time
     switches, all built in phase 2 beside the others)
 15. K1 on two_layer, coastal_wetdry and shelf_forced (both sweep parities,
     steps_per_pass 1 and 4; the pass kernel of kb = 2 where its block fits
     a CTA, one launch bitwise 2 single-step launches) and K1s, as its
     three kernels and as the
     chained step, on double_gyre and two_layer (nsub 4 and 8) and
     shelf_forced (nsub 8) against
     their plain versions at 200x136 f64 (<= 1e-12 x scale) and 2048^2 f32
     (<= 4 ulp of scale), from a perturbed state with dry cells and the
     open boundary inside the compared region; K1s's two-launch route on
     the same cases bit for bit at 201x137 f64 and f32 and 2048^2 f32: the slow phase's tendencies against slow_tendencies, the
     tail against depth_means + fast_phase, 3 steps against 3 plain steps
     and 3 steps of the three kernels (the plan's tail geometry, also
     where the plan keeps the three kernels)
 16. the other paths at full width: run() with backend='fused' at 2048^2
     f32, diagnostics on: two_layer fb; double_gyre split with nsub 4, 8
     and 12 and two_layer split nsub 8 (two launches per step),
     shelf_forced split nsub 8 (three); coastal_wetdry, shelf_forced and
     the double gyre (steps_per_pass 1: the single-step kernel) fb:
     the launch counts by each path's split plan, finite diagnostics, the
     mass drift of the closed basins, h >= 0 under wet/dry, 3 fused steps
     against 3 eager ones
 17. times at 2048^2 f32: K1 per case (one step, and the 4-step pass by
     the case's plan, printed, beside four single steps, the plain
     version and the pass kernel of kb = 2) and K1s's kernels at nsub 8
     beside their plain versions (the two launches on double_gyre and
     two_layer, the three kernels on shelf_forced; the other route's
     printed), the split step at nsub 4, 8, 12 and on two_layer at nsub 8
     by its plan beside the three kernels and the function's bound, and
     the device's busy share under torch.profiler for two_layer fb and
     split nsub 8

 18. build lines of the libraries this list adds (projection.cu per case,
     shard_step.cu per fb case, halo_pad.cu); K3a / K3b with every term
     (the plan's and the single-step kernels, and K3a's epilogue, as in
     phase 7; each case's plan printed) bit for bit their plain versions
     at 200x136 f64 and 2048^2 f32 on
     two_layer, coastal_wetdry (dry cells in the state) and shelf_forced
     (open faces, the tide at t + dt), both parities; run() of 10 steps at
     2048^2 f32, backend='fused', with rigid_lid and implicit_fs on
     two_layer and shelf_forced and implicit_fs on coastal_wetdry (the
     shelf's rigid lid 2 steps: there the fused tier's cycle stalls CG,
     each step runs K6 to its 500 iterations and the stall guard redoes
     the solve with the W-cycle through K4a, K4b and K5): the launch
     counts, the solves the guard redid, 2 fused steps against 2 eager ones
 19. K8 (the halo pad) against pad2d by slices and concatenations on
     meshes (2, 4), (1, 8), (8, 1), (1, 1), w = 1, 3, 5, 2-D and layered
     fields, f32 and f64, on a 2048^2 and a 192x128 grid: bit for bit, one
     launch for every shard
 20. K7-fb against its plain version per shard and bit for bit against
     single-device K1 on the gathered field, on (4, 1), (2, 4) and (2, 2),
     for all four fb cases, both parities, k = 1 and 2 by the mesh plan
     (its launches counted), and the pass kernel of kb = 2 and 3 (where
     its block fits a CTA) bit for bit K1's pass kernel, at 192x128 f64
     and 2048^2 f32
 21. the mesh path: run() on the 2048^2 f32 double gyre on a 2 x 4 mesh of
     shards on the card, backend='fused', steps_per_pass=4, 200 steps,
     diagnostics every 100: K7-fb's launches by the mesh plan (printed;
     one launch per kernel for every shard), the diagnostics and the final
     state equal to the single-device K1 run's; steps_per_pass 1 (the
     single-step kernel, one launch per step), 20 steps, equal to the
     single-device run; K8's path: run() on the same case and mesh with
     backend='eager', halo_impl='rdma', 20 steps, K8's count set to 0 just
     before and read just after (3 pad2d per step, one launch each),
     diagnostics and final state equal to the single-device eager run's;
     then 3 steps of each scheme at 512^2 f32 on (2, 4) against the
     single-device eager step, and one rigid-lid step with the distributed
     multigrid-preconditioned CG at 128^2 on (2, 2)
 22. times: K7-fb's single step, its pass kernel's launch and a 4-step
     pass at 2048^2 and 8192^2 f32 on (2, 4) beside K1 (a 4-step pass at
     8192^2 held against K1's), K8 per pad2d at w = 5 on the 1024x512
     shards of 2048^2, each between CUDA events and on the device under
     torch.profiler, and the profiler's busy share of the mesh run
 23. K7 around the split body (route 3's three kernels, route 2's
     tendencies and tail) and around the projection phases (the staged
     kernels) against their plain versions per shard (192x128 f64 within
     1e-12 x scale, 2048^2 f32 within 4 ulp of scale) and against the
     single-device kernels (K1s; K3a / K3b) on the gathered field bit for
     bit, on (4, 1), (2, 4) and (2, 2): split at nz 1 and 2, nsub 4, 8,
     12, and the shelf at nsub 8 (route 3), each kernel against K1s's and
     a 2-step pass against K1s's step by the plan's route, its launches
     counted; projection on the four fb cases with implicit_fs and
     rigid_lid (Jacobi), both parities, one launch per phase; and the
     single-step phases where no staged geometry fits a CTA (two_layer
     split to 3 layers, coastal_wetdry to 5, f64, (2, 2)), bit for bit the
     single-device K3a / K3b of the same plan
 24. the new mesh paths through run() at 2048^2 f32 on a 2 x 4 mesh of
     shards on the card, backend='fused': double_gyre split nsub 8, 100
     steps, diagnostics every 50, two launches per step (route 2), state
     and diagnostics equal to the single-device K1s run's bit for bit;
     shelf_forced split nsub 8, 10 steps, three launches per step (route
     3), equal to the single-device run; the rigid-lid gyre with
     scheme='implicit_fs', 5 steps, one launch per phase and step and one
     K6-Jacobi launch per step (the mesh's solve on the gathered grid of
     the shards, stencils/mesh_solve.py), bit for bit the single-device
     fused run (K3a, K6, K3b) and against the eager mesh run (its own
     sums) h within 1e-6 x its scale and u, v within 1e-3 x the
     velocity's, a bound the same run with the solve stopped after 10
     iterations must exceed, and at 512^2 f64 one step within 1e-6 x
     scale of the eager mesh step; the rigid lid's default solve (CG +
     multigrid: K6-mg on the mesh's hierarchy, gamma 2 at every
     transition) on (2, 2), phase A, one K6 launch and phase B per step,
     the first step within 1e-5 x max(scale, 1) of the single-device fused
     step (K6-mg on its own hierarchy) from rest at 256^2 f64 and f32 and
     from a perturbed state (u, v of order 0.1) at 512^2 f32, and at 256^2
     against the eager mesh step (the plain version): f64 within 1e-6 x
     scale, f32 within the 2 x 4 run's bound; 5 more steps timed at 512^2,
     the cycle's steps and grid syncs beside the single-device cycle's;
     solver='redblack' at 512^2 f64 on (2, 2), 3 steps, K4a's sweep passes
     counted (480 sweeps in 60 passes per step, no K6), the first within
     1e-6 x scale of the eager mesh step
 25. times at 2048^2 f32 on (2, 4): K7-split's five kernels and a whole
     split step beside K1s's, K7-proj's two phases beside K3a / K3b, each
     between CUDA events and on the device under torch.profiler; the
     implicit-FS mesh step's time split into phase A, the right-hand side,
     the solve and phase B, through the mesh's solve on the card and
     through the eager mesh solve; the mesh's solve by route (K6-Jacobi
     there, K6-mg and K4a's sweeps at 512^2 on (2, 2)): x against the
     eager mesh solve on the same right-hand side, its time per solve
     beside the eager one's, its kernel's device time, the iterations.
     `python3 chip_smoke.py --mesh` runs phases 23 to 25 alone, after
     their builds
 26. the I/O and entry modules on the card, at 2048^2 f32 unless said: raw
     snapshots of the fused double gyre after 20 steps, written
     synchronously and through the async writer (io/native.py) in one
     `with`, byte-equal files of 3 nz ny nx 4 bytes, loaded back onto the
     card bit for bit, the same for the state on 2 x 4 shards (gathered),
     each write's seconds; a Config read by load_toml from a TOML file
     (case, nx, ny, scheme, backend='fused', steps_per_pass=4) driving
     run() for 20 steps (finite diagnostics, K1's launches by the plan);
     entry(): one call is one K1 launch, bit for bit K1's plain version;
     dryrun_multichip(8): the seven legs on a 2 x 4 mesh of shards on the
     card, each leg's plan printed, K7's launches on legs 2-5 and 7 by
     their plans (the counts set to 0 just before, read just after);
     multihost: init(num_processes=1) a no-op, is_primary(),
     gather_to_host of a 2 x 4-sharded field equal to mesh.gather
 27. the fused mesh over several cards, checked on the one card: the 2 x 4
     mesh's shards as two cards, each its own stacks (the builds with
     BEOM_CARDS = 1), the second launching on a side stream, split along
     x (two 2 x 2) and along y (two 1 x 4), at 2048^2 f32: K7-fb's 4-step
     pass, K7-split at nsub 8 (route 2) and the shelf's (route 3), K7-proj
     A and B at both parities, each bit for bit the one-stack route and
     the single-device kernel (K1, K1s, K3a / K3b), one launch per card
     and kernel counted; 2 implicit-FS mesh steps over the two cards (the
     solve's right-hand side gathered from both cards' stacks, one K6
     launch per step, x copied back into each card's stack) bit for bit
     the one-stack stepper; K8 at w = 5 (2-D and layered) bit for bit the
     one-stack launch and pad2d; run() of the mesh fb path over the two
     cards, 400 steps with diagnostics every 100, bit for bit the
     one-stack run; each kernel's time between CUDA events and on the
     device for both routes.  Where two cards are visible the same legs
     run over cuda:0 and cuda:1; with one card that leg is skipped and
     says so.  The times are taken on the split along x.  `python3
     chip_smoke.py --cards` runs this phase alone, after its builds.
 28. many layers and tidal constituents: shelf_forced (wet/dry, Flather,
     sponge, wind, bottom drag) at 2048^2 f32 with 32 layers and 13 of
     TPXO's constituents, past the shared-memory walls of K1 (24 layers)
     and K3a / K3b (31): K1 and both projection phases stream their layers
     through a few shared-memory planes of one layer (K1 two launches per
     step, the continuity and the momentum), and K1s's slow phase and
     recomposition (route 3) too, on one device and on the shards alike
     (K7-fb, K7-split, K7-proj).  Paths, each with the counts set to 0 just
     before and read just after: run() with backend='fused', 100 steps,
     diagnostics every 50 (finite; K1's two streamed kernels once per
     step), run() of the split scheme 10 steps, of the implicit free
     surface 3 steps (K3a and K3b layer-streamed, one K6 launch per
     step), and the three again on 2 x 2 shards of the card (K7-fb's two
     streamed kernels once per step, K7-split's slow phase once and its
     recomposition's two, K7-proj streamed around one K6 launch per step
     on the gathered grid; the fb and split runs' diagnostics lines those
     of the single-device runs; the implicit-FS mesh step's ms between
     events and K6's device time in it); the implicit free surface at
     512^2 f64 with 16 layers, on one device and on 2 x 2 shards.  Then K1 (both parities;
     its continuity's h1 and its momentum's u, v each held and each kernel
     timed on the device beside the plain continuity and the plain
     momentum with finalize), K1s at nsub 8 on its plan's route (route 3,
     its three kernels and the step) and K3a / K3b (both parities) bit for
     bit their plain versions (K3a's div within 4 ulp / 1e-12 of its
     scale: past two layers the plain version's torch.sum adds in an order
     of its own), K7-fb, K7-split and K7-proj on 2 x 2 shards bit for bit
     the single-device kernels, and as two cards' stacks of the card (the
     BEOM_CARDS build) bit for bit the one-stack route, each kernel's time
     between CUDA events and on the device beside its plain version's
     (K7-split's slow phase and recomposition each alone); the same checks
     at 512^2 f64 with 16 layers, K3a / K3b and K7-proj timed there too; at
     nz 8 f32, where every route builds, the routes forced by the plans'
     own parameter bit for bit the shared-memory route for K1, K1s and K3a
     / K3b, both timed, 2 steps each of K1 and of the split step on the
     forced route (their paths), and one step each of K7-fb and K7-split
     layer-streamed on 2 x 2 shards (their paths), bit for bit K1 and K1s
     on the shared-memory route.  `python3 chip_smoke.py --layers` runs
     this phase alone, after its builds.

The line before the last is the kernels' JSON record, each kernel with its
time, its plain version's, and the least time the card could take for the
same work (`bound`; for the fb pass kernel, the kb steps of one launch);
the last is {"ok": true, "device": {...}}.  It imports no jax.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BIG = 2048
KERNELS = ("fb_step", "projection", "rb_sweep", "cg_jacobi", "cg_fused",
           "mg_coarse", "halo_pad", "peers")
FB_CASES = ("double_gyre", "two_layer", "coastal_wetdry", "shelf_forced")
# the runs of phase 18: (case, scheme, Config overrides, steps, grid of the
# eager twin, bound of the fused steps against the eager ones).  The rigid
# lid takes its default solve (CG + multigrid).  On the shelf the fused
# tier's cycle stalls that solve (in the reference too), so every step runs
# K6 to its iteration limit and the stall guard redoes the solve with the
# W-cycle.  At 2048^2 that solve stagnates at float32 as well (it converges
# at float64 and at 1024^2), so the run there takes a limit of 100
# iterations and fewer steps, and the three steps against the eager path
# are taken at 1024^2 with the default limit, where the guard's solve
# converges
PROJECTION_PATHS = (
    ("two_layer", "rigid_lid", {}, 10, BIG, 1e-5),
    ("two_layer", "implicit_fs", {}, 10, BIG, 1e-5),
    ("shelf_forced", "rigid_lid", dict(solver_maxiter=100), 2, 1024, 1e-5),
    ("shelf_forced", "implicit_fs", {}, 10, BIG, 1e-5),
    ("coastal_wetdry", "implicit_fs", {}, 10, BIG, 1e-5))
# the H100 SXM data sheet: device memory, and float32 outside the tensor
# cores; a kernel's bound is the larger of its bytes and its operations
# over these
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the paths of phase 16: (case, Config overrides, steps)
PATHS = (
    ("two_layer", {}, 40),
    ("double_gyre", dict(scheme="split", nsub=4), 20),
    ("double_gyre", dict(scheme="split", nsub=8), 20),
    ("double_gyre", dict(scheme="split", nsub=12), 20),
    ("two_layer", dict(scheme="split", nsub=8), 20),
    ("shelf_forced", dict(scheme="split", nsub=8), 20),
    ("coastal_wetdry", {}, 20),
    ("shelf_forced", {}, 20),
    ("double_gyre", {}, 20),
)
# the (case, nsub) pairs phase 15 holds K1s against its plain version on
# (the shelf at nsub 8 keeps the three kernels: split_plan)
AGREE_SPLIT = (("double_gyre", 4), ("double_gyre", 8), ("two_layer", 4),
               ("two_layer", 8), ("shelf_forced", 8))
# the (case, nsub) pairs and the meshes phase 23 holds K7-split on: nz 1
# and 2, nsub 4, 8, 12 (route 2), and the shelf at nsub 8 (route 3)
MESH_SPLIT = tuple((case, nsub) for case in ("double_gyre", "two_layer")
                   for nsub in (4, 8, 12)) + (("shelf_forced", 8),)
MESH_SHAPES = ((4, 1), (2, 4), (2, 2))
# the grids of phase 24's rigid lid with CG + multigrid on (2, 2): the
# mesh's solve runs K6-mg on the gathered grid at MG_MESH_N; the eager mesh
# solve, the plain version it is held against, takes ~20 s per step at
# MG_EAGER_N (~45 s at 512^2, more than the script's time limit allows)
MG_MESH_N = 512
MG_EAGER_N = 256
# phase 24's bound on a fused mesh step at f32 against the eager mesh
# step, whose solve sums in another order: h within 1e-6 x its scale, u
# and v within MESH_F32_REL x the velocity's scale (state_errs); and the
# iterations after which a stopped solve must read over it
MESH_F32_REL = 1e-3
MESH_F32_BOUND = {"h": 1e-6, "u": MESH_F32_REL, "v": MESH_F32_REL}
WRONG_ITERS = 10
# grid fields a K6-Jacobi iteration streams, on average (csrc/cg_jacobi.cu:
# reads r, w, s, p, pm, Hu, Hv, writes r, w, s, p, and every other pass
# reads and writes x)
JACOBI_FIELDS = 12
# (b)'s sweep budget: a multiple of the 8 sweeps per K4a pass, so that
# the fused solve's passes do the eager solve's sweeps when neither
# converges early
RB_MAXITER = 480


_T0 = time.perf_counter()


def phase(name):
    print(f"== {name} [{time.perf_counter() - _T0:.0f} s in]", flush=True)


def rel(r):
    """The bound r x max|ref|, as a function of the reference."""
    return lambda ref: r * float(ref.abs().max())


def ulps(k):
    """The bound of k float32 ulps at max|ref|."""
    import numpy as np

    return lambda ref: k * float(np.spacing(
        np.float32(ref.abs().max().item())))


def kernel_entry(name, src, site, launches, err, ms, n_bytes, n_ops,
                 site_dir="stencils", device=None, extra=None):
    """One kernel of the JSON record.  ms = (kernel, plain), between CUDA
    events; `device`, where it was measured, is the kernel's own time
    under torch.profiler (`device_ms`).  bound_ms is the larger of n_bytes
    (each input read once, each output written once) over the memory rate
    and n_ops over the float32 rate.  `extra` adds keys of the row's own
    (a function launched as several kernels lists them there).  None of
    these kernels has a single PyTorch call that computes the same
    function."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    extra = dict(extra or {})
    if device is not None:
        extra["device_ms"] = device
    return {**extra, "name": name, "route": "cuda",
            "source": f"beom_tpu_torch/csrc/{src}",
            "replaces": f"beom_tpu/{site_dir}/{site}", "launches": launches,
            "max_abs_err": err, "ms": ms[0], "plain_ms": ms[1],
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


def step_fields(cfg):
    """Fields one fb or split step must move: h, u, v in and out, the
    grid's six, and the forcing fields of the switches that are on."""
    n = 6 * cfg.nz + 6 + 2 * cfg.wind + cfg.sponge
    n += cfg.nz * (cfg.sponge or cfg.obc)
    return n + cfg.obc * (3 + 2 * len(cfg.tides))


def stream_fields(cfg):
    """(continuity, momentum) fields the two parts of an fb step move, each
    of its operands once: the continuity reads h, u, v, three masks, the
    sponge and h_ext, the clamp's map and the tides and writes h1; the
    momentum and finalize read h1, u, v, four masks, H, f, the wind, the
    sponge, Flather's maps and the tides and write u, v."""
    nz, nt = cfg.nz, len(cfg.tides)
    cont = 4 * nz + 3 + cfg.sponge + nz * (cfg.sponge or cfg.obc) \
        + cfg.obc * (1 + 2 * nt)
    mom = 5 * nz + 6 + 2 * cfg.wind + cfg.sponge + cfg.obc * (2 + 2 * nt)
    return cont, mom


def split_fields(cfg):
    """Fields route 3's slow phase and recomposition move, each of its own
    operands once: the slow phase reads h, u, v, the four masks, H, f, the
    wind and the sponge and writes SlowPhase (4 nz + 9); the recomposition
    reads 4 nz + 2 of SlowPhase, the subcycle's 5, h, H, 3 masks and
    Flather's two maps and the tides and writes h, u, v.  Neither reads
    h_ext or the clamp's map: their continuity has no sponge or clamp."""
    return {"split_slow": 7 * cfg.nz + 15 + 2 * cfg.wind + cfg.sponge,
            "split_recompose": 8 * cfg.nz + 11
            + cfg.obc * (2 + 2 * len(cfg.tides))}


def cycle_ops(steps, levels, nu=2):
    """Operations of one walk of a multigrid cycle's step list: about 10
    per point and pass of each step's level, a tiled pass counted as the
    plain passes it does (OP_PRE 2 nu half-sweeps, the residual and the
    restriction; OP_POST the prolongation and 2 nu half-sweeps; OP_SWEEPS
    its count of half-sweeps), the tier's loads and stores as none."""
    from beom_tpu_torch.stencils import mg_coarse as mc

    passes = {mc.OP_PRE: 2 * nu + 2, mc.OP_POST: 2 * nu + 1,
              mc.OP_TIER_IN: 0, mc.OP_TIER_OUT: 0}
    return 10 * sum(
        (st[4] >> 2 if st[0] == mc.OP_SWEEPS else passes.get(st[0], 1))
        * levels[st[1]].mask.numel() for st in steps)


def walk_syncs_before(shapes, gamma, demean):
    """Grid syncs of the cycle's walk before the shared-memory tier and the
    tiled passes: one plain pass per step, a grid sync after each but
    between two steps on levels of at most 16^2 points."""
    from beom_tpu_torch.stencils import mg_coarse as mc

    steps = []
    for op, lev, a, b, c, _ in mc.cycle_steps(shapes, 0.0, 2, 24, gamma,
                                              demean, 0)[1:-1]:
        solo = int(shapes[lev][0] * shapes[lev][1] <= 16 * 16)
        # a run of half-sweeps was one step each
        n = c >> 2 if op == mc.OP_SWEEPS else 1
        steps += [(op, lev, a, b, c, solo)] * n
    return mc.grid_syncs(steps)


def perturbed_case(device, seed, case="double_gyre", **kw):
    """A case plus a seeded perturbation of h, u and v (from rest, the
    first step leaves most terms at zero)."""
    import numpy as np
    import torch

    from beom_tpu_torch.cases import make_case

    cfg, grid, forcing, st = make_case(case, device=device, **kw)
    rng = np.random.default_rng(seed)

    def noise(amp, m):
        a = amp * rng.standard_normal((cfg.nz, cfg.ny, cfg.nx))
        return torch.tensor(a.astype(cfg.npdtype), device=device) * m

    st = st.replace(h=st.h + noise(0.5, grid.mask),
                    u=st.u + noise(0.05, grid.mask_u),
                    v=st.v + noise(0.05, grid.mask_v))
    return cfg, grid, forcing, st


def compare(label, device, n_steps, tol, seed=0, **kw):
    """K1 vs its plain version over n_steps; tol(ref_field) -> bound.
    Returns the largest absolute difference."""
    import torch

    from beom_tpu_torch.stencils import fused_fb

    variant = {k: kw.pop(k) for k in ("adv_scheme", "slip") if k in kw}
    cfg, grid, forcing, st = perturbed_case(device, seed, **kw)
    cfg = dataclasses.replace(cfg, **variant)
    args = (st.h, st.u, st.v, (grid, forcing), st.n, st.t, cfg, n_steps)
    out = fused_fb.fused_fb_step(*args)
    torch.cuda.synchronize()
    ref = fused_fb.fused_fb_step_plain(*args)
    worst = 0.0
    for f, a, b in zip("huv", out, ref):
        err = float((a - b).abs().max())
        bound = tol(b)
        print(f"   {label} {f}: max|K1 - plain| {err!r} "
              f"(bound {bound!r}, scale {float(b.abs().max())!r})")
        if not err <= bound:
            raise AssertionError(f"{label} {f}: {err!r} > {bound!r}")
        worst = max(worst, err)
    return worst


def fb_pass_specs():
    """The builds of K1 the fb phases launch beyond phase 2's plans: each
    fb case's pass of 4 steps at f32 and f64 by its plan, the pass kernel
    of kb = 2 where its block fits a CTA, and the gyre's of kb = 4."""
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.stencils import fused_fb

    specs = set()
    for name in FB_CASES:
        for dtype in (torch.float32, torch.float64):
            cfg = make_case(name, nx=16, ny=16, device="cpu",
                            dtype=str(dtype).split(".")[1])[0]
            specs |= fused_fb.pass_specs(cfg, 4, dtype)
            for kb in (2, 4) if name == "double_gyre" else (2,):
                if fused_fb.launch_plan(cfg, dtype, kb) is not None:
                    specs.add(fused_fb.build_spec(cfg, dtype, kb))
    return specs


def pass_vs_singles(label, device, seed, case, kbs, **kw):
    """One launch of K1's pass kernel of kb steps against kb single-step
    launches, bit for bit, from both sweep parities, for the plan's kb of
    a 4-step pass and each of `kbs` whose block fits a CTA; prints the
    plan."""
    import torch

    from beom_tpu_torch.stencils import fused_fb

    cfg, grid, forcing, st = perturbed_case(device, seed, case, **kw)
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    statics = (grid, forcing)
    pl = fused_fb.plan(cfg, cfg.tdtype, 4)
    print(f"   {label} {case}: plan of a 4-step pass: {pl.describe()}, "
          f"launches {pl.launches(4)}")
    for kb in sorted({pl.kb, *kbs} - {1}):
        if fused_fb.launch_plan(cfg, cfg.tdtype, kb) is None:
            continue
        ts = fused_fb._times(st.t, cfg, kb)
        for n in (0, 1):
            out = fused_fb._launch_fb(st.h, st.u, st.v, statics, n % 2, ts,
                                      cfg)
            h, u, v = st.h, st.u, st.v
            for i in range(kb):
                h, u, v = fused_fb._launch_fb(h, u, v, statics, (n + i) % 2,
                                              ts[i:i + 1], cfg)
            torch.cuda.synchronize()
            for f, a, b in zip("huv", out, (h, u, v)):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{label} {case}: the pass kernel of kb = {kb} "
                        f"from n = {n} != {kb} single steps in {f}")
        print(f"   {label} {case}: one launch of kb = {kb} steps bitwise "
              f"equal to {kb} single-step launches from n = 0 and 1 "
              f"({fused_fb.launch_plan(cfg, cfg.tdtype, kb).describe()})")


def fb_times(case, cfg, statics, st, smi, launches, err):
    """The 4-step pass of K1 at 2048^2 by the case's plan, beside four
    single-step launches, the pass kernel of kb = 2 and (on the gyre) of kb
    = 4 in one launch, and the plain version's 4 steps; the single step
    beside its plain version.  Returns the JSON entries {"single": ...,
    "pass": ... (None where the plan runs no pass kernel)}: `launches` =
    (single-step, pass) launches of their paths."""
    from beom_tpu_torch.stencils import fused_fb

    pts = cfg.nx * cfg.ny
    pl = fused_fb.plan(cfg, cfg.tdtype, 4)
    h, u, v = st.h, st.u, st.v
    ts = fused_fb._times(st.t, cfg, 4)
    saved = fused_fb.LAUNCHES, fused_fb.PASS_LAUNCHES

    def launches_of(steps):
        def go():
            a, b, c, done = h, u, v, 0
            for m in steps:
                a, b, c = fused_fb._launch_fb(a, b, c, statics, done % 2,
                                              ts[done:done + m], cfg)
                done += m
            return a, b, c
        return go

    single, one_plain = time_pair(
        f"K1 {case} one step",
        lambda: fused_fb.fused_fb_step_plain(h, u, v, statics, 0, st.t, cfg,
                                             1),
        launches_of([1]), 10, 200, unit="step")
    print(f"   K1 {case}: plan of a 4-step pass: {pl.describe()}, launches "
          f"{pl.launches(4)} ({smi})")
    runs = {"plan": pl.launches(4), "4 single steps": [1] * 4}
    for kb in (2, 4) if case == "double_gyre" else (2,):
        if fused_fb.launch_plan(cfg, cfg.tdtype, kb) is not None:
            runs[f"pass kernel kb = {kb}"] = fused_fb.launch_steps(4, kb)
    plain4 = time_ms(lambda: fused_fb.fused_fb_step_plain(
        h, u, v, statics, 0, st.t, cfg, 4), 5)
    order = list(runs) + list(reversed(runs))
    got = {}
    for name in order:
        got.setdefault(name, []).append(time_ms(launches_of(runs[name]), 100))
    for name in runs:
        ms = got[name]
        print(f"   K1 {case} 4-step pass, {name} {runs[name]}: {ms!r} ms "
              f"({pts * 4 / (sum(ms) / len(ms)) * 1e3!r} grid-point steps/s)"
              f"; plain version {plain4!r} ms ({smi})")
    fused_fb.LAUNCHES, fused_fb.PASS_LAUNCHES = saved
    suffix = "" if case == "double_gyre" else f"_{case}"
    entries = {"single": kernel_entry(
        "fb_step" + suffix, "fb_step.cu", "band.py:200", launches[0], err,
        (single, one_plain), step_fields(cfg) * pts * cfg.npdtype.itemsize,
        150 * cfg.nz * pts), "pass": None}
    if pl.kb > 1:
        # the pass kernel's function: kb steps, each operand read once and
        # each result written once; its error against kb plain steps
        import torch

        got_kb = launches_of([pl.kb])()
        torch.cuda.synchronize()
        ref = fused_fb.fused_fb_step_plain(h, u, v, statics, 0, st.t, cfg,
                                           pl.kb)
        err = max(float((a - b).abs().max()) for a, b in zip(got_kb, ref))
        fused_fb.LAUNCHES, fused_fb.PASS_LAUNCHES = saved
        ms = got["plan"]
        per_launch = sum(ms) / len(ms) / len(pl.launches(4))
        plain_kb = time_ms(lambda: fused_fb.fused_fb_step_plain(
            h, u, v, statics, 0, st.t, cfg, pl.kb), 5)
        entries["pass"] = kernel_entry(
            "fb_pass" + suffix, "fb_step.cu", "band.py:200", launches[1],
            err, (per_launch, plain_kb),
            step_fields(cfg) * pts * cfg.npdtype.itemsize,
            150 * cfg.nz * pl.kb * pts)
    return entries


def print_build(build, name):
    """nvcc's time and the register and spill lines of one source."""
    if name not in build.BUILD_LOG:
        print(f"   {name}: loaded from the build cache")
        return
    secs, log = build.BUILD_LOG[name]
    print(f"   {name}: nvcc {secs:.2f} s")
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '.*?\d([a-z_]+_kernel)I"
                          r"([fd])", line)
        if entry:
            print(f"   {entry[1]}<{'float' if entry[2] == 'f' else 'double'}>")
        elif "registers" in line or "spill" in line:
            print("   " + line.strip())


def compare_fields(label, names, outs, refs, tol):
    """max|kernel - plain| of each field against tol(plain field).
    Returns the largest."""
    worst = 0.0
    for f, a, b in zip(names, outs, refs):
        err = float((a - b).abs().max())
        bound = tol(b)
        print(f"   {label} {f}: max|kernel - plain| {err!r} "
              f"(bound {bound!r}, scale {float(b.abs().max())!r})")
        if not err <= bound:
            raise AssertionError(f"{label} {f}: {err!r} > {bound!r}")
        worst = max(worst, err)
    return worst


def shard_step_specs():
    """The builds of K7-fb the mesh phases launch: each fb case's 4-step
    pass on 2 x 4 shards of the 2048^2 grid by its mesh plan and the
    single-step kernel, at f32 and f64, and the pass kernel of kb = 2 and
    3 where its block fits a CTA."""
    import dataclasses

    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.parallel.mesh import make_mesh
    from beom_tpu_torch.stencils import dist_band, fused_fb

    specs = set()
    mesh = make_mesh(2, 4, devices=["cpu"])
    for name in FB_CASES:
        for dtype in (torch.float32, torch.float64):
            cfg = dataclasses.replace(make_case(
                name, nx=16, ny=16, device="cpu",
                dtype=str(dtype).split(".")[1], steps_per_pass=4)[0],
                nx=BIG, ny=BIG)
            specs |= dist_band.build_specs(cfg, dtype, mesh)
            for kb in (2, 3):
                if fused_fb.launch_plan(cfg, dtype, kb) is not None:
                    specs.add(dist_band.build_spec(cfg, dtype, kb))
    return specs


def projection_spec(cfg):
    """The build of projection.cu that runs cfg by its plan: the staged
    kernels' geometry, the masks rebuilt (every case's grid is
    make_grid's)."""
    from beom_tpu_torch.stencils import fused_projection as fp

    return fp.build_spec(cfg, cfg.tdtype, fp.plan(cfg, cfg.tdtype), True)


def check_phases(label, device, tol, seed, **kw):
    """K3a and K3b, as the plan runs them (the staged kernels) and as the
    single-step kernels, against their plain versions at both sweep
    parities, bit for bit (tol bounds what is printed beside it); K3a's
    epilogue (the solve's right-hand side and warm start, with both
    carries, phi alone and none) bit for bit the eager composition.
    Returns (worst K3a, worst K3b) differences."""
    import numpy as np
    import torch

    from beom_tpu_torch.stencils import fused_projection as fp

    variant = {k: kw.pop(k) for k in ("adv_scheme", "slip") if k in kw}
    case = kw.pop("case", "rigid_lid")
    cfg, grid, forcing, st = perturbed_case(device, seed, case, **kw)
    cfg = dataclasses.replace(cfg, **variant)
    if case != "rigid_lid":
        label = f"{label} {case}"
        st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))   # the tide is on
    if case == "coastal_wetdry" and not bool((st.h < cfg.h_dry).logical_and(
            grid.mask > 0).any()):
        raise AssertionError(f"{label}: no dry cell in the state")
    if cfg.obc and not bool((forcing.obc_v != 0).any()):
        raise AssertionError(f"{label}: no open face in the state")
    statics = (grid, forcing)
    rng = np.random.default_rng(seed + 100)
    p = torch.tensor((0.1 * rng.standard_normal((cfg.ny, cfg.nx))).astype(
        cfg.npdtype), device=device) * grid.mask
    exact = lambda r: 0.0      # noqa: E731
    ph = fp.Phases(grid, forcing, cfg)
    single = fp.Phases(grid, forcing, cfg,
                       phase_plan=fp.PhasePlan(None, None, False))
    print(f"   {label} {cfg.scheme} plan: {ph.plan.describe()}")
    worst_a = worst_b = 0.0
    for n in (0, 1):
        a_ref = fp.proj_a_plain(st.h, st.u, st.v, statics, n, cfg)
        b_ref = fp.proj_b_plain(st.h, a_ref[0], a_ref[1], p, statics, st.t,
                                cfg)
        for tag, phs in (("", ph), (" single-step", single)):
            a = phs.a(st.h, st.u, st.v, n)
            b = phs.b(st.h, a_ref[0], a_ref[1], p, st.t)
            torch.cuda.synchronize()
            err_a = compare_fields(f"{label} {cfg.scheme} n={n} K3a{tag}",
                                   ("u*", "v*", "div"), a, a_ref, tol)
            err_b = compare_fields(f"{label} {cfg.scheme} n={n} K3b{tag}",
                                   ("h1", "u1", "v1"), b, b_ref, tol)
            compare_fields(f"{label} n={n} bit for bit", ("u*", "v*", "div",
                                                          "h1", "u1", "v1"),
                           a + b, a_ref + b_ref, exact)
            if not tag:
                worst_a, worst_b = max(worst_a, err_a), max(worst_b, err_b)
        for carries in ((p, 0.5 * p), (p, None), (None, None)):
            out = ph.a_rhs(st.h, st.u, st.v, n, *carries)
            ref = a_ref[:2] + fp._rhs_plain(st.h, a_ref[2], grid, cfg,
                                            ph.lam, *carries)
            torch.cuda.synchronize()
            names = ("u*", "v*", "rhs", "x0")[:4 - (ref[3] is None)]
            if (out[3] is None) != (ref[3] is None):
                raise AssertionError(f"{label}: the epilogue's x0")
            compare_fields(f"{label} {cfg.scheme} n={n} K3a + rhs "
                           f"(carries {sum(c is not None for c in carries)})",
                           names, out, ref, exact)
    return worst_a, worst_b


def check_rb(label, device, tol, sum_rel, seed, wet_seams=False, **kw):
    """K4a against its plain version for k = 1, 2, 8, lam = 0 and
    1/(g dt^2): the sweeps forward and reverse, alone and with the
    multigrid residual (omega = 1), and the blocked solve's pass (k = 0,
    the test alone, too): x and r within tol (bit for bit is 0.0), the
    device's sum of r^2 within sum_rel of torch.sum's.  `wet_seams`: every
    cell wet and the face depths of the case's depth made positive, so at
    an odd size the periodic seams join wet cells of one colour.  Returns
    the largest difference."""
    import numpy as np
    import torch

    from beom_tpu_torch.core import ops
    from beom_tpu_torch.solvers import elliptic
    from beom_tpu_torch.stencils import redblack

    cfg, grid, _, _ = perturbed_case(device, seed, "rigid_lid", **kw)
    Hu, Hv = elliptic.face_depths(grid)
    mask = grid.mask
    if wet_seams:
        H = torch.clamp_min(grid.H, 100.0)
        Hu, Hv, mask = ops.a_xp(H), ops.a_yp(H), torch.ones_like(H)
    args = (Hu.contiguous(), Hv.contiguous(), mask, cfg.dx, cfg.dy)
    rng = np.random.default_rng(seed)

    def field(amp):
        a = amp * rng.standard_normal((cfg.ny, cfg.nx))
        return torch.tensor(a.astype(cfg.npdtype), device=device) * mask

    x, b = field(1.0), field(1e-6)
    worst = 0.0
    for lam in (0.0, 1.0 / (cfg.g * cfg.dt ** 2)):
        for k in (1, 2, 8):
            for reverse in (False, True):
                for residual, omega in ((False, cfg.sor_omega), (True, 1.0)):
                    kw_s = dict(lam=lam, k=k, omega=omega, reverse=reverse,
                                residual=residual)
                    out = redblack.rb_sweep(x, b, *args, **kw_s)
                    torch.cuda.synchronize()
                    ref = redblack.rb_sweep_plain(x, b, *args, **kw_s)
                    worst = max(worst, compare_fields(
                        f"{label} lam={lam:.4g} k={k} "
                        f"{'reverse' if reverse else 'forward'} K4a"
                        + (" + residual" if residual else ""),
                        ("x", "r") if residual else ("x",),
                        out if residual else [out],
                        ref if residual else [ref], tol))
        for k in (0, 1, 2, 8):
            kw_s = dict(lam=lam, k=k, omega=cfg.sor_omega)
            out, r, s = redblack.rb_pass(x, b, *args, **kw_s)
            torch.cuda.synchronize()
            ref, r_ref, s_ref = redblack.rb_pass_plain(x, b, *args, **kw_s)
            tag = f"{label} lam={lam:.4g} k={k} K4a solve pass"
            worst = max(worst, compare_fields(tag, ("x", "r"), [out, r],
                                              [ref, r_ref], tol))
            s, s_ref = float(s), float(s_ref)
            print(f"   {tag}: sum r^2 {s!r}, torch.sum {s_ref!r}, relative "
                  f"{abs(s - s_ref) / s_ref!r} (bound {sum_rel!r})")
            if not abs(s - s_ref) <= sum_rel * s_ref:
                raise AssertionError(f"{tag}: sum r^2 off torch.sum")
    return worst


def check_cg(label, device, x_rel, seed, precond="jacobi", case="rigid_lid",
             wet=False, **kw):
    """K6 against the plain CG on the two solves of a projection step
    from a perturbed state of `case`, cold and warm (from the cold
    solution).  `wet`: the solves on a grid wet everywhere (the case's
    depth, at least 100 m), so at an odd size the periodic seams join wet
    cells inside the operator.  x_rel(lam) bounds |x - x_plain| / scale.
    The true residual is recomputed in f64 with the plain laplacian_H; it
    is held to 20 tol_eff |b|, or to twice the plain CG's own where the
    plain CG itself stops above that (f32 recurrences drift from the true
    residual over thousands of iterations).  The iteration counts must
    agree within 1; with precond='mg' the warm start takes at most 1
    iteration.  Returns the largest difference."""
    import numpy as np
    import torch

    from beom_tpu_torch.core.grid import Grid, make_grid
    from beom_tpu_torch.solvers import elliptic
    from beom_tpu_torch.stencils import cg_fused
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import projection

    cfg, grid, forcing, st = perturbed_case(
        device, seed, case, solver_maxiter=20000, **kw)
    _, _, div = fp.proj_a_plain(st.h, st.u, st.v, (grid, forcing), 0, cfg)
    if wet:
        grid = make_grid(cfg, np.maximum(grid.H.cpu().numpy(), 100.0),
                         np.ones((cfg.ny, cfg.nx)), device=device)
    lam_h = 1.0 / (cfg.g * cfg.dt ** 2)
    problems = [(0.0, projection.rigid_rhs(st.h, div, grid, cfg)),
                (lam_h, projection.implicit_rhs(st.h, div, grid, cfg,
                                                lam_h)[0])]
    g64 = Grid(**{f: getattr(grid, f).double()
                  for f in ("H", "mask", "mask_u", "mask_v", "mask_q",
                            "f_q")})
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    Hu64, Hv64 = elliptic.face_depths(g64)
    m64 = g64.mask
    tol_eff = max(cfg.solver_tol, 30.0 * float(torch.finfo(cfg.tdtype).eps))

    def true_res(x, b64, lam):
        r = (b64 - elliptic.laplacian_H(x.double(), Hu64, Hv64, g64, cfg64,
                                        lam=lam)) * m64
        return float(r.norm())

    worst = 0.0
    for lam, b in problems:
        b64 = b.double() * m64
        if lam == 0.0:      # the compatible system the solve deflates to
            b64 = (b64 - m64 * (b64.sum() / m64.sum())) * m64
        solve = cg_fused.make_cg_solve(grid, cfg, lam=lam, precond=precond)
        x0 = None
        for start in ("cold", "warm"):
            res = solve(b, x0)
            again = solve(b, x0)
            ref = cg_fused.cg_solve_plain(b, grid, cfg, x0=x0, lam=lam,
                                          precond=precond)
            tag = f"{label} lam={lam:.4g} {start} K6 {precond}"
            if not torch.equal(res.x, again.x):
                raise AssertionError(f"{tag}: two launches differ")
            rk, rp = true_res(res.x, b64, lam), true_res(ref.x, b64, lam)
            bn = float(b64.norm())
            bound = max(20.0 * tol_eff * bn, 2.0 * rp)
            err = float((res.x - ref.x).abs().max())
            scale = float(ref.x.abs().max())
            print(f"   {tag}: iterations {res.iters} (plain {ref.iters}); "
                  f"true residual {rk / bn!r} |b| (plain {rp / bn!r}, "
                  f"bound {bound / bn!r}); max|x - plain| {err!r} = "
                  f"{err / scale!r} x scale (bound {x_rel(lam)!r}); "
                  "two launches bitwise equal")
            if not rk <= bound:
                raise AssertionError(f"{tag}: residual {rk!r} > {bound!r}")
            if not err <= x_rel(lam) * scale:
                raise AssertionError(f"{tag}: x off the plain CG")
            if abs(res.iters - ref.iters) > 1:
                raise AssertionError(f"{tag}: iterations off the plain CG")
            if start == "cold":
                cold_iters = res.iters
            elif precond == "mg" and res.iters > 1:
                raise AssertionError(f"{tag}: the warm start took "
                                     f"{res.iters} iterations")
            elif not (res.iters < cold_iters or res.iters == 0):
                raise AssertionError(f"{tag}: the warm start did not cut "
                                     "the iterations")
            worst = max(worst, err)
            x0 = res.x
    return worst


def run_projection(label, device, n_steps, diag_every, name="rigid_lid",
                   **kw):
    """run() on a 2048^2 f32 case (default: the rigid-lid gyre) with
    backend='fused', with every kernel count set to 0 just before and read
    just after.  Returns (case, final state, counts, wall seconds)."""
    import numpy as np
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import run
    from beom_tpu_torch.solvers import elliptic, multigrid
    from beom_tpu_torch.stencils import cg_fused, mg_coarse, redblack
    from beom_tpu_torch.stencils import fused_projection as fp

    case = make_case(name, nx=BIG, ny=BIG, device=device,
                     backend="fused", diag_every=diag_every, **kw)
    cfg, grid, forcing, st = case
    log = io.StringIO()
    # the eager operator, counted: the fused paths call it in no pass
    laplacian, calls = elliptic.laplacian, []

    def counted(*a, **k):
        calls.append(1)
        return laplacian(*a, **k)

    torch.cuda.synchronize()
    fp.LAUNCHES.update(proj_a=0, proj_b=0)
    fp.COUNTS["stalled"] = 0
    cg_fused.LAUNCHES = redblack.LAUNCHES = redblack.PASSES = 0
    redblack.IDLE = redblack.SOLVES = redblack.READS = 0
    redblack.APPLY_LAUNCHES = mg_coarse.LAUNCHES = multigrid.CYCLES = 0
    elliptic.laplacian = counted
    try:
        t0 = time.perf_counter()
        out = run(cfg, grid, forcing, st, n_steps, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        elliptic.laplacian = laplacian
    counts = dict(fp.LAUNCHES, cg_fused=cg_fused.LAUNCHES,
                  rb_sweep=redblack.LAUNCHES, passes=redblack.PASSES,
                  idle=redblack.IDLE, solves=redblack.SOLVES,
                  reads=redblack.READS, laplacian=len(calls),
                  apply_op=redblack.APPLY_LAUNCHES,
                  mg_coarse=mg_coarse.LAUNCHES, cycles=multigrid.CYCLES,
                  stalled=fp.COUNTS["stalled"])
    diags = [json.loads(x) for x in log.getvalue().splitlines()]
    for d in diags:
        print("   " + json.dumps(d))
    steps = list(range(diag_every, n_steps + 1, diag_every))
    if [d["n"] for d in diags] != steps:
        raise AssertionError(f"{label}: diagnostics missing")
    if not all(d["finite"] == 1.0 and all(np.isfinite(list(
            v for k, v in d.items() if k != "kind"))) for d in diags):
        raise AssertionError(f"{label}: non-finite diagnostics")
    if not diags[-1]["max_speed"] > 0:
        raise AssertionError(f"{label}: max_speed is 0: the run did nothing")
    if out.h.shape != (cfg.nz, BIG, BIG) or out.n != n_steps \
            or out.phi is None or not bool(torch.isfinite(out.h).all()):
        raise AssertionError(f"{label}: wrong final state")
    column = float(((out.h.sum(0) - grid.H) * grid.mask).abs().max())
    print(f"   {label}: launches {counts}; max|sum h - H| {column!r} m; "
          f"{n_steps} steps in {wall:.3f} s wall (first run, diagnostics "
          "included)")
    return case, out, counts, column


def solve_against_plain_loop(label, device, case):
    """The blocked solve of the rigid lid's first step from a perturbed
    state against the plain per-pass loop (rb_solve_plain) on the same
    right-hand side: the same pass count and x bit for bit, or, where the
    counts differ, both loops' sum of r^2 beside the threshold at the pass
    where they part (the device sums in another order than torch.sum)."""
    import torch

    from beom_tpu_torch.solvers import elliptic
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stencils import redblack
    from beom_tpu_torch.stepping import projection

    cfg, grid, forcing, _ = case
    _, _, _, st = perturbed_case(device, 3, "rigid_lid", nx=BIG, ny=BIG)
    _, _, div = fp.proj_a_plain(st.h, st.u, st.v, (grid, forcing), 0, cfg)
    b = projection.rigid_rhs(st.h, div, grid, cfg)
    kw = dict(k=fp.K_SWEEPS, max_passes=max(1, cfg.solver_maxiter
                                             // fp.K_SWEEPS))
    passes, reads = redblack.PASSES, redblack.READS
    x = redblack.make_fused_rb_solve(grid, cfg, **kw)(b)
    torch.cuda.synchronize()
    n, reads = redblack.PASSES - passes, redblack.READS - reads
    ref, n_ref = redblack.rb_solve_plain(b, grid, cfg, **kw)
    print(f"   {label} solve from a perturbed state: {n} passes in "
          f"{reads} host reads, plain loop {n_ref} passes (limit "
          f"{kw['max_passes']})")
    if n == n_ref:
        if not torch.equal(x, ref):
            raise AssertionError(f"{label}: x off the plain loop's")
        return
    # where the counts part, the two sums of the earlier stop
    tol, Hu, Hv = redblack._solve_setup(grid, cfg, None)
    mask = grid.mask
    bm = b * mask
    thr = redblack._threshold(bm, tol)
    x_at, _ = redblack.rb_solve_plain(b, grid, cfg, k=kw["k"],
                                      max_passes=min(n, n_ref))
    _, _, s_dev = redblack.rb_pass(x_at, bm, Hu, Hv, mask, cfg.dx, cfg.dy,
                                   k=0)
    r = (bm - elliptic.laplacian_H(x_at, Hu, Hv, grid, cfg)) * mask
    s_torch = float(torch.sum(r * r))
    print(f"   {label}: after {min(n, n_ref)} passes sum r^2 {float(s_dev)!r}"
          f" on the device, {s_torch!r} by torch.sum, threshold "
          f"{float(thr)!r}")
    if not (abs(n - n_ref) == 1
            and abs(float(s_dev) - s_torch) <= 1e-5 * float(thr)
            and abs(s_torch - float(thr)) <= 1e-5 * float(thr)):
        raise AssertionError(f"{label}: pass count off the plain loop's "
                             "away from the threshold")


def rb_solve_pass(b, args, k, omega):
    """pass(x) -> x: one working pass of the blocked solve's kernel on its
    own state, as the solve launches it."""
    import torch

    from beom_tpu_torch.stencils import redblack

    st = redblack.SolveState(b, k)
    thr = torch.zeros((), dtype=b.dtype, device=b.device)

    def run_pass(x):
        return redblack.solve_pass(x, b, *args, st, thr, k=k, omega=omega,
                                   first=True, max_passes=1)
    return run_pass


def versus_eager(label, case, n_steps, atol_ulp):
    """n_steps of the fused stepper against n_steps of the eager one,
    within tests/unit/test_pallas.py's envelope atol_ulp x max(scale, 1).
    Returns the eager ms/step."""
    import torch

    from beom_tpu_torch.stepping import make_stepper, prepare_state

    cfg, grid, forcing, st = case
    st = prepare_state(st, cfg)
    fused = make_stepper(grid, forcing, cfg)
    eager = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="eager"))
    a = b = st
    for _ in range(n_steps):
        a = fused(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        b = eager(b)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / n_steps * 1e3
    for f in "huv":
        x, y = getattr(a, f), getattr(b, f)
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        print(f"   {label} vs {n_steps} eager steps, {f}: max|diff| {err!r} "
              f"= {err / max(scale, 1e-30)!r} x scale (scale {scale!r}, "
              f"bound {atol_ulp!r} x max(scale, 1))")
        if not err <= atol_ulp * max(scale, 1.0):
            raise AssertionError(f"{label} {f} off the eager path")
    return eager_ms


def time_pair(label, plain, kernel, n_plain, n_kernel, unit="call",
              warm_plain=True):
    """Times in the order plain, kernel, kernel, plain; returns the means
    (kernel ms, plain ms).  warm_plain=False times a plain version that
    takes seconds per call without a call before the timed ones."""
    runs = []
    for which in ("plain", "kernel", "kernel", "plain"):
        fn, n = (plain, n_plain) if which == "plain" else (kernel, n_kernel)
        runs.append((which, time_ms(fn, n, which != "plain" or warm_plain)))
    for which, ms in runs:
        print(f"   {label} {which}: {ms!r} ms/{unit}")
    k = [ms for w, ms in runs if w == "kernel"]
    p = [ms for w, ms in runs if w == "plain"]
    return sum(k) / len(k), sum(p) / len(p)


def time_ms(fn, n_iter, warm=True):
    """Mean ms per call over n_iter calls, with CUDA events, after one
    call that is not timed (unless warm is false)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def main() -> dict:
    if not (ROOT / "beom_tpu_torch" / "csrc" / "fb_step.cu").is_file():
        raise SystemExit(f"beom_tpu_torch is not beside {__file__}")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import build, fused_fb
    from beom_tpu_torch.stepping import make_stepper

    phase("2 build")
    t0 = time.perf_counter()
    from beom_tpu_torch.cases import make_case
    specs = {fused_fb.build_spec(make_case(
        name, nx=16, ny=16, device="cpu", dtype=dtype, **kw)[0])
        for name, kw in [(n, k) for n, k, _ in PATHS]
        + [("double_gyre", {})]
        + [(n, dict(scheme="split", nsub=k)) for n, k in AGREE_SPLIT]
        for dtype in ("float32", "float64")}
    for dtype in ("float32", "float64"):
        for name, scheme in [p[:2] for p in PROJECTION_PATHS] \
                + [("rigid_lid", "rigid_lid")]:
            specs.add(projection_spec(make_case(
                name, nx=16, ny=16, device="cpu", dtype=dtype,
                scheme=scheme)[0]))
    specs |= scheme_mesh_specs()
    specs |= fb_pass_specs()
    specs |= shard_step_specs()
    specs |= module_specs()
    specs |= card_specs()
    specs |= layers_specs()
    todo = [k for k in KERNELS if k not in ("fb_step", "projection")] \
        + sorted(specs)
    # 16 nvcc processes at a time keep the host's memory in bounds
    for i in range(0, len(todo), 16):
        build.build_all(todo[i:i + 16])
    for item in todo:
        build.load(item)
    print(f"   {', '.join(KERNELS)}, split_step and shard_step "
          f"({len(todo)} libraries) built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    gyre = make_case("double_gyre", nx=16, ny=16, device="cpu",
                     steps_per_pass=4)[0]
    for kb in sorted({1, 4} | set(fused_fb.plan(gyre).launches(4))):
        print_build(build, build.label(fused_fb.build_spec(
            gyre, torch.float32, kb)))

    phase("3 K1 against its plain version")
    compare("256^2 f64 x20", dev, 20, rel(1e-12), nx=256, ny=256,
            dtype="float64")
    compare("256^2 f32 x1", dev, 1, ulps(4), nx=256, ny=256)
    compare("256^2 f32 x100", dev, 100, rel(1e-5), nx=256, ny=256)
    max_err = compare(f"{BIG}^2 f32 x1", dev, 1, ulps(4), nx=BIG, ny=BIG)
    compare(f"{BIG}^2 f32 x100", dev, 100, rel(1e-5), nx=BIG, ny=BIG)
    compare("200x136 f64 x20", dev, 20, rel(1e-12), nx=200, ny=136,
            dtype="float64")
    compare("200x136 f64 linear no-slip x20", dev, 20, rel(1e-12), nx=200,
            ny=136, dtype="float64", adv_scheme="linear", slip="no")
    for label, kw in (("256^2 f32", dict(nx=256, ny=256)),
                      (f"{BIG}^2 f32", dict(nx=BIG, ny=BIG)),
                      ("256^2 f64", dict(nx=256, ny=256, dtype="float64"))):
        pass_vs_singles(label, dev, 5, "double_gyre", (4,), **kw)

    cfg, grid, forcing, st = perturbed_case(dev, 1, nx=256, ny=256)
    four = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused", steps_per_pass=4))(st)
    one = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused"))
    single = st
    for _ in range(4):
        single = one(single)
    for f in "huv":
        if not torch.equal(getattr(four, f), getattr(single, f)):
            raise AssertionError(f"steps_per_pass=4 != 4 steps in {f}")
    print("   steps_per_pass=4 is bitwise equal to 4 single steps")

    phase(f"4 main path: run() on the {BIG}^2 f32 double gyre")
    from beom_tpu_torch.diag import diagnostics

    cfg, grid, forcing, st = make_case(
        "double_gyre", nx=BIG, ny=BIG, device=dev, backend="fused",
        steps_per_pass=4, diag_every=100)
    n_steps = 400
    log = io.StringIO()
    main_plan = fused_fb.plan(cfg, torch.float32)
    per_pass = main_plan.launches(cfg.steps_per_pass)
    print(f"   plan: {main_plan.describe()}; launches per pass of "
          f"{cfg.steps_per_pass} steps: {per_pass}")
    torch.cuda.synchronize()
    fused_fb.LAUNCHES = fused_fb.PASS_LAUNCHES = 0
    t0 = time.perf_counter()
    out = run(cfg, grid, forcing, st, n_steps, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, pass_launches = fused_fb.LAUNCHES, fused_fb.PASS_LAUNCHES
    diags = [json.loads(x) for x in log.getvalue().splitlines()]
    for d in diags:
        print("   " + json.dumps(d))
    want = n_steps // cfg.steps_per_pass * len(per_pass)
    want_pass = n_steps // cfg.steps_per_pass * sum(m > 1 for m in per_pass)
    if (launches, pass_launches) != (want, want_pass) or not want_pass:
        raise AssertionError(
            f"K1 launched {launches} times ({pass_launches} of the pass "
            f"kernel) in {n_steps} steps of the main path, not {want} "
            f"({want_pass})")
    if [d["n"] for d in diags] != [100, 200, 300, 400]:
        raise AssertionError("diagnostics missing")
    if not all(d["finite"] == 1.0 and all(np.isfinite(list(
            v for k, v in d.items() if k != "kind"))) for d in diags):
        raise AssertionError("non-finite diagnostics")
    if not diags[-1]["max_speed"] > 0:
        raise AssertionError("max_speed is 0: the run did nothing")
    if out.h.shape != (1, BIG, BIG) or out.n != n_steps:
        raise AssertionError("wrong final state")
    mass0 = diagnostics(st, grid, cfg)["mass"]
    drift = (diags[-1]["mass"] - mass0) / mass0
    sum0 = float(st.h.double().sum())
    drift64 = (float(out.h.double().sum()) - sum0) / sum0
    print(f"   K1 launches {launches} ({pass_launches} of the pass kernel, "
          f"{len(per_pass)} per pass of {cfg.steps_per_pass} steps); "
          f"relative mass drift {drift!r} (diagnostic), {drift64!r} (f64 sum "
          f"of h); {n_steps} steps in {wall:.3f} s wall (first run, "
          "diagnostics included)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / n_steps * 1e3
    print(f"   main path, second run: {ms_step!r} ms/step, "
          f"{BIG * BIG / ms_step * 1e3!r} grid-points/s (diagnostics every "
          f"100 steps included; {smi})")
    eager = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="eager", steps_per_pass=1))
    ref = st
    for _ in range(n_steps):
        ref = eager(ref)
    for f in "huv":
        a, b = getattr(out, f), getattr(ref, f)
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        print(f"   main path vs {n_steps} eager steps, {f}: max|diff| "
              f"{err!r} (scale {scale!r})")
        if not err <= 1e-5 * scale:
            raise AssertionError(f"main path {f} off the eager run")

    phase(f"5 times at {BIG}^2 f32")
    cfg, grid, forcing, st = perturbed_case(dev, 2, nx=BIG, ny=BIG)
    kernels = [fb_times("double_gyre", cfg, (grid, forcing), st, smi,
                        (None, pass_launches), max_err)["pass"]]
    kernels += projection_phases(dev, smi, rel, ulps)
    kernels += multigrid_phases(dev, smi, rel, ulps)
    kernels += case_phases(dev, smi, rel, ulps, max_err)
    kernels += projection_case_phases(dev, smi, rel, ulps)
    kernels += mesh_phases(dev, smi, rel, ulps)
    kernels += scheme_mesh_phases(dev, smi, rel, ulps)
    modules_phase(dev, smi)
    cards_phase(dev, smi)
    kernels += layers_phase(dev, smi)
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    if idle:
        raise AssertionError(f"kernels not launched on their paths: {idle}")
    return {"kernels": kernels}


def projection_phases(dev, smi, rel, ulps):
    """Phases 6 to 9; returns the kernels' JSON entries."""
    import torch

    from beom_tpu_torch.run import run
    from beom_tpu_torch.solvers import elliptic
    from beom_tpu_torch.stencils import build, cg_fused, redblack
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import projection

    phase("6 build: the projection kernels")
    from beom_tpu_torch.cases import make_case
    print_build(build, build.label(fp.build_spec(make_case(
        "rigid_lid", nx=16, ny=16, device="cpu")[0])))
    for name in ("rb_sweep", "cg_jacobi"):
        print_build(build, name)

    phase("7 the projection kernels against their plain versions")
    err = {}
    check_phases("256^2 f64", dev, rel(1e-12), 20, nx=256, ny=256,
                 dtype="float64")
    check_phases("256^2 f32", dev, ulps(4), 21, nx=256, ny=256,
                 scheme="implicit_fs")
    err["proj_a"], err["proj_b"] = check_phases(
        f"{BIG}^2 f32", dev, ulps(4), 22, nx=BIG, ny=BIG)
    worst = check_phases(f"{BIG}^2 f32", dev, ulps(4), 23, nx=BIG, ny=BIG,
                         scheme="implicit_fs")
    err["proj_a"] = max(err["proj_a"], worst[0])
    err["proj_b"] = max(err["proj_b"], worst[1])
    check_phases("200x136 f64", dev, rel(1e-12), 24, nx=200, ny=136,
                 dtype="float64", scheme="implicit_fs")
    check_phases("200x136 f64 linear no-slip", dev, rel(1e-12), 25, nx=200,
                 ny=136, dtype="float64", adv_scheme="linear", slip="no")
    # K4a bit for bit; sum r^2 against torch.sum: another order of the
    # same terms, 1e-12 relative at f64, 1e-5 at f32 (the device sums in
    # f64)
    exact = lambda r: 0.0      # noqa: E731
    check_rb("256^2 f64", dev, exact, 1e-12, 26, nx=256, ny=256,
             dtype="float64")
    check_rb("200x136 f64", dev, exact, 1e-12, 41, nx=200, ny=136,
             dtype="float64")
    check_rb("201x137 f64 wet seams", dev, exact, 1e-12, 42, True, nx=201,
             ny=137, dtype="float64")
    err["rb_sweep"] = check_rb(f"{BIG}^2 f32", dev, exact, 1e-5, 27,
                               nx=BIG, ny=BIG)
    check_cg("256^2 f64", dev, lambda lam: 1e-6, 28, nx=256, ny=256,
             dtype="float64")
    check_cg("201x137 f64 wet seams", dev, lambda lam: 1e-6, 43, wet=True,
             nx=201, ny=137, dtype="float64")
    check_cg("200x136 f64 coastal_wetdry", dev, lambda lam: 1e-6, 44,
             case="coastal_wetdry", nx=200, ny=136, dtype="float64")
    # f32 bounds (PERF.md): 1e-3 x scale for the lam = 0 solve,
    # 1e-4 x scale for the Helmholtz one
    err["cg_fused"] = check_cg(f"{BIG}^2 f32", dev,
                               lambda lam: 1e-3 if lam == 0.0 else 1e-4,
                               29, nx=BIG, ny=BIG)

    phase(f"8 the projection path: run() on the {BIG}^2 f32 rigid-lid gyre")
    case_a, _, counts_a, col_a = run_projection(
        "(a) implicit_fs, CG + Jacobi", dev, 20, 10, scheme="implicit_fs")
    if not (counts_a["proj_a"] == counts_a["proj_b"] == counts_a["cg_fused"]
            == 20 and counts_a["rb_sweep"] == 0):
        raise AssertionError(f"(a) launch counts {counts_a}")
    if not col_a < 1.0:          # the free surface: wind set-up, mm to cm
        raise AssertionError(f"(a) max|sum h - H| {col_a!r} m")
    eager_a = versus_eager("(a) 3 fused steps", case_a, 3, 1e-5)
    case_b, _, counts_b, col_b = run_projection(
        "(b) rigid_lid, red-black", dev, 10, 5, solver="redblack",
        solver_maxiter=RB_MAXITER)
    # one K4a launch per pass that did work, per pass launched after the
    # test stopped a solve, and per solve (its test of the initial x); no
    # eager operator
    if not (counts_b["proj_a"] == counts_b["proj_b"] == counts_b["solves"]
            == 10 and counts_b["passes"] > 0
            and counts_b["rb_sweep"] == counts_b["passes"]
            + counts_b["idle"] + counts_b["solves"]
            and counts_b["laplacian"] == 0 and counts_b["cg_fused"] == 0):
        raise AssertionError(f"(b) launch counts {counts_b}")
    if not col_b < 0.1:          # the rigid lid holds sum h = H
        raise AssertionError(f"(b) max|sum h - H| {col_b!r} m")
    eager_b = versus_eager("(b) 3 fused steps", case_b, 3, 1e-4)
    solve_against_plain_loop("(b)", dev, case_b)

    phase(f"9 times at {BIG}^2 f32 ({smi})")
    cfg, grid, forcing, st = perturbed_case(dev, 2, "rigid_lid", nx=BIG,
                                            ny=BIG, scheme="implicit_fs")
    statics = (grid, forcing)
    saved = (dict(fp.LAUNCHES), cg_fused.LAUNCHES, redblack.LAUNCHES)
    ms = {}
    ph = fp.Phases(grid, forcing, cfg)
    single = fp.Phases(grid, forcing, cfg,
                       phase_plan=fp.PhasePlan(None, None, False))
    print(f"   plan of the f32 gyre: {ph.plan.describe()}")
    u_s, v_s, div = ph.a(st.h, st.u, st.v, 0)
    ms["proj_a"] = time_pair(
        "K3a", lambda: fp.proj_a_plain(st.h, st.u, st.v, statics, 0, cfg),
        lambda: ph.a(st.h, st.u, st.v, 0), 10, 100)
    lam = projection.solve_lam(cfg)
    b, eta_n = projection.implicit_rhs(st.h, div, grid, cfg, lam)
    solve = cg_fused.make_cg_solve(grid, cfg, lam=lam)
    p = solve(b, eta_n).x
    ms["proj_b"] = time_pair(
        "K3b", lambda: fp.proj_b_plain(st.h, u_s, v_s, p, statics, st.t,
                                       cfg),
        lambda: ph.b(st.h, u_s, v_s, p, st.t), 10, 100)
    keys = ph.kernel_keys()
    dev_ms = device_ms(
        "K3a / K3b on the gyre",
        lambda: (ph.a(st.h, st.u, st.v, 0), ph.b(st.h, u_s, v_s, p, st.t)),
        50, dict.fromkeys(keys, 1))
    dev_ms = {"proj_a": dev_ms[keys[0]], "proj_b": dev_ms[keys[1]]}
    print("   K3a with the right-hand side and warm start in its epilogue "
          "(the step's phase A): "
          f"{time_ms(lambda: ph.a_rhs(st.h, st.u, st.v, 0, p, eta_n), 100)!r}"
          " ms between events")
    single_ms = device_ms(
        "the single-step K3a / K3b", lambda: (
            single.a(st.h, st.u, st.v, 0),
            single.b(st.h, u_s, v_s, p, st.t)), 50,
        {"proj_a_kernel": 1, "proj_b_kernel": 1})
    print(f"   K3a / K3b on the device: {dev_ms['proj_a']!r} / "
          f"{dev_ms['proj_b']!r} ms by the plan, {single_ms['proj_a_kernel']!r}"
          f" / {single_ms['proj_b_kernel']!r} the single-step kernels")
    host = {"Phases.a": host_us(lambda: ph.a(st.h, st.u, st.v, 0)),
            "Phases.a_rhs": host_us(lambda: ph.a_rhs(st.h, st.u, st.v, 0, p,
                                                     eta_n)),
            "Phases.b": host_us(lambda: ph.b(st.h, u_s, v_s, p, st.t))}
    print("   host us per launch (200 calls without a wait): " + ", ".join(
        f"{k} {v:.1f}" for k, v in host.items()))
    Hu, Hv = elliptic.face_depths(grid)
    rb_args = (Hu.contiguous(), Hv.contiguous(), grid.mask, cfg.dx, cfg.dy)
    rhs = projection.rigid_rhs(st.h, div, grid, cfg) * grid.mask
    kw = dict(k=8, omega=cfg.sor_omega)
    time_pair("K4a sweep pass (8 sweeps)",
              lambda: redblack.rb_sweep_plain(p, rhs, *rb_args, **kw),
              lambda: redblack.rb_sweep(p, rhs, *rb_args, **kw), 5, 50,
              unit="pass")
    solve_pass = rb_solve_pass(rhs, rb_args, **kw)
    ms["rb_sweep"] = time_pair(
        "K4a solve pass (8 sweeps, residual, sum)",
        lambda: redblack.rb_pass_plain(p, rhs, *rb_args, **kw),
        lambda: solve_pass(p), 5, 50, unit="pass")
    dev_ms["rb_sweep"] = device_ms(
        "K4a solve pass", lambda: solve_pass(p), 50,
        {"rb_pass_kernel": 1})["rb_pass_kernel"]
    res = solve(b, eta_n)
    ref = cg_fused.cg_solve_plain(b, grid, cfg, x0=eta_n, lam=lam)
    print(f"   K6 solve of an implicit-FS step from eta^n: {res.iters} "
          f"iterations (plain {ref.iters})")
    ms["cg_fused"] = time_pair(
        "K6 solve", lambda: cg_fused.cg_solve_plain(b, grid, cfg, x0=eta_n,
                                                    lam=lam),
        lambda: solve(b, eta_n), 3, 10, unit="solve")
    span, dev_ms["cg_fused"] = coop_times(
        "K6-Jacobi solve", lambda s: solve(b, eta_n, stamps=s),
        "cg_jacobi_kernel")
    print(f"   K6-Jacobi: {span / max(res.iters, 1) * 1e3!r} us/iteration "
          f"by its span; {JACOBI_FIELDS} fields streamed per iteration, "
          "1 grid sync")
    fp.LAUNCHES.update(saved[0])
    cg_fused.LAUNCHES, redblack.LAUNCHES = saved[1], saved[2]
    for label, (cfg, grid, forcing, st), n_steps, eager_ms in (
            ("(a) implicit_fs", case_a, 20, eager_a),
            ("(b) rigid_lid red-black", case_b, 10, eager_b)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
        print(f"   {label}: run() {wall!r} ms/step over {n_steps} steps "
              f"(diagnostics included); eager stepper {eager_ms!r} "
              "ms/step over 3 steps")
    cfg, grid, forcing, st = case_b
    busy_share("(b) rigid_lid red-black through run()",
               lambda: run(cfg, grid, forcing, st, 5, log=io.StringIO()), 5)
    # the step by part: 20 steps of (a), 10 of (b), their diagnostics as in
    # phase 8
    for label, (cfg, grid, forcing, st), n_steps, keys in (
            ("(a) implicit_fs", case_a, 20, ("cg_",)),
            ("(b) rigid_lid red-black", case_b, 10, ("rb_",))):
        step_parts(f"{label} by part, run() {n_steps} steps", lambda: run(
            cfg, grid, forcing, st, n_steps, log=io.StringIO()), n_steps,
            keys)

    # fields moved per point (the kernels' pointer operands, each once: K6
    # reads b, x0, Hu, Hv, pm = inv_diag mask and writes x) and a count of
    # operations per point: K3a one momentum evaluation and the
    # divergence, K3b the correction and the continuity, a K4a solve pass
    # 8 sweeps of ~12 and the residual and its square ~20, K6 ~30 per
    # iteration of this run's solve
    pts = cfg.nx * cfg.ny
    sources = {
        "proj_a": ("projection.cu", "band.py:200", phase_fields(cfg)[0],
                   150),
        "proj_b": ("projection.cu", "band.py:200", phase_fields(cfg)[1], 40),
        "rb_sweep": ("rb_sweep.cu", "redblack_pallas.py:39", 6,
                     8 * 12 + 20),
        "cg_fused": ("cg_jacobi.cu", "cg_vmem.py:61", 6, 30 * res.iters)}
    launches = {name: counts_a[name] + counts_b[name] for name in sources}
    entries = [kernel_entry(name, src, site, launches[name], err[name],
                            ms[name], fields * pts * 4, ops * pts,
                            device=dev_ms.get(name))
               for name, (src, site, fields, ops) in sources.items()]
    entries[-1].update(span_ms=span)
    return entries


def field_on(mask, rng, amp=1.0):
    """A seeded wet field on the card, shaped and typed as mask."""
    import torch

    a = amp * rng.standard_normal(tuple(mask.shape))
    return torch.tensor(a, dtype=mask.dtype, device=mask.device) * mask


def check_level_kernels(label, device, tol, seed, **kw):
    """K4a with its residual (k = 2, omega = 1, forward and reverse) and
    K4b (both modes) on the model grid against their plain versions,
    lam = 0 and 1/(g dt^2).  Returns the largest differences."""
    import numpy as np
    import torch

    from beom_tpu_torch.solvers import multigrid as mg
    from beom_tpu_torch.stencils import redblack

    cfg, grid, _, _ = perturbed_case(device, seed, "rigid_lid", **kw)
    rng = np.random.default_rng(seed)
    worst_r = worst_b = 0.0
    for lam in (0.0, 1.0 / (cfg.g * cfg.dt ** 2)):
        lv = mg.build_levels(grid, cfg, lam, min_size=max(cfg.nx, cfg.ny))[0]
        args = (lv.Hu, lv.Hv, lv.mask, lv.dx, lv.dy)
        x, b = field_on(lv.mask, rng), field_on(lv.mask, rng, 1e-6)
        for reverse in (False, True):
            kw_s = dict(lam=lam, k=2, omega=1.0, reverse=reverse,
                        residual=True)
            out = redblack.rb_sweep(x, b, *args, **kw_s)
            torch.cuda.synchronize()
            ref = redblack.rb_sweep_plain(x, b, *args, **kw_s)
            worst_r = max(worst_r, compare_fields(
                f"{label} lam={lam:.4g} {'reverse' if reverse else 'forward'}"
                " K4a+residual", ("x", "r"), out, ref, tol))
        for mode in ("residual", "matvec"):
            out = redblack.apply_op(x, b, *args, lam=lam, mode=mode)
            torch.cuda.synchronize()
            ref = redblack.apply_op_plain(x, b, *args, lam=lam, mode=mode)
            worst_b = max(worst_b, compare_fields(
                f"{label} lam={lam:.4g} K4b", (mode,), [out], [ref], tol))
    return worst_r, worst_b


def check_coarse(label, device, demean_rel, seed, **kw):
    """K5 on the tail of the hierarchy that the fused tier gives it (the
    first level <= 512^2 and below) against the eager cycle on that tail,
    lam = 0 and 1/(g dt^2), de-mean off and on: 0.0 without the de-mean
    (it is off, or lam > 0), demean_rel x scale with it; two launches
    bitwise equal.  Returns the largest difference."""
    import numpy as np
    import torch

    from beom_tpu_torch.solvers import multigrid as mg
    from beom_tpu_torch.stencils import mg_coarse

    cfg, grid, _, _ = perturbed_case(device, seed, "rigid_lid", **kw)
    rng = np.random.default_rng(seed)
    worst = 0.0
    for lam in (0.0, 1.0 / (cfg.g * cfg.dt ** 2)):
        levels = mg.build_levels(grid, cfg, lam)
        gamma = mg.fused_gamma_schedule(levels, 2)
        for demean in (False, True):
            j0, call = mg.make_fused_coarse(levels, lam, 2, 24, demean,
                                            gamma=gamma)
            tail = levels[j0:]
            g_tail = gamma[j0:] or 1 if isinstance(gamma, tuple) else gamma
            b = field_on(tail[0].mask, rng)
            out, again = call(b), call(b)
            torch.cuda.synchronize()
            ref = mg_coarse.coarse_stack_plain(tail, b, lam, 2, 24, g_tail,
                                               demean)
            tag = (f"{label} lam={lam:.4g} demean={demean} K5 on levels "
                   f"{j0}..{len(levels) - 1} {tuple(tail[0].mask.shape)}")
            if not torch.equal(out, again):
                raise AssertionError(f"{tag}: two launches differ")
            rel_bound = demean_rel if (demean and lam == 0.0) else 0.0
            worst = max(worst, compare_fields(
                tag, ("x",), [out], [ref],
                lambda r: rel_bound * float(r.abs().max())))
    return worst


def check_composed(label, device, tol, seed, **kw):
    """make_mg_precond(smoother='fused') (K4a on the levels >= 256 rows
    above the tail, K5 on the tail) against the eager cycle with the same
    gamma schedule.  Returns the difference."""
    import numpy as np
    import torch

    from beom_tpu_torch.solvers import multigrid as mg

    cfg, grid, _, _ = perturbed_case(device, seed, "rigid_lid", **kw)
    levels = mg.build_levels(grid, cfg, 0.0)
    gamma = mg.fused_gamma_schedule(levels, 2)
    fused = mg.make_mg_precond(grid, cfg, smoother="fused")
    eager = mg.cycle_precond(levels, 0.0, 2, 24, gamma)
    r = field_on(grid.mask, np.random.default_rng(seed))
    out = fused(r)
    torch.cuda.synchronize()
    return compare_fields(f"{label} composed fused preconditioner",
                          ("z",), [out], [eager(r)], tol)


def multigrid_phases(dev, smi, rel, ulps):
    """Phases 10 to 13; returns the kernels' JSON entries."""
    import torch

    from beom_tpu_torch.run import run
    from beom_tpu_torch.solvers import multigrid as mg
    from beom_tpu_torch.stencils import build, cg_fused, mg_coarse, redblack
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import projection

    phase("10 build: the multigrid kernels")
    for name in ("rb_sweep", "mg_coarse", "cg_fused"):
        print_build(build, name)

    phase("11 the multigrid kernels against their plain versions")
    err = {}
    check_level_kernels("256^2 f64", dev, rel(1e-12), 30, nx=256, ny=256,
                        dtype="float64")
    check_level_kernels("200x136 f64", dev, rel(1e-12), 31, nx=200, ny=136,
                        dtype="float64")
    err["rb_sweep_residual"], err["apply_op"] = check_level_kernels(
        f"{BIG}^2 f32", dev, ulps(4), 32, nx=BIG, ny=BIG)
    # de-mean bounds (PERF.md): 1e-12 x scale at f64, 1e-4 at f32
    check_coarse("256^2 f64", dev, 1e-12, 33, nx=256, ny=256,
                 dtype="float64")
    check_coarse("200x136 f64", dev, 1e-12, 34, nx=200, ny=136,
                 dtype="float64")
    err["mg_coarse"] = check_coarse(f"{BIG}^2 f32", dev, 1e-4, 35, nx=BIG,
                                    ny=BIG)
    check_cg("256^2 f64", dev, lambda lam: 1e-6, 36, precond="mg", nx=256,
             ny=256, dtype="float64")
    check_cg("200x136 f64", dev, lambda lam: 1e-6, 37, precond="mg", nx=200,
             ny=136, dtype="float64")
    # f32 bounds (PERF.md): 1e-3 x scale for lam = 0, 1e-4 for lam > 0
    err["cg_fused_mg"] = check_cg(f"{BIG}^2 f32", dev,
                                  lambda lam: 1e-3 if lam == 0.0 else 1e-4,
                                  38, precond="mg", nx=BIG, ny=BIG)
    check_composed("256^2 f64", dev, rel(1e-12), 39, nx=256, ny=256,
                   dtype="float64")
    check_composed(f"{BIG}^2 f32", dev, rel(1e-5), 40, nx=BIG, ny=BIG)

    phase(f"12 the multigrid paths: run() on the {BIG}^2 f32 rigid lid")
    case_c, _, counts_c, col_c = run_projection(
        "(c) rigid_lid, CG + multigrid (the default)", dev, 20, 10)
    if not (counts_c["proj_a"] == counts_c["proj_b"] == counts_c["cg_fused"]
            == 20 and counts_c["rb_sweep"] == counts_c["apply_op"]
            == counts_c["mg_coarse"] == 0):
        raise AssertionError(f"(c) launch counts {counts_c}")
    if not col_c < 0.1:
        raise AssertionError(f"(c) max|sum h - H| {col_c!r} m")
    eager_c = versus_eager("(c) 1 fused step", case_c, 1, 1e-5)
    case_d, _, counts_d, col_d = run_projection(
        "(d) rigid_lid, solver='mg'", dev, 10, 5, solver="mg")
    n_cyc = counts_d["cycles"]
    # per cycle: K4a forward + reverse on level 0 once and on level 1 in
    # both K-cycle visits; K5 twice per level-1 visit (gamma_1 = 2); K4b
    # once, plus once per solve for the initial residual
    if not (counts_d["proj_a"] == counts_d["proj_b"] == 10 and n_cyc > 0
            and counts_d["rb_sweep"] == 6 * n_cyc
            and counts_d["mg_coarse"] == 4 * n_cyc
            and counts_d["apply_op"] == n_cyc + 10
            and counts_d["cg_fused"] == 0):
        raise AssertionError(f"(d) launch counts {counts_d}")
    if not col_d < 0.1:
        raise AssertionError(f"(d) max|sum h - H| {col_d!r} m")
    eager_d = versus_eager("(d) 1 fused step", case_d, 1, 1e-4)

    phase(f"13 times at {BIG}^2 f32 ({smi})")
    cfg, grid, forcing, st = perturbed_case(dev, 2, "rigid_lid", nx=BIG,
                                            ny=BIG)
    saved = (dict(fp.LAUNCHES), cg_fused.LAUNCHES, redblack.LAUNCHES,
             redblack.APPLY_LAUNCHES, mg_coarse.LAUNCHES, mg.CYCLES)
    _, _, div = fp.proj_a(st.h, st.u, st.v, (grid, forcing), 0, cfg)
    rhs = projection.rigid_rhs(st.h, div, grid, cfg)
    levels = mg.build_levels(grid, cfg, 0.0)
    gamma = mg.fused_gamma_schedule(levels, 2)
    lv = levels[0]
    args = (lv.Hu, lv.Hv, lv.mask, lv.dx, lv.dy)
    x = torch.zeros_like(rhs)
    kw = dict(k=2, omega=1.0, residual=True)
    ms = {}
    ms["rb_sweep_residual"] = time_pair(
        "K4a pass (2 sweeps + residual)",
        lambda: redblack.rb_sweep_plain(x, rhs, *args, **kw),
        lambda: redblack.rb_sweep(x, rhs, *args, **kw), 10, 100,
        unit="pass")
    ms["apply_op"] = time_pair(
        "K4b residual", lambda: redblack.apply_op_plain(x, rhs, *args),
        lambda: redblack.apply_op(x, rhs, *args), 10, 100, unit="pass")
    j0, call = mg.make_fused_coarse(levels, 0.0, 2, 24, True, gamma=gamma)
    tail = levels[j0:]
    b_tail = rhs
    for coarser in levels[1:j0 + 1]:
        b_tail = mg._restrict2(b_tail) * coarser.mask
    ms["mg_coarse"] = time_pair(
        f"K5 on the {tuple(tail[0].mask.shape)} tail",
        lambda: mg_coarse.coarse_stack_plain(tail, b_tail, 0.0, 2, 24,
                                             gamma[j0:], True),
        lambda: call(b_tail), 3, 30, unit="visit")
    coop_times("K5 visit", lambda s: call(b_tail, stamps=s), "coarse_kernel")
    no_tier = mg_coarse.make_coarse_stack_call(tail, 0.0, gamma=gamma[j0:],
                                               demean=True, tier=len(tail))
    print(f"   K5 on the {tuple(tail[call.tier].mask.shape)} tier and "
          f"above; with every level on the whole grid (no tier): "
          f"{time_ms(lambda: no_tier(b_tail), 30)!r} ms/visit")
    solve = cg_fused.make_cg_solve(grid, cfg, lam=0.0)
    res = solve(rhs)
    ref = cg_fused.cg_solve_plain(rhs, grid, cfg, lam=0.0, precond="mg")
    ms["cg_fused_mg"] = time_pair(
        "K6-mg cold solve",
        lambda: cg_fused.cg_solve_plain(rhs, grid, cfg, lam=0.0,
                                        precond="mg"),
        lambda: solve(rhs), 1, 5, unit="solve", warm_plain=False)
    coop_times("K6-mg cold solve", lambda s: solve(rhs, stamps=s),
               "cg_kernel")
    k_ms, p_ms = ms["cg_fused_mg"]
    print(f"   K6-mg: {res.iters} iterations (plain {ref.iters}); "
          f"{k_ms / max(res.iters, 1)!r} ms/iteration (plain "
          f"{p_ms / max(ref.iters, 1)!r})")
    shapes = mg_coarse.level_shapes(levels)
    for tag, steps, before in (
            ("K6-mg cycle", solve.steps,
             walk_syncs_before(shapes, gamma, False)),
            ("K6-mg cycle without the tier",
             mg_coarse.cycle_steps(levels, 0.0, 2, 24, gamma, False), None),
            ("K5 visit", call.steps,
             walk_syncs_before(shapes[j0:], gamma[j0:], True)),
            ("K5 visit without the tier", no_tier.steps, None)):
        print(f"   {tag}: {len(steps)} steps, "
              f"{mg_coarse.grid_syncs(steps)} grid syncs"
              + ("" if before is None else
                 f" (the walk before the tier and the tiled passes: "
                 f"{before})"))
    for smoother in ("eager", "fused"):
        # the eager solve takes a minute to converge: one call of its first
        # three cycles, timed and counted
        eager = smoother == "eager"
        mg_solve = mg.make_mg_solver(grid, cfg, smoother=smoother,
                                     maxiter=3 if eager else None)
        if not eager:
            mg_solve(rhs)
        c0 = mg.CYCLES
        t = time_ms(lambda: mg_solve(rhs), 1 if eager else 3, warm=False)
        n_c = (mg.CYCLES - c0) // (1 if eager else 3)
        print(f"   solver='mg' cold solve, smoother={smoother}: {n_c} cycles, "
              f"{t!r} ms/solve, {t / max(n_c, 1)!r} ms/cycle")
    fp.LAUNCHES.update(saved[0])
    (cg_fused.LAUNCHES, redblack.LAUNCHES, redblack.APPLY_LAUNCHES,
     mg_coarse.LAUNCHES, mg.CYCLES) = saved[1:]
    for label, (cfg, grid, forcing, st), n_steps, eager_ms in (
            ("(c) rigid_lid CG + multigrid", case_c, 20, eager_c),
            ("(d) rigid_lid solver='mg'", case_d, 10, eager_d)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
        print(f"   {label}: run() {wall!r} ms/step over {n_steps} steps "
              f"(diagnostics included); eager stepper {eager_ms!r} "
              "ms/step over 2 steps")
    cfg, grid, forcing, st = case_d
    busy_share("(d) rigid_lid solver='mg' through run()",
               lambda: run(cfg, grid, forcing, st, 3, log=io.StringIO()), 3)

    # bytes: the operands of the call, each once (for the cycle kernels
    # the six level fields of every level they walk, b and x); operations:
    # ~12 per point and sweep, and the steps of this run's cycles
    pts = cfg.nx * cfg.ny
    tables = 6 * sum(lv.mask.numel() for lv in levels)
    tail_tables = 6 * sum(lv.mask.numel() for lv in tail)
    entries = {
        "rb_sweep_residual": ("rb_sweep.cu", "redblack_pallas.py:39",
                              counts_d["rb_sweep"], 7 * pts, 3 * 12 * pts),
        "apply_op": ("rb_sweep.cu", "redblack_pallas.py:217",
                     counts_d["apply_op"], 6 * pts, 12 * pts),
        "mg_coarse": ("mg_coarse.cu", "mg_pallas.py:55",
                      counts_d["mg_coarse"],
                      tail_tables + 2 * tail[0].mask.numel(),
                      cycle_ops(call.steps, tail)),
        "cg_fused_mg": ("cg_fused.cu", "cg_vmem.py:61",
                        counts_c["cg_fused"], tables + 3 * pts,
                        res.iters * (cycle_ops(solve.steps, levels)
                                     + 30 * pts))}
    return [kernel_entry(name, src, site, n, err[name], ms[name],
                         fields * 4, ops)
            for name, (src, site, n, fields, ops) in entries.items()]


def split_phases_compare(label, device, tol, seed, case, **kw):
    """K1s on one perturbed case: each of the three kernels against its
    eager phase from the same inputs, then the chained step over 3 steps
    against 3 eager split_steps.  Returns the largest differences by
    kernel."""
    import torch

    from beom_tpu_torch.core.state import State
    from beom_tpu_torch.stencils import fused_fb
    from beom_tpu_torch.stepping import fb, split

    cfg, grid, forcing, st = perturbed_case(device, seed, case,
                                            scheme="split", **kw)
    statics = (grid, forcing)
    tag = f"{label} {case} nsub={cfg.nsub}"
    sp_ref = split.slow_phase(st, grid, forcing, cfg)
    sp = fused_fb.split_slow(st.h, st.u, st.v, statics, cfg)
    torch.cuda.synchronize()
    worst = {"slow": compare_fields(f"{tag} slow", sp_ref._fields, sp,
                                    sp_ref, tol)}
    sub_ref = split.subcycle_phase(sp_ref, grid, cfg)
    sub = fused_fb.split_subcycle(sp_ref, st.h, st.u, st.v, statics, cfg)
    torch.cuda.synchronize()
    worst["subcycle"] = compare_fields(
        f"{tag} subcycle", ("eta_f", "ubar_f", "vbar_f", "ubar_avg",
                            "vbar_avg"), sub, sub_ref, tol)
    out = fused_fb.split_recompose(sp_ref, sub_ref, st.h, st.u, st.v,
                                   statics, st.t, cfg)
    torch.cuda.synchronize()
    h1, u1, v1 = split.recompose(sp_ref, *sub_ref, st.h, grid, cfg)
    ref = fb.finalize(h1, u1, v1, State(h=st.h, u=st.u, v=st.v, t=st.t, n=0),
                      grid, forcing, cfg)
    worst["recompose"] = compare_fields(f"{tag} recompose", "huv", out,
                                        (ref.h, ref.u, ref.v), tol)
    args = (st.h, st.u, st.v, statics, st.n, st.t, cfg, 3)
    out = fused_fb.fused_fb_step(*args)
    torch.cuda.synchronize()
    chained = compare_fields(f"{tag} 3 steps", "huv", out,
                             fused_fb.fused_fb_step_plain(*args), tol)
    return {k: max(v, chained) for k, v in worst.items()}


def split_two_compare(label, device, seed, case, **kw):
    """K1s's two-launch step on one perturbed case, bit for bit: the slow
    phase's tendencies against split.slow_tendencies, the tail from them
    against split.depth_means and split.fast_phase, and 3 steps of the two
    launches against 3 plain split steps and 3 steps of the three kernels.
    Returns the largest difference (0.0)."""
    import torch

    from beom_tpu_torch.stencils import fused_fb
    from beom_tpu_torch.stepping import split

    cfg, grid, forcing, st = perturbed_case(device, seed, case,
                                            scheme="split", **kw)
    statics = (grid, forcing)
    pl = fused_fb.split_plan(cfg)
    tag = f"{label} {case} nsub={cfg.nsub} route {pl.route} tail {pl.tail}"
    if not fused_fb.tail_geometries(cfg):
        print(f"   {tag}: no tail fits a CTA")
        return 0.0
    tend = fused_fb._launch_tend(st.h, st.u, st.v, statics, cfg)
    ref = split.slow_tendencies(st, grid, forcing, cfg)
    worst = agree(f"{tag} tendencies vs plain", tend, ref, None)
    t1 = st.t + cfg.npdtype.type(cfg.dt)
    out = fused_fb._launch_tail(ref, st.h, st.u, st.v, statics, t1, cfg)
    s = split.fast_phase(split.depth_means(st, *ref, grid, cfg), st, grid,
                         forcing, cfg)
    worst = max(worst, agree(f"{tag} tail vs plain", out, (s.h, s.u, s.v),
                             None))
    h, u, v, t = st.h, st.u, st.v, st.t
    three = (h, u, v)
    for _ in range(3):
        t1 = t + cfg.npdtype.type(cfg.dt)
        tend = fused_fb._launch_tend(h, u, v, statics, cfg)
        h, u, v = fused_fb._launch_tail(tend, h, u, v, statics, t1, cfg)
        slow = fused_fb._launch_slow(*three, statics, cfg)
        sub = fused_fb._launch_subcycle(slow, *three, statics, cfg)
        three = fused_fb._launch_recompose(slow, sub, *three, statics, t1,
                                           cfg)
        t = t1
    torch.cuda.synchronize()
    plain = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, statics, 0, st.t,
                                         cfg, 3)
    worst = max(worst, agree(f"{tag} 3 steps vs plain", (h, u, v), plain,
                             None))
    agree(f"{tag} 3 steps vs the three kernels", (h, u, v), three, None)
    return worst


def fb_case_compare(label, device, tol, seed, case, **kw):
    """K1 on one perturbed case: one step at each sweep parity and a
    4-step pass against the plain version, and steps_per_pass = 4 bitwise
    equal to 4 single steps.  Returns the largest difference."""
    import torch

    from beom_tpu_torch.stencils import fused_fb
    from beom_tpu_torch.stepping import make_stepper

    cfg, grid, forcing, st = perturbed_case(device, seed, case, **kw)
    statics = (grid, forcing)
    if case == "coastal_wetdry" and not bool((st.h < cfg.h_dry).logical_and(
            grid.mask > 0).any()):
        raise AssertionError(f"{label} {case}: no dry cell in the state")
    if cfg.obc and not bool((forcing.obc_v != 0).any()):
        raise AssertionError(f"{label} {case}: no open face in the state")
    worst = 0.0
    for n, k in ((0, 1), (1, 1), (0, 4)):
        args = (st.h, st.u, st.v, statics, n, st.t, cfg, k)
        out = fused_fb.fused_fb_step(*args)
        torch.cuda.synchronize()
        worst = max(worst, compare_fields(
            f"{label} {case} n={n} k={k}", "huv", out,
            fused_fb.fused_fb_step_plain(*args), tol))
    four = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused", steps_per_pass=4))(st)
    one = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused"))
    single = st
    for _ in range(4):
        single = one(single)
    for f in "huv":
        if not torch.equal(getattr(four, f), getattr(single, f)):
            raise AssertionError(f"{label} {case}: steps_per_pass=4 != 4 "
                                 f"steps in {f}")
    return worst


def run_path(device, case, kw, n_steps):
    """run() on one case at 2048^2 f32 with backend='fused', the step
    kernels' counts set to 0 just before and read just after; checks the
    counts, the diagnostics, the mass of a closed basin, h >= 0 under
    wet/dry, and 3 fused steps against 3 eager ones.  Returns the case and
    the counts."""
    import numpy as np
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import fused_fb

    label = f"{case} {kw.get('scheme', 'fb')}" + (
        f" nsub={kw['nsub']}" if "nsub" in kw else "")
    every = n_steps // 2
    built = make_case(case, nx=BIG, ny=BIG, device=device, backend="fused",
                      diag_every=every, **kw)
    cfg, grid, forcing, st = built
    log = io.StringIO()
    torch.cuda.synchronize()
    fused_fb.LAUNCHES = 0
    fused_fb.SPLIT_LAUNCHES.update(dict.fromkeys(fused_fb.SPLIT_LAUNCHES, 0))
    t0 = time.perf_counter()
    out = run(cfg, grid, forcing, st, n_steps, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused_fb.SPLIT_LAUNCHES, fb_step=fused_fb.LAUNCHES)
    diags = [json.loads(x) for x in log.getvalue().splitlines()]
    for d in diags:
        print("   " + json.dumps(d))
    split = cfg.scheme == "split"
    route = fused_fb.split_plan(cfg).route if split else 0
    if split:
        print(f"   {label}: {fused_fb.split_plan(cfg).describe()}")
    want = dict(slow=n_steps * (route == 3), subcycle=n_steps * (route == 3),
                recompose=n_steps * (route == 3), tend=n_steps * (route == 2),
                tail=n_steps * (route == 2), fb_step=n_steps * (not split))
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, not {want}")
    if [d["n"] for d in diags] != [every, 2 * every]:
        raise AssertionError(f"{label}: diagnostics missing")
    if not all(d["finite"] == 1.0 and all(np.isfinite(list(
            v for k, v in d.items() if k != "kind"))) for d in diags):
        raise AssertionError(f"{label}: non-finite diagnostics")
    if not diags[-1]["max_speed"] > 0:
        raise AssertionError(f"{label}: max_speed is 0: the run did nothing")
    if out.h.shape != (cfg.nz, BIG, BIG) or out.n != n_steps \
            or not bool(torch.isfinite(out.h).all()):
        raise AssertionError(f"{label}: wrong final state")
    sum0 = float(st.h.double().sum())
    drift = (float(out.h.double().sum()) - sum0) / sum0
    eta = float(((out.h.sum(0) - grid.H) * grid.mask).abs().max())
    h_min = float(out.h.min())
    print(f"   {label}: launches {counts}; relative mass drift {drift!r} "
          f"(f64 sum of h); max|sum h - H| {eta!r} m; min h {h_min!r} m; "
          f"{n_steps} steps in {wall:.3f} s wall (first run, diagnostics "
          "included)")
    if not cfg.obc and not abs(drift) < 1e-6:
        raise AssertionError(f"{label}: mass drift {drift!r}")
    if not eta < 10.0:
        raise AssertionError(f"{label}: max|sum h - H| {eta!r} m")
    if cfg.wetdry and not h_min >= 0.0:
        raise AssertionError(f"{label}: min h {h_min!r} < 0 under wet/dry")
    eager_ms = versus_eager(f"{label}, 3 fused steps", built, 3, 1e-5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(cfg, grid, forcing, st, n_steps, log=io.StringIO())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    print(f"   {label}: run() {ms!r} ms/step over {n_steps} steps "
          f"(diagnostics included); eager stepper {eager_ms!r} ms/step over "
          "3 steps")
    return built, counts


def device_rows(prof):
    """(device us, launches, name) of every kernel row of a profile."""
    from torch.autograd import DeviceType

    return [(getattr(r, "self_device_time_total", 0)
             or getattr(r, "self_cuda_time_total", 0), r.count, r.key)
            for r in prof.key_averages()
            if getattr(r, "device_type", None) == DeviceType.CUDA]


def device_ms(label, fn, n_calls, names):
    """The device's own time per call of fn(), by kernel: the mean time
    torch.profiler gives a launch of the kernels whose name holds a key of
    `names`, times that key's launches per call, in ms (None where the
    profiler saw no launch; it may miss some, so the mean is over those it
    saw).  Beside a time between CUDA events it separates the kernel from
    the host that launches it.  A key must match only the kernel's rows:
    one that also matches the call's other device work (a fill, a copy,
    the read-back of `.item()`) averages the kernel with it.  The
    profiler's kernel times themselves agree with the kernel's own
    %globaltimer span (coop_times) for the cooperative kernels too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler has been seen to miss every launch of a kernel in a
    # window (and some of them in others): up to three windows, until
    # each key's kernel is seen
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if all(any(name in r[2] and r[1] for r in rows) for name in names):
            break
    out = {}
    for name, per_call in names.items():
        us = sum(r[0] for r in rows if name in r[2])
        n = sum(r[1] for r in rows if name in r[2])
        out[name] = us / n * per_call / 1e3 if n else None
        print(f"   {label}, device time of {name}: {out[name]!r} ms/call "
              f"({per_call} launches per call; torch.profiler saw {n} of "
              f"{per_call * n_calls})")
    return out


def coop_times(label, stamped, key, n=5):
    """A persistent kernel's time three ways: between CUDA events around
    the call (time_ms, mean of n calls), its own span from the earliest
    CTA entry to the latest CTA exit (the launch's timing mode,
    stencils/stamps.py; median of n launches) and its device time under
    torch.profiler (device_ms; `key` names the kernel).  stamped(s) runs
    the kernel with stamps=s (None: off).  Returns (span, profiler) in
    ms."""
    import statistics

    from beom_tpu_torch.stencils.stamps import Stamps

    events = time_ms(lambda: stamped(None), n)
    runs = [Stamps() for _ in range(n)]
    for r in runs:
        stamped(r)
    span = statistics.median(r.span for r in runs)
    setup = [r.setup for r in runs if r.setup is not None]
    prof = device_ms(label, lambda: stamped(None), n, {key: 1})[key]
    print(f"   {label}: {events!r} ms between CUDA events around the call, "
          f"{span!r} ms the kernel's span by its stamps"
          + (f" (set-up {statistics.median(setup)!r})" if setup else "")
          + f", {prof!r} ms under torch.profiler")
    return span, prof


def busy_share(label, fn, n_steps, by_grid=None):
    """The device's busy share over one call of fn() under torch.profiler:
    the kernels' device time over the wall time (summed over the streams,
    so kernels that overlap count twice), and the largest rows.  by_grid
    names a kernel whose time is also printed per launch grid, read from
    the profiler's trace."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        print(f"   {label}: the profiler saw no device time; the idle share "
              "is not measured")
        return
    print(f"   {label}: {wall_us / n_steps / 1e3!r} ms/step under the "
          f"profiler, device busy {busy / wall_us:.3f} of wall, idle "
          f"{1 - busy / wall_us:.3f}")
    for us, count, key in sorted(rows, reverse=True)[:5]:
        print(f"      {us / 1e3:.3f} ms in {count} launches "
              f"({us / busy:.3f} of device time): {key[:70]}")
    if by_grid:
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(f"{tmp}/trace.json")
            events = json.loads(Path(f"{tmp}/trace.json").read_text())
        grids = {}
        for e in events["traceEvents"]:
            if e.get("cat") == "kernel" and by_grid in e.get("name", ""):
                g = tuple(e.get("args", {}).get("grid", ()))
                n, us = grids.get(g, (0, 0.0))
                grids[g] = (n + 1, us + e["dur"])
        for g, (n, us) in sorted(grids.items()):
            print(f"      {by_grid} with grid {g}: {us / 1e3:.3f} ms in {n} "
                  f"launches ({us / busy:.3f} of device time)")


def part_of(name, solve_keys):
    """The part of a projection step a device row belongs to: K3a, K3b,
    the solve (a kernel whose name holds one of solve_keys), a copy or
    fill, or glue (any other kernel: the right-hand side, the warm start,
    the diagnostics)."""
    if "proj_a" in name:
        return "K3a"
    if "proj_b" in name:
        return "K3b"
    if any(k in name for k in solve_keys):
        return "solve"
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "glue"


def glue_name(name):
    """A glue kernel by the functor or reduction it runs."""
    import re

    found = re.findall(r"(\w*(?:Functor|Op|_kernel|reduce)\w*)", name)
    return (found[-1] if found else name)[:60]


def step_parts(label, fn, n_steps, solve_keys):
    """A projection path's step by part, from one call of fn() (n_steps
    steps of run()) under torch.profiler: per step the device time of K3a,
    K3b, the solve and the other kernels (by name), the device's idle
    share, and the idle gaps on the device by the parts that bound them (a
    gap `solve -> K3b` is the host's time from the solve's end to K3b's
    launch reaching the card).  Returns {part or gap: us per step}."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        events = json.loads(Path(f"{tmp}/trace.json").read_text())
    dev = sorted((e for e in events["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "dur" in e), key=lambda e: e["ts"])
    if not dev:
        print(f"   {label}: the profiler saw no device time; the parts are "
              "not measured")
        return {}
    out, glue = {}, {}
    for e in dev:
        part = part_of(e["name"], solve_keys)
        out[part] = out.get(part, 0.0) + e["dur"] / n_steps
        if part == "glue":
            g = glue_name(e["name"])
            n, us = glue.get(g, (0, 0.0))
            glue[g] = (n + 1, us + e["dur"] / n_steps)
    gaps = {}
    for a, b in zip(dev, dev[1:]):
        gap = b["ts"] - (a["ts"] + a["dur"])
        if gap > 0:
            key = (f"idle {part_of(a['name'], solve_keys)} -> "
                   f"{part_of(b['name'], solve_keys)}")
            gaps[key] = gaps.get(key, 0.0) + gap / n_steps
    span = dev[-1]["ts"] + dev[-1]["dur"] - dev[0]["ts"]
    busy = sum(v for k, v in out.items()) * n_steps
    print(f"   {label}: {wall_us / n_steps / 1e3!r} ms/step wall under the "
          f"profiler, the device's first to last row {span / n_steps / 1e3!r}"
          f" ms/step, busy {busy / wall_us:.3f} of wall, idle "
          f"{1 - busy / wall_us:.3f}")
    print("      device us/step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(out.items(), key=lambda x: -x[1])))
    print("      glue us/step (launches/step): " + ", ".join(
        f"{k} {us:.1f} ({n / n_steps:g})" for k, (n, us) in sorted(
            glue.items(), key=lambda x: -x[1][1])))
    print("      idle gaps us/step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(gaps.items(),
                                          key=lambda x: -x[1])))
    out.update(gaps)
    out["wall"] = wall_us / n_steps
    out["idle share"] = 1 - busy / wall_us
    return out


def host_us(fn, n=200):
    """The host's time per call of fn() in us: the mean of n calls between
    two reads of the host's clock with no wait for the card in between
    (the card runs behind; its queue does not fill in n calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def case_phases(dev, smi, rel, ulps, gyre_err):
    """Phases 14 to 17; returns the kernels' JSON entries."""
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import build, fused_fb
    from beom_tpu_torch.stepping import split

    phase("14 build: the fb and split builds of the other cases")
    for item in sorted(k for k in build.BUILD_LOG
                       if k.startswith(("fb_step[", "split_step["))):
        print_build(build, item)

    phase("15 K1 per case and K1s against their plain versions")
    err = {("double_gyre", "fb"): gyre_err}
    for case in ("two_layer", "coastal_wetdry", "shelf_forced"):
        fb_case_compare("200x136 f64", dev, rel(1e-12), 41, case, nx=200,
                        ny=136, dtype="float64")
        err[case, "fb"] = fb_case_compare(f"{BIG}^2 f32", dev, ulps(4), 42,
                                          case, nx=BIG, ny=BIG)
    for case in FB_CASES:
        pass_vs_singles("200x136 f64", dev, 45, case, (2,), nx=200, ny=136,
                        dtype="float64")
        pass_vs_singles(f"{BIG}^2 f32", dev, 46, case, (2,), nx=BIG, ny=BIG)
    for case, nsub in AGREE_SPLIT:
        split_phases_compare("200x136 f64", dev, rel(1e-12), 43, case,
                             nx=200, ny=136, dtype="float64", nsub=nsub)
        worst = split_phases_compare(f"{BIG}^2 f32", dev, ulps(4), 44, case,
                                     nx=BIG, ny=BIG, nsub=nsub)
        for k, v in worst.items():
            err[case, k] = max(err.get((case, k), 0.0), v)
        for label, size, dtype in (("201x137 f64", (201, 137), "float64"),
                                   ("201x137 f32", (201, 137), "float32"),
                                   (f"{BIG}^2 f32", (BIG, BIG), "float32")):
            worst = split_two_compare(label, dev, 47, case, nx=size[0],
                                      ny=size[1], dtype=dtype, nsub=nsub)
            for k in ("tend", "tail"):
                err[case, k] = max(err.get((case, k), 0.0), worst)

    phase(f"16 the other paths at full width: run() at {BIG}^2 f32")
    launches = {}
    for case, kw, n_steps in PATHS:
        _, counts = run_path(dev, case, kw, n_steps)
        for k, v in counts.items():
            launches[case, k] = launches.get((case, k), 0) + v

    phase(f"17 times at {BIG}^2 f32 ({smi})")
    saved = (fused_fb.LAUNCHES, dict(fused_fb.SPLIT_LAUNCHES))
    entries = []
    pts = BIG * BIG
    for case in FB_CASES:
        cfg, grid, forcing, st = perturbed_case(dev, 2, case, nx=BIG, ny=BIG)
        entries.append(fb_times(
            case, cfg, (grid, forcing), st, smi,
            (launches[case, "fb_step"], 0), err[case, "fb"])["single"])
    # K1s's five kernels on the three split paths of phase 16 at nsub 8: the
    # JSON entries of each path's route (the gyre's and two_layer's two
    # launches, the shelf's three kernels), the other route's printed
    for case in ("double_gyre", "two_layer", "shelf_forced"):
        cfg, grid, forcing, st = perturbed_case(
            dev, 2, case, nx=BIG, ny=BIG, scheme="split", nsub=8)
        statics = (grid, forcing)
        sp = split.slow_phase(st, grid, forcing, cfg)
        sub = split.subcycle_phase(sp, grid, cfg)
        slow_f = fused_fb._launch_slow(st.h, st.u, st.v, statics, cfg)
        sub_f = fused_fb._launch_subcycle(slow_f, st.h, st.u, st.v, statics,
                                          cfg)
        nz = cfg.nz
        # fields moved and operations per point of each kernel: the slow
        # phase's and the recomposition's by split_fields; the subcycle
        # reads 7 of SlowPhase's and 3 masks and writes 5
        timed = {
            "slow": (lambda: split.slow_phase(st, grid, forcing, cfg),
                     lambda: fused_fb._launch_slow(st.h, st.u, st.v,
                                                   statics, cfg),
                     split_fields(cfg)["split_slow"], 150 * nz),
            "subcycle": (lambda: split.subcycle_phase(sp, grid, cfg),
                         lambda: fused_fb._launch_subcycle(
                             slow_f, st.h, st.u, st.v, statics, cfg),
                         15, 20 * cfg.nsub),
            "recompose": (lambda: _recompose_plain(sp, sub, st, grid,
                                                   forcing, cfg),
                          lambda: fused_fb._launch_recompose(
                              slow_f, sub_f, st.h, st.u, st.v, statics,
                              st.t, cfg),
                          split_fields(cfg)["split_recompose"], 40 * nz)}
        # the two-launch step: the slow phase's tendencies read h, u, v, the
        # four masks, f, the wind and the sponge and write du_s, dv_s; the
        # tail reads h, u, v, the tendencies, H, three masks and the open
        # boundary's maps and tides and writes h, u, v
        tend = fused_fb._launch_tend(st.h, st.u, st.v, statics, cfg)
        t1 = st.t + cfg.npdtype.type(cfg.dt)
        timed["tend"] = (
            lambda: split.slow_tendencies(st, grid, forcing, cfg),
            lambda: fused_fb._launch_tend(st.h, st.u, st.v, statics, cfg),
            5 * nz + 5 + 2 * cfg.wind + cfg.sponge, 150 * nz)
        timed["tail"] = (
            lambda: split.fast_phase(split.depth_means(st, *tend, grid, cfg),
                                     st, grid, forcing, cfg),
            lambda: fused_fb._launch_tail(tend, st.h, st.u, st.v, statics,
                                          t1, cfg),
            8 * nz + 4 + cfg.obc * (3 + 2 * len(cfg.tides)),
            20 * cfg.nsub + 40 * nz + 30)
        route = fused_fb.split_plan(cfg).route
        for k, (plain, kernel, fields, ops) in timed.items():
            if (k in ("tend", "tail")) != (route == 2):
                print(f"   K1s {k} {case} nsub=8 (not on this case's route):"
                      f" {time_ms(kernel, 100)!r} ms")
                continue
            ms = time_pair(f"K1s {k} {case} nsub=8", plain, kernel, 10, 100)
            suffix = "" if case == "double_gyre" else f"_{case}"
            entries.append(kernel_entry(
                f"split_{k}{suffix}", "split_step.cu", "band.py:200",
                launches[case, k], err[case, k], ms, fields * pts * 4,
                ops * pts))
    for case, nsub in (("double_gyre", 4), ("double_gyre", 8),
                       ("double_gyre", 12), ("two_layer", 8)):
        cfg, grid, forcing, st = perturbed_case(
            dev, 2, case, nx=BIG, ny=BIG, scheme="split", nsub=nsub)
        statics = (grid, forcing)
        args = (st.h, st.u, st.v, statics, st.n, st.t, cfg, 1)
        t1 = st.t + cfg.npdtype.type(cfg.dt)

        def three():
            slow = fused_fb._launch_slow(st.h, st.u, st.v, statics, cfg)
            sub = fused_fb._launch_subcycle(slow, st.h, st.u, st.v, statics,
                                            cfg)
            return fused_fb._launch_recompose(slow, sub, st.h, st.u, st.v,
                                              statics, t1, cfg)

        pl = fused_fb.split_plan(cfg)
        ms = time_pair(f"split step {case} nsub={nsub} ({pl.launches()} "
                       "launches)",
                       lambda: fused_fb.fused_fb_step_plain(*args),
                       lambda: fused_fb.fused_fb_step(*args), 5, 50,
                       unit="step")
        ms3 = time_ms(three, 50)
        bound = step_fields(cfg) * pts * 4 / HBM_BYTES_PER_S * 1e3
        print(f"   split step {case} nsub={nsub}: {ms[0]!r} ms by the plan "
              f"({pl.describe()}), the three kernels {ms3!r} ms; the "
              f"function's bound (each operand once) {bound!r} ms")
    for case, kw in (("two_layer", {}),
                     ("two_layer", dict(scheme="split", nsub=8))):
        cfg, grid, forcing, st = make_case(
            case, nx=BIG, ny=BIG, device=dev, backend="fused", diag_every=20,
            **kw)
        busy_share(f"{case} {cfg.scheme} through run()",
                   lambda: run(cfg, grid, forcing, st, 40, log=io.StringIO()),
                   40)
    fused_fb.LAUNCHES = saved[0]
    fused_fb.SPLIT_LAUNCHES.update(saved[1])
    return entries


def phase_fields(cfg):
    """(K3a, K3b) fields moved per point, each of the function's operands
    once.  The staggered masks and f are not among them: the reference's
    band rebuilds them from the centre mask and the row
    (band.py::band_grid_forcing), as the staged kernels rebuild the masks
    on every case.  K3a reads h, u, v, the mask and the wind and sponge
    fields that are on and writes u*, v*, div; K3b reads h, u*, v*, p, the
    mask and under the open boundary H, the two face maps and the tides,
    and writes h, u, v."""
    nz = cfg.nz
    a = 3 * nz + 1 + 2 * cfg.wind + cfg.sponge + 2 * nz + 1
    b = 3 * nz + 2 + cfg.obc * (3 + 2 * len(cfg.tides)) + 3 * nz
    return a, b


def phase_launchers(fp, grid, forcing, cfg):
    """(phase A, phase B) of a checkout's fused_projection as its stepper
    launches them, a(h, u, v, n) and b(h, u*, v*, p, t): one Phases held
    across calls where the checkout has it, else its proj_a / proj_b."""
    if hasattr(fp, "Phases"):
        ph = fp.Phases(grid, forcing, cfg)
        return ph.a, ph.b
    statics = (grid, forcing)
    return (lambda h, u, v, n: fp.proj_a(h, u, v, statics, n, cfg),
            lambda h, u_s, v_s, p, t: fp.proj_b(h, u_s, v_s, p, statics, t,
                                                cfg))


def projection_case_phases(dev, smi, rel, ulps):
    """Phase 18: K3a / K3b with every term; returns the JSON entries."""
    import torch

    from beom_tpu_torch.stencils import build, cg_fused
    from beom_tpu_torch.stencils import fused_projection as fp

    phase("18 K3a / K3b with every term: build lines, agreement, run()")
    for item in sorted(k for k in build.BUILD_LOG if k.startswith(
            ("projection[", "shard_step[", "halo_pad"))):
        print_build(build, item)
    err = {}
    for case in FB_CASES[1:]:
        for scheme in ("rigid_lid", "implicit_fs"):
            check_phases("200x136 f64", dev, rel(1e-12), 60, case=case,
                         nx=200, ny=136, dtype="float64", scheme=scheme)
            worst = check_phases(f"{BIG}^2 f32", dev, ulps(4), 61, case=case,
                                 nx=BIG, ny=BIG, scheme=scheme)
            err[case] = tuple(max(a, b) for a, b in zip(
                err.get(case, (0.0, 0.0)), worst))
    launches = {}
    for case, scheme, kw, n_run, n_twin, bound in PROJECTION_PATHS:
        label = f"{case} {scheme}" + (f" {kw}" if kw else "")
        built, _, counts, col = run_projection(label, dev, n_run, n_run // 2,
                                               name=case, scheme=scheme, **kw)
        # the guard redoes a stalled solve through K4a, K4b and K5: they
        # run exactly when it did
        stalled = counts["stalled"]
        if not (counts["proj_a"] == counts["proj_b"] == counts["cg_fused"]
                == n_run and (counts["rb_sweep"] > 0) == (stalled > 0)
                and (counts["mg_coarse"] > 0) == (stalled > 0)):
            raise AssertionError(f"{label}: launch counts {counts}")
        if stalled != (n_run if (case, scheme) == (
                "shelf_forced", "rigid_lid") else 0):
            raise AssertionError(f"{label}: {stalled} solves stalled")
        # the lid holds sum h = H where no open face prescribes the tide
        if scheme == "rigid_lid" and not built[0].obc and not col < 0.1:
            raise AssertionError(f"{label}: max|sum h - H| {col!r} m")
        if n_twin != BIG:
            from beom_tpu_torch.cases import make_case
            built = make_case(case, nx=n_twin, ny=n_twin, device=dev,
                              backend="fused", scheme=scheme)
            label = f"{case} {scheme} at {n_twin}^2"
        before = fp.COUNTS["stalled"]
        versus_eager(f"{label}, 2 fused steps", built, 2, bound)
        print(f"   {label}: the stall guard redid "
              f"{fp.COUNTS['stalled'] - before} of 2 solves")
        for k in ("proj_a", "proj_b"):
            launches[case, k] = launches.get((case, k), 0) + counts[k]

    print(f"   times at {BIG}^2 f32 ({smi})")
    saved = (dict(fp.LAUNCHES), cg_fused.LAUNCHES)
    entries = []
    pts = BIG * BIG
    for case in FB_CASES[1:]:
        cfg, grid, forcing, st = perturbed_case(
            dev, 2, case, nx=BIG, ny=BIG, scheme="implicit_fs")
        statics = (grid, forcing)
        ph = fp.Phases(grid, forcing, cfg)
        u_s, v_s, _ = ph.a(st.h, st.u, st.v, 0)
        p = (st.h.sum(0) - grid.H) * grid.mask
        ms_a = time_pair(
            f"K3a {case}",
            lambda: fp.proj_a_plain(st.h, st.u, st.v, statics, 0, cfg),
            lambda: ph.a(st.h, st.u, st.v, 0), 10, 100)
        ms_b = time_pair(
            f"K3b {case}",
            lambda: fp.proj_b_plain(st.h, u_s, v_s, p, statics, st.t, cfg),
            lambda: ph.b(st.h, u_s, v_s, p, st.t), 10, 100)
        keys = ph.kernel_keys()
        print(f"   {case} plan: {ph.plan.describe()}")
        dev_ms = device_ms(
            f"K3a / K3b {case}",
            lambda: (ph.a(st.h, st.u, st.v, 0),
                     ph.b(st.h, u_s, v_s, p, st.t)), 50,
            dict.fromkeys(keys, 1))
        single = fp.Phases(grid, forcing, cfg,
                           phase_plan=fp.PhasePlan(None, None, False))
        device_ms(f"the single-step K3a / K3b {case}", lambda: (
            single.a(st.h, st.u, st.v, 0),
            single.b(st.h, u_s, v_s, p, st.t)), 50,
            {"proj_a_kernel": 1, "proj_b_kernel": 1})
        fa, fb_ = phase_fields(cfg)
        entries.append(kernel_entry(
            f"proj_a_{case}", "projection.cu", "band.py:200",
            launches[case, "proj_a"], err[case][0], ms_a, fa * pts * 4,
            150 * cfg.nz * pts, device=dev_ms[keys[0]]))
        entries.append(kernel_entry(
            f"proj_b_{case}", "projection.cu", "band.py:200",
            launches[case, "proj_b"], err[case][1], ms_b, fb_ * pts * 4,
            60 * cfg.nz * pts, device=dev_ms[keys[1]]))
    fp.LAUNCHES.update(saved[0])
    cg_fused.LAUNCHES = saved[1]
    torch.cuda.synchronize()
    return entries


def equal_blocks(label, out, ref):
    """Raise unless two sharded fields hold the same bits; returns the
    largest difference measured (0.0)."""
    import torch

    worst = 0.0
    for s, (a, b) in enumerate(zip(out.blocks, ref.blocks)):
        if a.shape != b.shape:
            raise AssertionError(f"{label}: shard {s} has another shape")
        worst = max(worst, float((a - b).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: shard {s} differs")
    return worst


def check_halo_pad(dev, ny, nx):
    """K8 against pad2d's plain version on one grid size: every mesh, width,
    rank and type; one launch for every shard.  Returns the largest
    difference measured."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import halo_pad

    g = torch.Generator(device="cpu").manual_seed(70)
    n, worst = 0, 0.0
    for shape in ((2, 4), (1, 8), (8, 1), (1, 1)):
        m = pmesh.make_mesh(*shape, devices=[dev])
        for dtype in (torch.float32, torch.float64):
            for lead in ((), (2,)):
                a = pmesh.shard(torch.randn(lead + (ny, nx), generator=g,
                                            dtype=dtype).to(dev), m)
                for w in (1, 3, 5):
                    before = halo_pad.LAUNCHES
                    out = halo_pad.halo_pad(a, w)
                    torch.cuda.synchronize()
                    if halo_pad.LAUNCHES != before + 1:
                        raise AssertionError("K8: not one launch for every "
                                             "shard")
                    worst = max(worst, equal_blocks(
                        f"K8 {ny}x{nx} {shape} {dtype} w={w}", out,
                        halo_pad.halo_pad_plain(a, w)))
                    n += 1
    print(f"   K8 {ny}x{nx}: {n} pads (4 meshes, f32 / f64, 2-D / layered, "
          "w = 1, 3, 5) equal to pad2d's plain version bit for bit")
    return worst


def check_shard_step(label, dev, tol, seed, case, mesh_shape, **kw):
    """K7-fb on one perturbed case and mesh: the single-step kernel at both
    parities and a 2-step pass by the mesh plan against its plain version
    per shard and bit for bit single-device K1 on the gathered field, with
    the plan's launches; the pass kernel of kb = 2 and 3 (where its block
    fits a CTA) bit for bit K1's pass kernel of the same kb.  Returns the
    largest differences from the plain version (single step, pass)."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band, fused_fb

    cfg, grid, forcing, st = perturbed_case(dev, seed, case, **kw)
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    m = pmesh.make_mesh(*mesh_shape, devices=[dev])
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    fields = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    K = dist_band.MeshKernels((grid, forcing), cfg, m)
    worst = [0.0, 0.0]
    for n, k in ((0, 1), (1, 1), (0, 2)):
        before = dist_band.LAUNCHES["fb"]
        out = dist_band.shard_step(*fields, pstat, n, st.t, cfg, k,
                                   kernels=K)
        torch.cuda.synchronize()
        steps = K.plan.fb_launches(k)
        if dist_band.LAUNCHES["fb"] != before + len(steps):
            raise AssertionError(f"{label}: K7-fb launches")
        ref = dist_band.shard_step_plain(*fields, pstat, n, st.t, cfg, k)
        one = fused_fb.fused_fb_step(st.h, st.u, st.v, (grid, forcing), n,
                                     st.t, cfg, k)
        tag = f"{label} {case} {mesh_shape} n={n} k={k} ({steps})"
        got = [pmesh.gather(a) for a in out]
        i = int(max(steps) > 1)
        worst[i] = max(worst[i], compare_fields(
            f"{tag} vs plain", "huv", got, [pmesh.gather(a) for a in ref],
            tol))
        agree(f"{tag} vs K1", got, one, None)
    stacked = [dist_band.stack(a) for a in fields]
    for kb in (2, 3):
        if fused_fb.launch_plan(cfg, st.h.dtype, kb) is None \
                or kb > K.plan.max_kb:
            continue
        for n in (0, 1):
            before = dist_band.LAUNCHES["fb_pass"]
            with torch.cuda.device(dev):
                out = K.fb(*stacked, n, st.t, kb, kb=kb)
            one = fused_fb._launch_fb(st.h, st.u, st.v, (grid, forcing),
                                      n % 2, fused_fb._times(st.t, cfg, kb),
                                      cfg)
            torch.cuda.synchronize()
            if dist_band.LAUNCHES["fb_pass"] != before + 1:
                raise AssertionError(f"{label}: K7-fb pass launches")
            got = [pmesh.gather(dist_band.unstack(a, m)) for a in out]
            tag = f"{label} {case} {mesh_shape} n={n} pass kb={kb}"
            worst[1] = max(worst[1], compare_fields(
                f"{tag} vs plain", "huv", got,
                fused_fb.fused_fb_step_plain(st.h, st.u, st.v,
                                             (grid, forcing), n, st.t, cfg,
                                             kb), tol))
            agree(f"{tag} vs K1's pass", got, one, None)
    return worst


def eager_mesh_leg(dev, case, n_steps, atol_rel, nx, mesh_shape, **kw):
    """n_steps of the eager distributed stepper with halo_impl='rdma' on a
    mesh of shards on the card against the single-device eager stepper.
    Raises unless K8 was launched."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.parallel.dist import make_dist_stepper
    from beom_tpu_torch.stencils import halo_pad
    from beom_tpu_torch.stepping import run_steps

    cfg, grid, forcing, st = perturbed_case(dev, 71, case, nx=nx, ny=nx,
                                            halo_impl="rdma", **kw)
    m = pmesh.make_mesh(*mesh_shape, devices=[dev])
    before = halo_pad.LAUNCHES
    out = pmesh.gather_state(make_dist_stepper(
        grid, forcing, cfg, m, n_inner=n_steps)(pmesh.shard_state(st, m)))
    torch.cuda.synchronize()
    pads = halo_pad.LAUNCHES - before
    ref = run_steps(st, grid, forcing, cfg, n_steps)
    label = f"eager mesh {mesh_shape} {case} {cfg.scheme} {nx}^2"
    for f in "huv":
        a, b = getattr(out, f), getattr(ref, f)
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        print(f"   {label} {f}: max|mesh - single device| {err!r} (bound "
              f"{atol_rel!r} x max(scale {scale!r}, 1))")
        if not err <= atol_rel * max(scale, 1.0):
            raise AssertionError(f"{label} {f} off the single-device step")
    if pads <= 0:
        raise AssertionError(f"{label}: K8 was not launched")
    print(f"   {label}: {pads} pad2d calls in {n_steps} steps "
          f"({pads / n_steps!r} per step), each one K8 launch for every "
          "shard")


def mesh_phases(dev, smi, rel, ulps):
    """Phases 19 to 22; returns the JSON entries of K7 and K8."""
    import numpy as np
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.parallel.mesh import gather_state
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import dist_band, fused_fb, halo_pad

    phase("19 K8 against pad2d")
    err8 = max(check_halo_pad(dev, BIG, BIG), check_halo_pad(dev, 192, 128))

    phase("20 K7-fb against its plain version and single-device K1")
    err7 = [0.0, 0.0]
    for case in FB_CASES:
        for mesh_shape in ((4, 1), (2, 4), (2, 2)):
            check_shard_step("192x128 f64", dev, rel(1e-12), 72, case,
                             mesh_shape, nx=192, ny=128, dtype="float64")
            err7 = [max(x, y) for x, y in zip(err7, check_shard_step(
                f"{BIG}^2 f32", dev, ulps(4), 73, case, mesh_shape, nx=BIG,
                ny=BIG))]

    phase(f"21 the mesh path: run() on the {BIG}^2 f32 double gyre, 2 x 4 "
          "shards")
    n_steps = 200
    cfg, grid, forcing, st = make_case(
        "double_gyre", nx=BIG, ny=BIG, device=dev, backend="fused",
        steps_per_pass=4, diag_every=100)
    log1 = io.StringIO()
    ref = run(cfg, grid, forcing, st, n_steps, log=log1)
    mcfg = dataclasses.replace(cfg, mesh_y=2, mesh_x=4)
    plan7 = dist_band.mesh_plan(mcfg, torch.float32,
                                pmesh.make_mesh(2, 4, devices=[dev]))
    print(f"   mesh plan: {plan7.describe()}")
    logn = io.StringIO()
    torch.cuda.synchronize()
    dist_band.LAUNCHES.update(dict.fromkeys(dist_band.LAUNCHES, 0))
    k1_before = fused_fb.LAUNCHES
    t0 = time.perf_counter()
    out = run(mcfg, grid, forcing, st, n_steps, log=logn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts7 = dict(dist_band.LAUNCHES)
    for line in logn.getvalue().splitlines():
        print("   " + line)
    want = dict.fromkeys(counts7, 0)
    for key, c in plan7.launches(4).items():
        want[key] = c * n_steps // 4
    if counts7 != want or fused_fb.LAUNCHES != k1_before \
            or want["fb_pass"] == 0:
        raise AssertionError(f"mesh path: K7 launches {counts7}, not {want}")
    diags = [json.loads(x) for x in logn.getvalue().splitlines()]
    if [d["n"] for d in diags] != [100, 200] or not all(
            d["finite"] == 1.0 and all(np.isfinite(list(
                v for k, v in d.items() if k != "kind"))) for d in diags):
        raise AssertionError("mesh path: diagnostics missing or non-finite")
    if not diags[-1]["max_speed"] > 0:
        raise AssertionError("mesh path: max_speed is 0")
    if logn.getvalue() != log1.getvalue():
        raise AssertionError("mesh path: the diagnostics are not the "
                             "single-device run's")
    got = gather_state(out)
    for f in "huv":
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            raise AssertionError(f"mesh path: {f} is not the single-device "
                                 "K1 run's")
    print(f"   K7-fb launches {counts7} in {n_steps} steps on 8 shards, one "
          "per kernel for every shard; diagnostics and final state equal to "
          f"the single-device K1 run's bit for bit; {wall:.3f} s wall (first "
          "run, diagnostics included)")

    # the single-step kernel's path: steps_per_pass 1, K7-fb one launch per
    # step, equal to the single-device run of K1's single-step kernel
    n_one = 20
    cfg1 = dataclasses.replace(cfg, steps_per_pass=1, diag_every=10)
    ref = run(cfg1, grid, forcing, st, n_one, log=io.StringIO())
    torch.cuda.synchronize()
    dist_band.LAUNCHES.update(dict.fromkeys(dist_band.LAUNCHES, 0))
    out = run(dataclasses.replace(cfg1, mesh_y=2, mesh_x=4), grid, forcing,
              st, n_one, log=io.StringIO())
    torch.cuda.synchronize()
    counts7s = dict(dist_band.LAUNCHES)
    if counts7s != dict(dict.fromkeys(counts7s, 0), fb=n_one):
        raise AssertionError(f"single-step mesh path: K7 launches "
                             f"{counts7s}")
    got = gather_state(out)
    for f in "huv":
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            raise AssertionError(f"single-step mesh path: {f} is not the "
                                 "single-device run's")
    print(f"   steps_per_pass 1 on 2 x 4 shards: K7-fb launches {counts7s} "
          f"in {n_one} steps (the single-step kernel), final state equal to "
          "the single-device run's bit for bit")

    # K8's path: run() on the same case and mesh with the eager distributed
    # tier and halo_impl='rdma', every pad2d of the steps one K8 launch for
    # every shard; fb pads h, u and v once per step and carries no
    # reduction, so state and diagnostics equal the single-device eager
    # run's
    n_eager = 20
    ecfg = dataclasses.replace(cfg, backend="eager", steps_per_pass=1,
                               diag_every=10)
    log1 = io.StringIO()
    ref = run(ecfg, grid, forcing, st, n_eager, log=log1)
    rcfg = dataclasses.replace(ecfg, mesh_y=2, mesh_x=4, halo_impl="rdma")
    logn = io.StringIO()
    torch.cuda.synchronize()
    halo_pad.LAUNCHES = 0
    t0 = time.perf_counter()
    out = run(rcfg, grid, forcing, st, n_eager, log=logn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts8 = halo_pad.LAUNCHES
    if counts8 != 3 * n_eager:
        raise AssertionError(f"eager mesh path: K8 launches {counts8}, not "
                             f"{3 * n_eager}")
    if logn.getvalue() != log1.getvalue() or len(
            logn.getvalue().splitlines()) != 2:
        raise AssertionError("eager mesh path: the diagnostics are not the "
                             "single-device eager run's")
    got = gather_state(out)
    for f in "huv":
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            raise AssertionError(f"eager mesh path: {f} is not the "
                                 "single-device eager run's")
    print(f"   run() with backend='eager', halo_impl='rdma' on 2 x 4 shards: "
          f"K8 launches {counts8} in {n_eager} steps (3 pad2d per step, one "
          "launch each for every shard); diagnostics and final state equal "
          f"to the single-device eager run's bit for bit; {wall:.3f} s wall")

    # the other schemes of the eager distributed tier through K8, smaller:
    # fb and split carry no reduction, so 0.0; the projection steps' CG
    # sums in mesh order
    eager_mesh_leg(dev, "double_gyre", 3, 0.0, 512, (2, 4))
    eager_mesh_leg(dev, "double_gyre", 3, 0.0, 512, (2, 4), scheme="split")
    eager_mesh_leg(dev, "rigid_lid", 3, 1e-4, 512, (2, 4), precond="jacobi")
    eager_mesh_leg(dev, "double_gyre", 3, 1e-4, 512, (2, 4),
                   scheme="implicit_fs")
    eager_mesh_leg(dev, "rigid_lid", 1, 1e-4, 128, (2, 2))

    phase(f"22 times of the mesh kernels ({smi})")
    saved = (dict(dist_band.LAUNCHES), halo_pad.LAUNCHES, fused_fb.LAUNCHES)
    m = pmesh.make_mesh(2, 4, devices=[dev])
    for n_grid, n_k, n_p in ((BIG, 100, 10), (4 * BIG, 10, 2)):
        cfg, grid, forcing, st = perturbed_case(dev, 2, nx=n_grid, ny=n_grid,
                                                steps_per_pass=4)
        statics = (grid, forcing)
        pstat = dist_band.pad_statics(grid, forcing, cfg, m)
        fields = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
        K = dist_band.MeshKernels(statics, cfg, m)
        stacked = [dist_band.stack(a) for a in fields]
        kb = K.plan.kb(4)

        def k7(k=1, kb_=None):
            with torch.cuda.device(dev):
                return K.fb(*stacked, 0, st.t, k, kb=kb_)

        def k1(k=1):
            return fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0, st.t,
                                          cfg, k)
        if n_grid != BIG:
            two = [pmesh.gather(dist_band.unstack(a, m)) for a in k7(4)]
            agree(f"{n_grid}^2 f32 K7-fb (2, 4) 4-step pass vs K1", two,
                  k1(4), None)
        ms_one = time_pair(
            f"K7-fb {n_grid}^2 f32 (2, 4) one step",
            lambda: dist_band.shard_step_plain(*fields, pstat, 0, st.t, cfg,
                                               1), lambda: k7(1), n_p, n_k,
            unit="step")
        ms_pass = time_pair(
            f"K7-fb {n_grid}^2 f32 (2, 4) launch of kb = {kb}",
            lambda: dist_band.shard_step_plain(*fields, pstat, 0, st.t, cfg,
                                               kb), lambda: k7(kb, kb),
            max(n_p // kb, 1), n_k, unit="launch")
        ms_4 = time_ms(lambda: k7(4), max(n_k // 4, 2))
        ms_k1 = time_ms(k1, n_k)
        ms_k1_4 = time_ms(lambda: k1(4), max(n_k // 4, 2))
        print(f"   {n_grid}^2 f32 on (2, 4): K7-fb one step {ms_one[0]!r} "
              f"ms, a 4-step pass {ms_4!r} ({K.plan.fb_launches(4)}); K1 "
              f"one step {ms_k1!r}, its 4-step pass {ms_k1_4!r} "
              "(between events)")
        if n_grid == BIG:
            ms7, ms7p, cfg7, kb7 = ms_one, ms_pass, cfg, kb
            dev7 = device_ms(f"K7-fb {n_grid}^2 f32 (2, 4), one step",
                             lambda: k7(1), 50,
                             {"shard_step_kernel": 1})["shard_step_kernel"]
            dev7p = device_ms(
                f"K7-fb {n_grid}^2 f32 (2, 4), 4-step pass and K1's",
                lambda: (k7(4), k1(4)), 20,
                {"shard_pass_kernel": len(K.plan.fb_launches(4)),
                 "fb_pass_kernel": len(fused_fb.plan(cfg).launches(4))})
            print(f"   4-step pass on the device: K7-fb "
                  f"{dev7p['shard_pass_kernel']!r} ms, K1 "
                  f"{dev7p['fb_pass_kernel']!r} ms")
            h = fields[0]
            ms8 = time_pair(
                "K8 pad2d w=5 of (1, 1024, 512) shards on (2, 4)",
                lambda: halo_pad.halo_pad_plain(h, 5),
                lambda: halo_pad.halo_pad(h, 5), 20, 200)
            ly, lx = n_grid // 2, n_grid // 4
            bytes8 = 8 * 4 * (ly * lx + (ly + 10) * (lx + 10))
            dev8 = device_ms("K8 pad2d of the same shards",
                             lambda: halo_pad.halo_pad(h, 5), 50,
                             {"halo_pad_kernel": 1})["halo_pad_kernel"]
        del fields, pstat, st, grid, forcing, K, stacked
        torch.cuda.empty_cache()
    cfg, grid, forcing, st = make_case(
        "double_gyre", nx=BIG, ny=BIG, device=dev, backend="fused",
        steps_per_pass=4, diag_every=100, mesh_y=2, mesh_x=4)
    busy_share("double_gyre fb on a 2 x 4 mesh through run()",
               lambda: run(cfg, grid, forcing, st, 200, log=io.StringIO()),
               200, by_grid="shard_pass_kernel")
    dist_band.LAUNCHES.update(saved[0])
    halo_pad.LAUNCHES, fused_fb.LAUNCHES = saved[1], saved[2]
    pts = BIG * BIG * cfg7.npdtype.itemsize
    return [
        kernel_entry("shard_step", "shard_step.cu", "dist_band.py:63",
                     counts7s["fb"], err7[0], ms7, step_fields(cfg7) * pts,
                     150 * cfg7.nz * BIG * BIG, device=dev7),
        kernel_entry("shard_pass", "shard_step.cu", "dist_band.py:63",
                     counts7["fb_pass"], err7[1], ms7p,
                     step_fields(cfg7) * pts,
                     150 * cfg7.nz * kb7 * BIG * BIG,
                     device=dev7p["shard_pass_kernel"]
                     / len(plan7.fb_launches(4))),
        kernel_entry("halo_pad", "halo_pad.cu", "rdma_halo.py:42", counts8,
                     err8, ms8, bytes8, 0, site_dir="parallel", device=dev8)]


def agree(label, outs, refs, tol):
    """Raise unless every field of outs is within tol(ref) of refs (tol
    None: equal bit for bit); prints one line, returns the largest
    difference."""
    worst, bound_at = 0.0, None
    for i, (a, b) in enumerate(zip(outs, refs)):
        err = float((a - b).abs().max())
        bound = 0.0 if tol is None else tol(b)
        if tol is None and not bool((a == b).all()) or not err <= bound:
            raise AssertionError(f"{label} field {i}: {err!r} > {bound!r}")
        if err >= worst:
            worst, bound_at = err, bound
    print(f"   {label}: {len(outs)} fields, max|diff| {worst!r} "
          f"(bound {'bit for bit' if tol is None else repr(bound_at)})")
    return worst


def check_shard_split(label, dev, tol, seed, case, mesh_shape, **kw):
    """K7-split on one perturbed case and mesh: each of its five kernels
    (route 3's three, route 2's tendencies and tail) against its plain
    version per shard (within tol) and against the single-device kernel of
    K1s on the gathered field (bit for bit), and a 2-step pass by the
    plan's route against two K1s steps, with the plan's launches.  Returns
    {kernel: worst}."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band, fused_fb

    cfg, grid, forcing, st = perturbed_case(dev, seed, case, scheme="split",
                                            **kw)
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    statics = (grid, forcing)
    m = pmesh.make_mesh(*mesh_shape, devices=[dev])
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    tag = f"{label} {case} nsub={cfg.nsub} {mesh_shape}"

    def g(fields):
        return [pmesh.gather(a) for a in fields]

    K = dist_band.MeshKernels(statics, cfg, m)
    slow = dist_band.shard_split_slow(*sh, pstat, cfg, kernels=K)
    one_slow = fused_fb._launch_slow(st.h, st.u, st.v, statics, cfg)
    sub = dist_band.shard_split_subcycle(slow, pstat, cfg, kernels=K)
    one_sub = fused_fb._launch_subcycle(one_slow, st.h, st.u, st.v, statics,
                                        cfg)
    rec = dist_band.shard_split_recompose(slow, sub, sh[0], pstat, st.t, cfg,
                                          kernels=K)
    t1 = st.t + cfg.npdtype.type(cfg.dt)
    one_rec = fused_fb._launch_recompose(one_slow, one_sub, st.h, st.u, st.v,
                                         statics, t1, cfg)
    tend = dist_band.shard_split_tend(*sh, pstat, cfg, kernels=K)
    one_tend = fused_fb._launch_tend(st.h, st.u, st.v, statics, cfg)
    tail = dist_band.shard_split_tail(tend, *sh, pstat, st.t, cfg,
                                      kernels=K)
    one_tail = fused_fb._launch_tail(one_tend, st.h, st.u, st.v, statics,
                                     t1, cfg)
    before = dict(dist_band.LAUNCHES)
    two = dist_band.shard_step(*sh, pstat, 0, st.t, cfg, 2, kernels=K)
    torch.cuda.synchronize()
    want = dist_band.mesh_plan(cfg, st.h.dtype, m).launches(2)
    got = {k: dist_band.LAUNCHES[k] - before[k] for k in before
           if dist_band.LAUNCHES[k] != before[k]}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, not {want}")
    worst = {
        "slow": agree(f"{tag} slow vs plain", g(slow), g(
            dist_band.split_slow_plain(*sh, pstat, cfg)), tol),
        "subcycle": agree(f"{tag} subcycle vs plain", g(sub), g(
            dist_band.split_subcycle_plain(slow, pstat, cfg)), tol),
        "recompose": agree(f"{tag} recompose vs plain", g(rec), g(
            dist_band.split_recompose_plain(slow, sub, sh[0], pstat, st.t,
                                            cfg)), tol),
        "tend": agree(f"{tag} tend vs plain", g(tend), g(
            dist_band.split_tend_plain(*sh, pstat, cfg)), tol),
        "tail": agree(f"{tag} tail vs plain", g(tail), g(
            dist_band.split_tail_plain(tend, *sh, pstat, st.t, cfg)), tol)}
    agree(f"{tag} slow vs K1s", g(slow), one_slow, None)
    agree(f"{tag} subcycle vs K1s", g(sub), one_sub, None)
    agree(f"{tag} recompose vs K1s", g(rec), one_rec, None)
    agree(f"{tag} tend vs K1s", g(tend), one_tend, None)
    agree(f"{tag} tail vs K1s", g(tail), one_tail, None)
    agree(f"{tag} 2-step pass vs K1s's step (route "
          f"{fused_fb.split_plan(cfg).route})", g(two),
          fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0, st.t, cfg, 2),
          None)
    return worst


def layered(cfg, forcing, st, nz):
    """cfg, forcing and st with the bottom layer split into equal layers,
    each a little denser, up to nz layers: the same column, more
    layers."""
    import torch

    parts, top = nz - cfg.nz + 1, cfg.nz - 1
    rho = tuple(cfg.rho[:top]) + tuple(cfg.rho[top] + i
                                       for i in range(parts))

    def split(a, share):
        return torch.cat([a[:top]] + [a[top:] / share] * parts)

    h_ext = split(forcing.h_ext, parts)
    return (dataclasses.replace(cfg, nz=nz, rho=rho),
            dataclasses.replace(forcing, h_ext=h_ext),
            st.replace(h=split(st.h, parts), u=split(st.u, 1),
                       v=split(st.v, 1)))


# (case, layers) of phase 23's K7-proj where no staged geometry fits a CTA
# at f64, so the phases run the single-step bodies as on one device: phase
# A at nz = 3, both phases with wet/dry at nz = 5
SINGLE_STEP_PHASES = (("two_layer", 3), ("coastal_wetdry", 5))


def check_shard_projection(label, dev, tol, seed, case, scheme, mesh_shape,
                           layers=None, **kw):
    """K7-proj on one perturbed case (split to `layers` layers where
    given) and mesh, both parities: phase A and phase B against their
    plain versions per shard (within tol) and against K3a / K3b on the
    gathered field (bit for bit).  Returns the worst differences (A,
    B)."""
    import numpy as np
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band
    from beom_tpu_torch.stencils import fused_projection as fp

    cfg, grid, forcing, st = perturbed_case(dev, seed, case, scheme=scheme,
                                            **kw)
    if layers:
        cfg, forcing, st = layered(cfg, forcing, st, layers)
    st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
    statics = (grid, forcing)
    m = pmesh.make_mesh(*mesh_shape, devices=[dev])
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    rng = np.random.default_rng(seed + 100)
    p = torch.tensor((0.1 * rng.standard_normal((cfg.ny, cfg.nx))).astype(
        cfg.npdtype), device=dev) * grid.mask
    sp = pmesh.shard(p, m)
    pl = fp.plan(cfg, cfg.tdtype)
    tag = (f"{label} {case} nz={cfg.nz} {scheme} {mesh_shape} "
           f"({pl.describe()})")
    worst = [0.0, 0.0]
    K = dist_band.MeshKernels(statics, cfg, m)
    for n in (0, 1):
        before = dict(dist_band.LAUNCHES)
        a = dist_band.shard_proj_a(*sh, pstat, n, cfg, kernels=K)
        one_a = fp.proj_a(st.h, st.u, st.v, statics, n, cfg)
        b = dist_band.shard_proj_b(sh[0], a[0], a[1], sp, pstat, st.t, cfg,
                                   kernels=K)
        one_b = fp.proj_b(st.h, one_a[0], one_a[1], p, statics, st.t, cfg)
        torch.cuda.synchronize()
        if {k: dist_band.LAUNCHES[k] - before[k] for k in before} != dict(
                dict.fromkeys(before, 0), proj_a=1, proj_b=1):
            raise AssertionError(f"{tag}: not one launch per phase")
        ga = [pmesh.gather(x) for x in a]
        gb = [pmesh.gather(x) for x in b]
        worst[0] = max(worst[0], agree(f"{tag} n={n} A vs plain", ga, [
            pmesh.gather(x) for x in dist_band.proj_a_plain(
                *sh, pstat, n, cfg)], tol))
        worst[1] = max(worst[1], agree(f"{tag} n={n} B vs plain", gb, [
            pmesh.gather(x) for x in dist_band.proj_b_plain(
                sh[0], a[0], a[1], sp, pstat, st.t, cfg)], tol))
        agree(f"{tag} n={n} A vs K3a", ga, one_a, None)
        agree(f"{tag} n={n} B vs K3b", gb, one_b, None)
    return worst


def state_errs(out, ref, speed=False):
    """{field: (max|out - ref|, max|ref|)} of h, u and v; with speed=True u
    and v take the larger of their two scales, the velocity's (a pressure
    solve's error reaches both components alike through its gradient)."""
    errs = {f: (float((getattr(out, f) - getattr(ref, f)).abs().max()),
                float(getattr(ref, f).abs().max())) for f in "huv"}
    if speed:
        s = max(errs["u"][1], errs["v"][1])
        errs.update({f: (errs[f][0], s) for f in "uv"})
    return errs


def state_diff(label, out, ref, bound_rel, floor=0.0, speed=False):
    """max|out - ref| of h, u, v against bound_rel x max(scale, floor),
    bound_rel a number or one by field, the scales state_errs'; raises if
    over."""
    worst = 0.0
    for f, (err, scale) in state_errs(out, ref, speed).items():
        r = bound_rel[f] if isinstance(bound_rel, dict) else bound_rel
        bound = r * max(scale, floor)
        print(f"   {label} {f}: max|diff| {err!r} = "
              f"{err / max(scale, 1e-300)!r} x scale (scale {scale!r}, "
              f"bound {bound!r})")
        if not err <= bound:
            raise AssertionError(f"{label} {f}: {err!r} > {bound!r}")
        worst = max(worst, err)
    return worst


def scheme_mesh_specs():
    """The builds phases 23 to 25 use: the shard kernels and the
    single-device kernels they are held against, f32 and f64."""
    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.stencils import dist_band, fused_fb

    specs = set()
    for dtype in ("float32", "float64"):
        for case, nsub in MESH_SPLIT:
            cfg = make_case(case, nx=16, ny=16, device="cpu", dtype=dtype,
                            scheme="split", nsub=nsub)[0]
            specs |= {fused_fb.build_spec(cfg), dist_band.build_spec(cfg)}
        for case in FB_CASES + ("rigid_lid",):
            for scheme in ("implicit_fs", "rigid_lid"):
                cfg = make_case(case, nx=16, ny=16, device="cpu",
                                dtype=dtype, scheme=scheme)[0]
                # every case's grid is make_grid's: the masks rebuilt
                specs |= {projection_spec(cfg),
                          dist_band.build_spec(cfg, dmask=True)}
    for case, nz in SINGLE_STEP_PHASES:
        cfg, _, forcing, st = make_case(case, nx=16, ny=16, device="cpu",
                                        dtype="float64", scheme="rigid_lid")
        cfg = layered(cfg, forcing, st, nz)[0]
        specs |= {projection_spec(cfg), dist_band.build_spec(cfg, dmask=True)}
    return specs


def mesh_agreement(dev, rel, ulps, err_split):
    """Phase 23: K7-split and K7-proj against their plain versions and the
    single-device kernels; fills err_split by kernel and returns K7-proj's
    worst errors (phase A, phase B)."""
    phase("23 K7-split and K7-proj against their plain versions and the "
          "single-device kernels")
    err_proj = [0.0, 0.0]
    for case, nsub in MESH_SPLIT:
        for mesh_shape in MESH_SHAPES:
            check_shard_split("192x128 f64", dev, rel(1e-12), 80, case,
                              mesh_shape, nx=192, ny=128, dtype="float64",
                              nsub=nsub)
            worst = check_shard_split(f"{BIG}^2 f32", dev, ulps(4), 81, case,
                                      mesh_shape, nx=BIG, ny=BIG, nsub=nsub)
            for k, v in worst.items():
                err_split[k] = max(err_split.get(k, 0.0), v)
    for case in FB_CASES:
        for scheme, kw in (("implicit_fs", {}),
                           ("rigid_lid", dict(precond="jacobi"))):
            for mesh_shape in MESH_SHAPES:
                check_shard_projection("192x128 f64", dev, rel(1e-12), 82,
                                       case, scheme, mesh_shape, nx=192,
                                       ny=128, dtype="float64", **kw)
                worst = check_shard_projection(f"{BIG}^2 f32", dev, ulps(4),
                                               83, case, scheme, mesh_shape,
                                               nx=BIG, ny=BIG, **kw)
                err_proj = [max(x, y) for x, y in zip(err_proj, worst)]
    for case, nz in SINGLE_STEP_PHASES:
        check_shard_projection("192x128 f64", dev, rel(1e-12), 84, case,
                               "rigid_lid", (2, 2), layers=nz, nx=192,
                               ny=128, dtype="float64", precond="jacobi")
    return err_proj


def scheme_mesh_phases(dev, smi, rel, ulps):
    """Phases 23 to 25: the split and projection schemes on a mesh of
    shards; returns the JSON entries of K7-split, K7-proj and the mesh's
    solve."""
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.parallel import dist
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.parallel.mesh import gather_state
    from beom_tpu_torch.run import run
    from beom_tpu_torch.solvers import multigrid as mg
    from beom_tpu_torch.stencils import (cg_fused, dist_band, fused_fb,
                                         mesh_solve, mg_coarse, redblack)
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import prepare_state

    err_split = {}
    # the mesh solve's launches on phase 24's paths, by route
    solves = {}
    err_proj = mesh_agreement(dev, rel, ulps, err_split)

    phase(f"24 the split and projection schemes on a 2 x 4 mesh of shards "
          f"through run() at {BIG}^2 f32")
    n_split = 100
    cfg, grid, forcing, st = make_case(
        "double_gyre", nx=BIG, ny=BIG, device=dev, backend="fused",
        scheme="split", nsub=8, diag_every=50)
    log1, logn = io.StringIO(), io.StringIO()
    ref = run(cfg, grid, forcing, st, n_split, log=log1)
    torch.cuda.synchronize()
    dist_band.LAUNCHES.update(dict.fromkeys(dist_band.LAUNCHES, 0))
    k1s_before = dict(fused_fb.SPLIT_LAUNCHES)
    t0 = time.perf_counter()
    out = run(dataclasses.replace(cfg, mesh_y=2, mesh_x=4), grid, forcing,
              st, n_split, log=logn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts_split = dict(dist_band.LAUNCHES)
    for line in logn.getvalue().splitlines():
        print("   " + line)
    # the plan's route: one launch of each of its kernels per step for
    # every shard
    want = dict.fromkeys(counts_split, 0)
    want.update({k: c * n_split for k, c in dist_band.mesh_plan(
        cfg, torch.float32, pmesh.make_mesh(2, 4, devices=[dev])).launches(
        1).items()})
    if counts_split != want or fused_fb.SPLIT_LAUNCHES != k1s_before \
            or want["split_tail"] == 0:
        raise AssertionError(f"split mesh path: launches {counts_split}, "
                             f"not {want}")
    diags = [json.loads(x) for x in logn.getvalue().splitlines()]
    if [d["n"] for d in diags] != [50, 100] or not all(
            d["finite"] == 1.0 for d in diags) \
            or not diags[-1]["max_speed"] > 0:
        raise AssertionError("split mesh path: diagnostics")
    if logn.getvalue() != log1.getvalue():
        raise AssertionError("split mesh path: the diagnostics are not the "
                             "single-device K1s run's")
    got = gather_state(out)
    for f in "huv":
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            raise AssertionError(f"split mesh path: {f} is not the "
                                 "single-device K1s run's")
    print(f"   split nsub=8 on 2 x 4 shards: launches {counts_split} in "
          f"{n_split} steps ({sum(counts_split.values()) / n_split!r} per "
          "step); diagnostics and final state equal to the single-device "
          f"K1s run's bit for bit; {wall:.3f} s wall (first run, "
          "diagnostics included)")

    # route 3 on the mesh: the shelf's split step (the open boundary keeps
    # the three kernels), against the single-device run of K1s's three
    n_shelf = 10
    cfg, grid, forcing, st = make_case(
        "shelf_forced", nx=BIG, ny=BIG, device=dev, backend="fused",
        scheme="split", nsub=8, diag_every=5)
    ref = run(cfg, grid, forcing, st, n_shelf, log=io.StringIO())
    torch.cuda.synchronize()
    dist_band.LAUNCHES.update(dict.fromkeys(dist_band.LAUNCHES, 0))
    out = run(dataclasses.replace(cfg, mesh_y=2, mesh_x=4), grid, forcing,
              st, n_shelf, log=io.StringIO())
    torch.cuda.synchronize()
    counts_split3 = dict(dist_band.LAUNCHES)
    want = dict(dict.fromkeys(counts_split3, 0), split_slow=n_shelf,
                split_subcycle=n_shelf, split_recompose=n_shelf)
    if counts_split3 != want:
        raise AssertionError(f"shelf split mesh path: launches "
                             f"{counts_split3}, not {want}")
    got = gather_state(out)
    for f in "huv":
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            raise AssertionError(f"shelf split mesh path: {f} is not the "
                                 "single-device K1s run's")
    print(f"   shelf_forced split nsub=8 on 2 x 4 shards (route 3): "
          f"launches {counts_split3} in {n_shelf} steps; final state equal "
          "to the single-device K1s run's bit for bit")

    n_proj = 5
    cfg, grid, forcing, st = make_case(
        "rigid_lid", nx=BIG, ny=BIG, device=dev, backend="fused",
        scheme="implicit_fs", diag_every=5)
    ref = run(cfg, grid, forcing, st, n_proj, log=io.StringIO())
    mcfg = dataclasses.replace(cfg, mesh_y=2, mesh_x=4)
    torch.cuda.synchronize()
    dist_band.LAUNCHES.update(dict.fromkeys(dist_band.LAUNCHES, 0))
    single_before = dict(fp.LAUNCHES)
    k6_before = cg_fused.LAUNCHES
    t0 = time.perf_counter()
    out = gather_state(run(mcfg, grid, forcing, st, n_proj,
                           log=io.StringIO()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts_proj = dict(dist_band.LAUNCHES)
    solves["jacobi"] = cg_fused.LAUNCHES - k6_before
    want = {k: n_proj if k in ("proj_a", "proj_b") else 0
            for k in counts_proj}
    # the mesh's solve: one K6-Jacobi launch per step on the gathered grid
    if counts_proj != want or fp.LAUNCHES != single_before \
            or solves["jacobi"] != n_proj:
        raise AssertionError(f"implicit FS mesh path: launches "
                             f"{counts_proj} and {solves['jacobi']} of K6, "
                             f"not {want} and {n_proj}")
    eager = gather_state(run(dataclasses.replace(mcfg, backend="eager"),
                             grid, forcing, st, n_proj, log=io.StringIO()))
    # the mesh's solve is K6-Jacobi on the gathered grid, the single
    # device's solve on the same right-hand side: the run is the
    # single-device fused run's bit for bit.  The eager mesh run solves
    # with its own sums (per shard, then the mesh's), so at f32 x differs
    # by the solver's tolerance: h within 1e-6 x its scale, u and v within
    # MESH_F32_REL x the velocity's (v's own scale is ~20 times below
    # u's from rest); at f64 every field within 1e-6 x its own (below)
    state_diff("implicit FS 2 x 4 fused vs single-device fused", out, ref,
               0.0)
    state_diff("implicit FS 2 x 4 fused vs eager 2 x 4", out, eager,
               MESH_F32_BOUND, speed=True)
    # the bound's power: the same run with the solve stopped after
    # WRONG_ITERS iterations reads over it
    wrong = gather_state(run(dataclasses.replace(
        mcfg, solver_maxiter=WRONG_ITERS), grid, forcing, st, n_proj,
        log=io.StringIO()))
    errs = state_errs(wrong, eager, speed=True)
    wrong_rel = max(errs[f][0] / errs[f][1] for f in "uv")
    print(f"   implicit FS 2 x 4 with the solve stopped after {WRONG_ITERS} "
          f"iterations vs eager 2 x 4: u, v max|diff| "
          f"{errs['u'][0]!r}, {errs['v'][0]!r} = {wrong_rel!r} x the "
          f"velocity's scale (bound {MESH_F32_REL!r})")
    if not wrong_rel > MESH_F32_REL:
        raise AssertionError("implicit FS 2 x 4: a stopped solve passes the "
                             "bound against the eager mesh run")
    plan = dist_band.mesh_plan(mcfg, torch.float32,
                               pmesh.make_mesh(2, 4, devices=[dev]))
    print(f"   implicit FS on 2 x 4 shards: launches {counts_proj} and "
          f"{solves['jacobi']} of K6-Jacobi in {n_proj} steps, bit for bit "
          f"the single-device fused run; {wall:.3f} s wall (first run, "
          f"diagnostics included); the mesh plan: {plan.describe()}")
    cfg, grid, forcing, st = perturbed_case(
        dev, 24, "rigid_lid", nx=MG_MESH_N, ny=MG_MESH_N, dtype="float64",
        backend="fused", scheme="implicit_fs", mesh_y=2, mesh_x=4)
    st = prepare_state(st, cfg)
    m = pmesh.make_mesh(2, 4, devices=[dev])
    k6_before = cg_fused.LAUNCHES
    first = gather_state(dist.make_dist_stepper(grid, forcing, cfg, m)(
        pmesh.shard_state(st, m)))
    if cg_fused.LAUNCHES - k6_before != 1:
        raise AssertionError("implicit FS f64 on 2 x 4: not one K6 launch")
    eager = gather_state(dist.make_dist_stepper(
        grid, forcing, dataclasses.replace(cfg, backend="eager"), m)(
        pmesh.shard_state(st, m)))
    state_diff(f"implicit FS {MG_MESH_N}^2 f64 2 x 4, 1 fused step vs the "
               "eager mesh step", first, eager, 1e-6)

    # the rigid lid's default solve on the mesh, CG + multigrid: K6-mg on
    # the mesh's hierarchy (multigrid.mesh_levels, gamma 2 at every
    # transition) on the gathered grid of the 2 x 2 shards, one launch per
    # step.  At MG_EAGER_N from rest, the first fused step against the
    # eager mesh step (the plain version on the card, ~20 s): at f64
    # within 1e-6 x scale, at f32 within MESH_F32_BOUND; at MG_MESH_N from
    # a perturbed state (u and v of order 0.1, so that the bound 1e-5 x
    # max(scale, 1) below is under 1e-4 of theirs), then 5 more steps
    # timed.  Every first step against the single-device fused step (K6-mg
    # on its own hierarchy) within the solver tolerance
    m = pmesh.make_mesh(2, 2, devices=[dev])
    for n, dtype in ((MG_EAGER_N, "float64"), (MG_EAGER_N, "float32"),
                     (MG_MESH_N, "float32")):
        if n == MG_MESH_N:
            cfg, grid, forcing, st = perturbed_case(
                dev, 24, "rigid_lid", nx=n, ny=n, backend="fused")
        else:
            cfg, grid, forcing, st = make_case(
                "rigid_lid", nx=n, ny=n, device=dev, backend="fused",
                dtype=dtype)
        st = prepare_state(st, cfg)
        n_more = 5 if n == MG_MESH_N else 0
        dist_band.LAUNCHES.update(dict.fromkeys(dist_band.LAUNCHES, 0))
        k6_before = cg_fused.LAUNCHES
        t0 = time.perf_counter()
        step = dist.make_dist_stepper(grid, forcing, cfg, m)
        first = step(pmesh.shard_state(st, m))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        later = first
        for _ in range(n_more):
            later = step(later)
        torch.cuda.synchronize()
        per_step = (time.perf_counter() - t0) / max(n_more, 1) * 1e3
        got = {"proj_a": dist_band.LAUNCHES["proj_a"],
               "K6": cg_fused.LAUNCHES - k6_before,
               "proj_b": dist_band.LAUNCHES["proj_b"]}
        if got != dict.fromkeys(got, 1 + n_more):
            raise AssertionError(f"rigid lid on 2 x 2 at {n}^2: launches "
                                 f"{got} in {1 + n_more} steps")
        solves["mg"] = got["K6"]
        first = gather_state(first)
        if not bool(torch.isfinite(gather_state(later).h).all()):
            raise AssertionError(f"rigid lid on 2 x 2 at {n}^2: not finite")
        if n == MG_EAGER_N:
            eager = dist.make_dist_stepper(
                grid, forcing, dataclasses.replace(cfg, backend="eager"), m)(
                pmesh.shard_state(st, m))
            state_diff(f"rigid lid CG + multigrid {n}^2 {dtype} 2 x 2, 1 "
                       "fused step vs the eager mesh step", first,
                       gather_state(eager), 1e-6 if dtype == "float64"
                       else MESH_F32_BOUND, speed=dtype == "float32")
        single = cg_fused.make_cg_solve(grid, cfg, lam=0.0)
        pgrid1, _ = dist.pad_statics(grid, forcing, cfg, m, 1)
        cycle = mesh_solve.make_gathered_solve(dist._crop_tree(pgrid1, 1),
                                               cfg, m, 0.0).steps
        one = fp.make_fused_projection_stepper(grid, forcing, cfg)(st)
        state_diff(f"rigid lid CG + multigrid {n}^2 {dtype} 2 x 2, 1 fused "
                   "step vs the single-device fused step", first, one, 1e-5,
                   1.0)
        shapes = mg.level_shapes((n, n), mesh_solve.MIN_LOCAL, (2, 2))
        print(f"   rigid lid CG + multigrid on 2 x 2 at {n}^2 {dtype}: "
              f"launches "
              f"{got} in {1 + n_more} steps; {wall:.3f} s for the stepper's "
              f"set-up and its first step"
              + (f", {per_step!r} ms/step over {n_more} more" if n_more
                 else "")
              + f"; the mesh's cycle on {len(shapes)} levels {shapes[0]} to "
              f"{shapes[-1]}: {len(cycle)} steps, "
              f"{mg_coarse.grid_syncs(cycle)} grid syncs (the "
              f"single-device cycle: {len(single.steps)} steps, "
              f"{mg_coarse.grid_syncs(single.steps)})")
        del step, first, later, one, single, cycle

    # solver='redblack' on the mesh: K4a's sweep mode on the gathered grid,
    # RB_MAXITER sweeps in passes of mesh_solve.RB_SWEEPS per step (no
    # residual test, as the mesh's _dist_redblack), 3 steps at MG_MESH_N
    # f64 on (2, 2), the first against the eager mesh step within 1e-6 x
    # scale
    n_rb = 3
    cfg, grid, forcing, st = make_case(
        "rigid_lid", nx=MG_MESH_N, ny=MG_MESH_N, device=dev,
        dtype="float64", backend="fused", solver="redblack",
        solver_maxiter=RB_MAXITER)
    st = prepare_state(st, cfg)
    step = dist.make_dist_stepper(grid, forcing, cfg, m)
    dist_band.LAUNCHES.update(dict.fromkeys(dist_band.LAUNCHES, 0))
    rb_before = (redblack.LAUNCHES, cg_fused.LAUNCHES)
    outs = [pmesh.shard_state(st, m)]
    for _ in range(n_rb):
        outs.append(step(outs[-1]))
    torch.cuda.synchronize()
    per = len(mesh_solve.rb_passes(RB_MAXITER))
    got = {"proj_a": dist_band.LAUNCHES["proj_a"],
           "K4a": redblack.LAUNCHES - rb_before[0],
           "K6": cg_fused.LAUNCHES - rb_before[1],
           "proj_b": dist_band.LAUNCHES["proj_b"]}
    want = {"proj_a": n_rb, "K4a": per * n_rb, "K6": 0, "proj_b": n_rb}
    if got != want:
        raise AssertionError(f"red-black on 2 x 2: launches {got}, not "
                             f"{want}")
    solves["redblack"] = got["K4a"]
    eager = dist.make_dist_stepper(
        grid, forcing, dataclasses.replace(cfg, backend="eager"), m)(
        outs[0])
    state_diff(f"rigid lid red-black {MG_MESH_N}^2 f64 2 x 2, 1 fused step "
               "vs the eager mesh step", gather_state(outs[1]),
               gather_state(eager), 1e-6)
    if not bool(torch.isfinite(gather_state(outs[-1]).h).all()):
        raise AssertionError("red-black on 2 x 2: not finite")
    print(f"   rigid lid red-black on 2 x 2 at {MG_MESH_N}^2 f64: launches "
          f"{got} "
          f"in {n_rb} steps ({per} K4a passes of at most "
          f"{mesh_solve.RB_SWEEPS} sweeps per step)")
    del step, outs, eager

    phase(f"25 times of K7-split and K7-proj at {BIG}^2 f32 on 2 x 4 shards "
          f"({smi})")
    saved = (dict(dist_band.LAUNCHES), dict(fused_fb.SPLIT_LAUNCHES),
             dict(fp.LAUNCHES))
    m = pmesh.make_mesh(2, 4, devices=[dev])
    pts = BIG * BIG
    entries = []

    cfg, grid, forcing, st = perturbed_case(dev, 2, nx=BIG, ny=BIG,
                                            scheme="split", nsub=8)
    statics = (grid, forcing)
    K = dist_band.MeshKernels(statics, cfg, m)
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    f = [dist_band.stack(a) for a in sh]
    t1 = st.t + cfg.npdtype.type(cfg.dt)
    slow = K.slow(*f)
    sub = K.subcycle(slow, *f)
    tend = K.tend(*f)
    sl = [dist_band.unstack(a, m) for a in slow]
    sb = [dist_band.unstack(a, m) for a in sub]
    td = [dist_band.unstack(a, m) for a in tend]
    one_slow = fused_fb._launch_slow(st.h, st.u, st.v, statics, cfg)
    one_sub = fused_fb._launch_subcycle(one_slow, st.h, st.u, st.v, statics,
                                        cfg)
    one_tend = fused_fb._launch_tend(st.h, st.u, st.v, statics, cfg)
    nz = cfg.nz
    # per kernel: (its launch for every shard, the plain version, K1s's
    # kernel, the profiler's names of the shard and single-device kernels,
    # fields moved per point and operations per point: K1s's, each operand
    # once over the grid; the halo a shard reads is its neighbours' points,
    # not bytes the function needs) and the run its launches come from
    timed = {
        "tend": (lambda: K.tend(*f),
                 lambda: dist_band.split_tend_plain(*sh, pstat, cfg),
                 lambda: fused_fb._launch_tend(st.h, st.u, st.v, statics,
                                               cfg),
                 "shard_tend_kernel", "split_tend_kernel",
                 5 * nz + 5 + 2 * cfg.wind + cfg.sponge, 150 * nz,
                 counts_split),
        "tail": (lambda: K.tail(tend, *f, t1),
                 lambda: dist_band.split_tail_plain(td, *sh, pstat, st.t,
                                                    cfg),
                 lambda: fused_fb._launch_tail(one_tend, st.h, st.u, st.v,
                                               statics, t1, cfg),
                 "shard_tail_kernel", "split_tail_kernel",
                 8 * nz + 4 + cfg.obc * (3 + 2 * len(cfg.tides)),
                 20 * cfg.nsub + 40 * nz + 30, counts_split),
        "slow": (lambda: K.slow(*f),
                 lambda: dist_band.split_slow_plain(*sh, pstat, cfg),
                 lambda: fused_fb._launch_slow(st.h, st.u, st.v, statics,
                                               cfg),
                 "shard_slow_kernel", "split_slow_kernel",
                 split_fields(cfg)["split_slow"], 150 * nz,
                 counts_split3),
        "subcycle": (lambda: K.subcycle(slow, *f),
                     lambda: dist_band.split_subcycle_plain(sl, pstat, cfg),
                     lambda: fused_fb._launch_subcycle(
                         one_slow, st.h, st.u, st.v, statics, cfg),
                     "shard_sub_kernel", "split_sub_kernel", 15,
                     20 * cfg.nsub, counts_split3),
        "recompose": (lambda: K.recompose(slow, sub, *f, t1),
                      lambda: dist_band.split_recompose_plain(
                          sl, sb, sh[0], pstat, st.t, cfg),
                      lambda: fused_fb._launch_recompose(
                          one_slow, one_sub, st.h, st.u, st.v, statics, t1,
                          cfg),
                      "shard_rec_kernel", "split_rec_kernel",
                      split_fields(cfg)["split_recompose"], 40 * nz,
                      counts_split3)}
    for k, (kernel, plain, single, name7, name1, fields, ops, counts) in \
            timed.items():
        with torch.cuda.device(dev):
            ms = time_pair(f"K7-split {k} nsub=8 (2, 4)", plain, kernel, 5,
                           50)
            ms1 = time_ms(single, 100)
            dev_ms = device_ms(f"K7-split {k} (2, 4) and K1s {k}",
                               lambda: (kernel(), single()), 20,
                               {name7: 1, name1: 1})
        print(f"   {k}: K7-split {ms[0]!r} ms between events, "
              f"{dev_ms[name7]!r} on the device; K1s {ms1!r} / "
              f"{dev_ms[name1]!r}")
        entries.append(kernel_entry(
            f"shard_split_{k}", "shard_split.cu", "dist_band.py:63",
            counts[f"split_{k}"], err_split.get(k), ms, 4 * fields * pts,
            ops * pts, device=dev_ms[name7]))
    with torch.cuda.device(dev):
        step_ms = time_pair(
            "K7-split step nsub=8 (2, 4)",
            lambda: dist_band.shard_step_plain(*sh, pstat, 0, st.t, cfg, 1),
            lambda: K.split(*f, st.t, 1), 3, 30, unit="step")
        k1s_ms = time_ms(lambda: fused_fb.fused_fb_step(
            st.h, st.u, st.v, statics, 0, st.t, cfg, 1), 50)
        dev_step = device_ms(
            "K7-split step nsub=8 (2, 4) and K1s's", lambda: (
                K.split(*f, st.t, 1), fused_fb.fused_fb_step(
                    st.h, st.u, st.v, statics, 0, st.t, cfg, 1)), 20,
            {"shard_tend_kernel": 1, "shard_tail_kernel": 1,
             "split_tend_kernel": 1, "split_tail_kernel": 1})
    print(f"   split step nsub=8: K7-split on (2, 4) {step_ms[0]!r} ms "
          f"between events, "
          f"{dev_step['shard_tend_kernel'] + dev_step['shard_tail_kernel']!r}"
          f" on the device; K1s {k1s_ms!r} / "
          f"{dev_step['split_tend_kernel'] + dev_step['split_tail_kernel']!r}")
    del slow, sub, tend, sl, sb, td, one_slow, one_sub, one_tend, sh, f, K
    del pstat
    torch.cuda.empty_cache()

    cfg, grid, forcing, st = perturbed_case(dev, 2, "rigid_lid", nx=BIG,
                                            ny=BIG, scheme="implicit_fs")
    statics = (grid, forcing)
    K = dist_band.MeshKernels(statics, cfg, m)
    pstat = dist_band.pad_statics(grid, forcing, cfg, m)
    sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
    f = [dist_band.stack(a) for a in sh]
    p = (st.h.sum(0) - grid.H) * grid.mask
    ps = dist_band.stack_global(p, m)
    with torch.cuda.device(dev):
        us, vs, div = K.proj_a(*f, 0)
    u_s, v_s = (dist_band.unstack(a, m) for a in (us, vs))
    sp = dist_band.unstack(ps, m)
    ph = fp.Phases(grid, forcing, cfg)
    one_a = ph.a(st.h, st.u, st.v, 0)
    fa, fb_ = phase_fields(cfg)
    nz = cfg.nz
    keys = ph.kernel_keys()
    print(f"   mesh plan: {K.plan.describe()}")
    timed = {
        "proj_a": (lambda: K.proj_a(*f, 0),
                   lambda: dist_band.proj_a_plain(*sh, pstat, 0, cfg),
                   lambda: ph.a(st.h, st.u, st.v, 0),
                   "shard_pas_kernel", keys[0], fa, 150 * nz),
        "proj_b": (lambda: K.proj_b(f[0], us, vs, ps, st.t),
                   lambda: dist_band.proj_b_plain(sh[0], u_s, v_s, sp,
                                                  pstat, st.t, cfg),
                   lambda: ph.b(st.h, one_a[0], one_a[1], p, st.t),
                   "shard_pbs_kernel", keys[1], fb_, 60 * nz)}
    for k, (kernel, plain, single, name7, name1, fields, ops) in \
            timed.items():
        with torch.cuda.device(dev):
            ms = time_pair(f"K7-proj {k} implicit FS (2, 4)", plain, kernel,
                           5, 50)
            ms1 = time_ms(single, 100)
            dev_ms = device_ms(f"K7-proj {k} (2, 4) and K3{k[-1]}",
                               lambda: (kernel(), single()), 20,
                               {name7: 1, name1: 1})
        print(f"   {k}: K7-proj {ms[0]!r} ms between events, "
              f"{dev_ms[name7]!r} on the device; K3{k[-1]} {ms1!r} / "
              f"{dev_ms[name1]!r}")
        entries.append(kernel_entry(
            f"shard_{k}", "shard_projection.cu", "dist_band.py:63",
            counts_proj[k], err_proj[k == "proj_b"], ms, 4 * fields * pts,
            ops * pts, device=dev_ms[name7]))

    # the implicit-FS mesh step's time by part, between CUDA events on the
    # current stream, which every part joins: the mesh's solve on the card
    # (the fused stepper's) and the eager mesh solve (its plain version)
    pgrid1, _ = dist.pad_statics(grid, forcing, cfg, m, 1)
    grid_l = dist._crop_tree(pgrid1, 1)
    state = pmesh.shard_state(prepare_state(st, cfg), m)
    lam = dist.pressure_lam(cfg)
    solve = mesh_solve.make_mesh_solve(grid_l, pgrid1, cfg, m, lam)
    eager = lambda b, x0: dist._dist_solve(b, grid_l, pgrid1, cfg, lam=lam,
                                           x0=x0)
    for label, fn, n_steps in (("the mesh's solve on the card", solve, 5),
                               ("the eager mesh solve", eager, 3)):
        parts = dict.fromkeys(("phase A", "right-hand side", "solve",
                               "phase B"), 0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            a = dist_band.shard_proj_a(state.h, state.u, state.v, pstat,
                                       state.n, cfg, kernels=K)
            ev[1].record()
            rhs, x0 = dist.pressure_rhs(state, a[2], grid_l, cfg)
            ev[2].record()
            phi = fn(rhs, x0)
            ev[3].record()
            dist_band.shard_proj_b(state.h, a[0], a[1], phi, pstat, state.t,
                                   cfg, kernels=K)
            ev[4].record()
            torch.cuda.synchronize()
            for k, name in enumerate(parts):
                parts[name] += ev[k].elapsed_time(ev[k + 1]) / n_steps
        wall = (time.perf_counter() - t0) / n_steps * 1e3
        print(f"   implicit FS step on (2, 4), from the same state, through "
              f"{label}: " + ", ".join(f"{k} {v!r} ms"
                                       for k, v in parts.items())
              + f"; {wall!r} ms/step wall ({smi})")
    entries.append(mesh_solve_row(
        "jacobi", f"implicit FS {BIG}^2 f32 (2, 4)", solve, eager, rhs, x0,
        solves["jacobi"], None, smi))
    del solve, state, rhs, x0, a, phi, K, pstat
    torch.cuda.empty_cache()

    # the rigid lid's two mesh routes at MG_MESH_N on (2, 2): K6-mg on the
    # mesh's hierarchy and K4a's sweeps, from a perturbed state's phase A
    m = pmesh.make_mesh(2, 2, devices=[dev])
    for route, kw in (("mg", {}), ("redblack", dict(
            solver="redblack", solver_maxiter=RB_MAXITER))):
        cfg, grid, forcing, st = perturbed_case(
            dev, 3, "rigid_lid", nx=MG_MESH_N, ny=MG_MESH_N, **kw)
        K = dist_band.MeshKernels((grid, forcing), cfg, m)
        pstat = dist_band.pad_statics(grid, forcing, cfg, m)
        pgrid1, _ = dist.pad_statics(grid, forcing, cfg, m, 1)
        grid_l = dist._crop_tree(pgrid1, 1)
        state = pmesh.shard_state(prepare_state(st, cfg), m)
        div = dist_band.shard_proj_a(state.h, state.u, state.v, pstat,
                                     state.n, cfg, kernels=K)[2]
        rhs, x0 = dist.pressure_rhs(state, div, grid_l, cfg)
        solve = mesh_solve.make_mesh_solve(grid_l, pgrid1, cfg, m, 0.0)
        eager = lambda b, x0, cfg=cfg, grid_l=grid_l, pgrid1=pgrid1: \
            dist._dist_solve(b, grid_l, pgrid1, cfg, x0=x0)
        entries.append(mesh_solve_row(
            route, f"rigid lid {MG_MESH_N}^2 f32 (2, 2)", solve, eager, rhs,
            x0, solves[route], cfg.solver_maxiter, smi))
        del K, pstat, state, solve
    torch.cuda.empty_cache()
    dist_band.LAUNCHES.update(saved[0])
    fused_fb.SPLIT_LAUNCHES.update(saved[1])
    fp.LAUNCHES.update(saved[2])
    return entries


# the mesh's solve by route: its kernel's source, the reference's TPU
# kernel of the same computation on one device, and the profiler's name of
# the kernel
MESH_SOLVE_KERNELS = {
    "jacobi": ("cg_jacobi.cu", "cg_vmem.py:61", "cg_jacobi_kernel"),
    "mg": ("cg_fused.cu", "cg_vmem.py:61", "cg_kernel"),
    "redblack": ("rb_sweep.cu", "redblack_pallas.py:39", "rb_pass_kernel")}


def mesh_solve_row(route, label, solve, eager, rhs, x0, launches, sweeps,
                   smi):
    """The JSON row of the mesh's solve on the card by `route`, on one
    projection step's right-hand side and warm start (sharded): x against
    the eager mesh solve (its plain version on the card), the time per
    solve between CUDA events (the mean of 10) beside it (one call), the
    kernel's device time under
    torch.profiler, and the bound: the kernel's as PERF.md counts it (K6:
    b, x0, its statics and x once, ~30 operations per point and iteration
    and the cycle's on the mesh's hierarchy; K4a: x0, b, Hu, Hv, mask and
    x once, ~12 operations per point and sweep) plus the gather's and the
    scatter's bytes (b and x0 read and written, x read and written).
    `launches`: the kernel's launches on phase 24's path; `sweeps`: the
    red-black route's sweeps per solve."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import mesh_solve

    src, site, key = MESH_SOLVE_KERNELS[route]
    got = pmesh.gather(solve(rhs, x0))
    # the eager mesh solve once (~40 s for the rigid lid's multigrid at
    # 512^2), between CUDA events: its x and its time
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    ref = pmesh.gather(eager(rhs, x0))
    ev[1].record()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    ms = (time_ms(lambda: solve(rhs, x0), 10), ev[0].elapsed_time(ev[1]))
    pts, elem = got.numel(), got.element_size()
    if route == "redblack":
        per = len(mesh_solve.rb_passes(sweeps))
        n_bytes, n_ops = 6 * pts * elem, 12 * sweeps * pts
        iters = None
    else:
        per = 1
        res = solve.kernel(solve.gathered(rhs), solve.gathered(x0))
        iters = res.iters
        if route == "jacobi":
            n_bytes, n_ops = 6 * pts * elem, 30 * iters * pts
        else:
            levels = solve.levels
            n_bytes = (6 * sum(lv.mask.numel() for lv in levels)
                       + 3 * pts) * elem
            n_ops = iters * (cycle_ops(solve.steps, levels) + 30 * pts)
    copies = 6 * pts * elem
    dev_ms = device_ms(f"mesh solve, {route}, {label}",
                       lambda: solve(rhs, x0), 5, {key: per})[key]
    print(f"   mesh solve, {route}, {label}: {ms[0]!r} ms per solve between "
          f"events (eager mesh solve {ms[1]!r}), kernel {dev_ms!r} ms on the "
          f"device; max|x - eager| {err!r} (scale {scale!r})"
          + ("" if iters is None else f"; {iters} iterations")
          + f"; the gather and scatter's bytes "
          f"{copies / HBM_BYTES_PER_S * 1e3!r} ms at the memory rate ({smi})")
    bound = 1e-3 if route != "redblack" else 1e-5
    if not err <= bound * scale:
        raise AssertionError(f"mesh solve, {route}, {label}: {err!r} > "
                             f"{bound} x {scale!r}")
    return kernel_entry(
        f"mesh_solve_{route}", src, site, launches, err, ms,
        n_bytes + copies, n_ops, device=dev_ms,
        extra={"iterations": iters, "copies_bytes": copies,
               "mesh_solve_of": "beom_tpu/parallel/dist.py:273"})


def module_specs():
    """The builds phase 26 launches: the dry run's fused legs on 2 x 4
    shards at f32 and the single-device kernels they are held against
    (entry() and the TOML run take the main path's)."""
    import torch

    from beom_tpu_torch import entry
    from beom_tpu_torch.parallel.mesh import make_mesh
    from beom_tpu_torch.stencils import dist_band, fused_fb

    mesh = make_mesh(2, 4, devices=["cpu"])
    specs = set()
    for leg in entry.LEGS:
        cfg = leg.build(2, 4, "cpu")[0]
        if cfg.backend != "fused":
            continue
        # make_grid's masks: the staged phases rebuild them
        specs |= dist_band.build_specs(cfg, torch.float32, mesh, dmask=True)
        one = dataclasses.replace(cfg, mesh_y=1, mesh_x=1)
        if cfg.scheme in ("rigid_lid", "implicit_fs"):
            specs.add(projection_spec(one))
        elif cfg.scheme == "split":
            specs.add(fused_fb.build_spec(one, torch.float32))
        else:
            specs |= {fused_fb.build_spec(one, torch.float32, kb) for kb in
                      fused_fb.plan(one, torch.float32).launches(
                          one.steps_per_pass)}
    return specs


def modules_phase(dev, smi):
    """Phase 26: raw snapshots and the async writer, load_toml, entry(),
    dryrun_multichip(8) and multihost, on the card; raises on any
    failure."""
    import collections
    import tempfile

    import numpy as np
    import torch

    from beom_tpu_torch import entry
    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.io import config as ioconfig
    from beom_tpu_torch.io import native, snapshots
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.parallel import multihost
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import dist_band, fused_fb
    from beom_tpu_torch.stepping import make_stepper

    phase(f"26 the I/O and entry modules on the card ({smi})")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    d = Path(tmp.name)

    # raw snapshots, synchronous and through the async writer
    cfg, grid, forcing, st = make_case("double_gyre", nx=BIG, ny=BIG,
                                       device=dev, backend="fused",
                                       steps_per_pass=4)
    step = make_stepper(grid, forcing, cfg)
    out = st
    for _ in range(5):
        out = step(out)
    if out.n != 20 or not bool(torch.isfinite(out.u).all()):
        raise AssertionError("the gyre's 20 fused steps failed")
    m = pmesh.make_mesh(2, 4, devices=[dev])
    size = 3 * cfg.nz * cfg.ny * cfg.nx * 4

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    for label, state in (("one device", out),
                         ("2 x 4 shards", pmesh.shard_state(out, m))):
        a, b = d / f"{label[0]}_sync.bin", d / f"{label[0]}_async.bin"
        with native.AsyncWriter() as w:
            t_sync = timed(lambda: snapshots.save_raw(a, state, cfg))
            t_submit = timed(lambda: snapshots.save_raw(b, state, cfg,
                                                        writer=w))
            t_flush = timed(w.flush)
            if w.errors:
                raise AssertionError(f"raw {label}: {w.errors} write errors")
        if not (a.stat().st_size == b.stat().st_size == size):
            raise AssertionError(f"raw {label}: sizes {a.stat().st_size}, "
                                 f"{b.stat().st_size}, not {size}")
        if a.read_bytes() != b.read_bytes():
            raise AssertionError(f"raw {label}: the async file differs")
        back = snapshots.load_raw(b, cfg, device=dev)
        for f in "huv":
            got = getattr(back, f)
            if got.device.type != dev.type or not torch.equal(
                    got, pmesh.gather(getattr(state, f))):
                raise AssertionError(f"raw {label}: load_raw {f} differs")
        print(f"   raw {label}: {size} bytes; save_raw synchronous "
              f"{t_sync!r} s, through AsyncWriter {t_submit!r} s to submit "
              f"+ {t_flush!r} s to flush; files byte-equal, loaded back "
              f"onto the card bit for bit ({smi})")
    if (d / "o_sync.bin").read_bytes() != (d / "2_sync.bin").read_bytes():
        raise AssertionError("raw: the sharded state's file differs")

    # load_toml: a Config from a TOML file drives run() for 20 steps
    p = d / "gyre.toml"
    p.write_text(f'case = "double_gyre"\nnx = {BIG}\nny = {BIG}\n'
                 'scheme = "fb"\nbackend = "fused"\nsteps_per_pass = 4\n'
                 'diag_every = 10\n')
    tcfg = ioconfig.load_toml(p)
    ccfg, grid, forcing, st = make_case(
        "double_gyre", nx=tcfg.nx, ny=tcfg.ny, L=tcfg.dx * tcfg.nx,
        dt=tcfg.dt, device=dev, backend=tcfg.backend,
        steps_per_pass=tcfg.steps_per_pass, diag_every=tcfg.diag_every)
    if ccfg != tcfg:
        raise AssertionError(f"load_toml: {tcfg} is not the case's {ccfg}")
    per_pass = fused_fb.plan(tcfg, torch.float32).launches(4)
    log = io.StringIO()
    fused_fb.LAUNCHES = fused_fb.PASS_LAUNCHES = 0
    run(tcfg, grid, forcing, st, 20, log=log)
    launches = (fused_fb.LAUNCHES, fused_fb.PASS_LAUNCHES)
    # run()'s chunks of diag_every steps: its passes, then single steps
    want = (0, 0)
    for done in range(0, 20, tcfg.diag_every):
        n_pass, rem = divmod(min(tcfg.diag_every, 20 - done), 4)
        want = (want[0] + n_pass * len(per_pass) + rem,
                want[1] + n_pass * sum(k > 1 for k in per_pass))
    diags = [json.loads(x) for x in log.getvalue().splitlines()]
    if [x["n"] for x in diags] != [10, 20] or not all(
            x["finite"] == 1.0 and np.isfinite(
                [v for k, v in x.items() if k != "kind"]).all()
            for x in diags):
        raise AssertionError(f"load_toml run: diagnostics {diags}")
    if launches != want:
        raise AssertionError(f"load_toml run: K1 launched {launches}, "
                             f"plan {want}")
    print(f"   load_toml: nx {tcfg.nx}, scheme {tcfg.scheme}, backend "
          f"{tcfg.backend}, steps_per_pass {tcfg.steps_per_pass}; run() 20 "
          f"steps, K1 launches {launches[0]} ({launches[1]} of the pass "
          f"kernel; plan {per_pass} per pass of 4, single steps for the rest "
          f"of each chunk of {tcfg.diag_every}); last diagnostics "
          f"{json.dumps(diags[-1])}")

    # entry(): one call is one K1 launch, bit for bit K1's plain version,
    # from a perturbed state (at rest the first step's fluxes are zero)
    fn, (st,) = entry.entry(dev)
    ecfg, egrid, eforcing, _ = make_case("double_gyre", nx=256, ny=256,
                                         backend="fused", device=dev)
    st = entry.perturb(ecfg, egrid, st, 26)
    fused_fb.LAUNCHES = fused_fb.PASS_LAUNCHES = 0
    out = fn(st)
    torch.cuda.synchronize()
    if (fused_fb.LAUNCHES, fused_fb.PASS_LAUNCHES) != (1, 0):
        raise AssertionError(f"entry(): {fused_fb.LAUNCHES} K1 launches")
    ref = fused_fb.fused_fb_step_plain(st.h, st.u, st.v, (egrid, eforcing),
                                       st.n, st.t, ecfg, 1)
    for f, r in zip("huv", ref):
        if not torch.equal(getattr(out, f), r):
            raise AssertionError(
                f"entry(): {f} off K1's plain version by "
                f"{float((getattr(out, f) - r).abs().max())!r}")
    print(f"   entry(): 1 launch of K1's single-step kernel on "
          f"{tuple(st.h.shape)} from a perturbed state, bit for bit its "
          "plain version")

    # dryrun_multichip(8): the seven legs on 2 x 4 shards of the card
    for k in dist_band.LAUNCHES:
        dist_band.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    records = entry.dryrun_multichip(8, dev)
    wall = time.perf_counter() - t0
    total = dict(dist_band.LAUNCHES)
    for rec in records:
        leg, plan = rec["leg"], rec["plan"]
        want = {} if plan is None else {
            k: v * leg.n_inner for k, v in plan.launches().items() if v}
        print(f"   {leg.label}: K7 launches {rec['launches']}"
              + ("" if plan is None else f"; plan: {plan.describe()}"))
        if rec["launches"] != want:
            raise AssertionError(f"dry run {leg.label}: K7 launched "
                                 f"{rec['launches']}, plan {want}")
    summed = collections.Counter()
    for rec in records:
        summed.update(rec["launches"])
    total = {k: v for k, v in total.items() if v}
    if sum(r["plan"] is not None for r in records) != 5 \
            or total != dict(summed):
        raise AssertionError(f"dry run: K7 launches {total}, legs {summed}")
    print(f"   dryrun_multichip(8): 7 legs OK in {wall:.2f} s; K7 launches "
          f"{total}")

    # the fused legs again, each from a perturbed state, against one
    # device bit for bit: fb, tb2 and split end to end against K1 / K1s,
    # the projection legs' phases at their mesh plan against K3a / K3b
    m8 = pmesh.make_mesh(*entry.mesh_shape(8), devices=[dev])
    for i, leg in enumerate(entry.LEGS):
        if dict(leg.kw).get("backend") != "fused":
            continue
        rec = entry.run_leg(leg, m8, dev, seed=260 + i)
        for what, got, ref in entry.one_device_twins(rec, seed=270 + i):
            agree(f"{what} from a perturbed state, 2 x 4 shards vs one "
                  "device", got, ref, None)

    # multihost on one process
    multihost.init(num_processes=1)
    if torch.distributed.is_initialized() or not multihost.is_primary():
        raise AssertionError("multihost: init(num_processes=1) did something")
    field = pmesh.shard(torch.tensor(np.random.default_rng(26)
                                     .standard_normal((2, 96, 128)),
                                     dtype=torch.float32, device=dev), m)
    got = multihost.gather_to_host(field)
    if not (isinstance(got, np.ndarray) and np.array_equal(
            got, pmesh.gather(field).cpu().numpy())):
        raise AssertionError("multihost: gather_to_host != mesh.gather")
    print("   multihost: init(num_processes=1) a no-op, is_primary() True, "
          "gather_to_host of a 2 x 4-sharded field on the card equal to "
          "mesh.gather")
    tmp.cleanup()


# phase 27's cases at 2048^2 f32: the fb pass (K1's pass body, kb 2), the
# split step at nsub 8 by route 2 and the shelf's by route 3, and the
# implicit free surface's phases
CARD_CASES = (
    ("fb pass", "double_gyre", dict(steps_per_pass=4)),
    ("split route 2", "double_gyre", dict(scheme="split", nsub=8)),
    ("split route 3", "shelf_forced", dict(scheme="split", nsub=8)),
    ("phases", "double_gyre", dict(scheme="implicit_fs")),
)
# the 2 x 4 mesh's shards as two cards: the shard's device of each
CARD_SPLITS = {"along x": ["a", "a", "b", "b"] * 2,
               "along y": ["a"] * 4 + ["b"] * 4}


def card_specs():
    """The builds phase 27 launches beside the one-stack ones: each case's
    shard build across cards."""
    import torch

    from beom_tpu_torch.cases import make_case
    from beom_tpu_torch.parallel.mesh import make_mesh
    from beom_tpu_torch.stencils import dist_band

    mesh = make_mesh(2, 4, devices=["cpu"])
    specs = set()
    for _, case, kw in CARD_CASES:
        cfg = make_case(case, nx=BIG, ny=BIG, device="cpu", **kw)[0]
        for cards in (False, True):
            specs |= dist_band.build_specs(cfg, torch.float32, mesh,
                                           dmask=True, cards=cards)
    return specs


def two_cards(m, split, devices=None):
    """The mesh m's shards as two cards (CARD_SPLITS[split]), on devices
    (default: both on the shards' one device)."""
    from beom_tpu_torch.parallel.mesh import card_groups

    labels = CARD_SPLITS[split]
    cards = card_groups(labels, m.shape["y"], m.shape["x"])
    devices = devices or {x: m.devices[0] for x in labels}
    return [dataclasses.replace(c, device=devices[c.device]) for c in cards]


def card_legs(dev, m, split, cards, timed, smi):
    """Phase 27 on one split: every kernel of the path over the two cards
    against the one-stack route and the single-device kernel, bit for bit,
    their launches counted; K8 at w = 5; run() of the mesh fb path, 400
    steps; where `timed`, each kernel's time between CUDA events and on
    the device for both routes.  Returns {kernel: (two-card ms, one-stack
    ms, two-card device ms, one-stack device ms)}."""
    import numpy as np
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import dist_band, fused_fb, halo_pad
    from beom_tpu_torch.stencils import fused_projection as fp

    tag = f"two cards {split}"
    times = {}

    def counted(fn, want):
        before = dict(dist_band.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        got = {k: dist_band.LAUNCHES[k] - before[k] for k in before
               if dist_band.LAUNCHES[k] != before[k]}
        if got != want:
            raise AssertionError(f"{tag}: launches {got}, not {want}")
        return out

    def timing(name, one, two, keys):
        if not timed:
            return
        t1 = time_ms(one, 20)
        t2 = time_ms(two, 20)
        t1b = time_ms(one, 20)
        t2b = time_ms(two, 20)
        d1 = device_ms(f"{name} one stack", one, 10, keys)
        d2 = device_ms(f"{name} {tag}", two, 10,
                       {k: 2 * v for k, v in keys.items()})
        # None where the profiler saw no launch of a kernel: not measured
        dev = [None if None in d.values() else sum(d.values())
               for d in (d2, d1)]
        ms = ((t2 + t2b) / 2, (t1 + t1b) / 2, *dev)
        print(f"   {name}: {tag} {ms[0]!r} ms, one stack {ms[1]!r} ms "
              f"between events (one stack, two cards, two cards, one "
              f"stack); on the device {ms[2]!r} ms (both cards' launches "
              f"summed) and {ms[3]!r} ms ({smi})")
        times[name] = ms

    for i, (name, case, kw) in enumerate(CARD_CASES):
        cfg, grid, forcing, st = perturbed_case(dev, 280 + i, case, nx=BIG,
                                                ny=BIG, **kw)
        st = st.replace(t=cfg.npdtype.type(7 * cfg.dt))
        statics = (grid, forcing)
        sh = [pmesh.shard(a, m) for a in (st.h, st.u, st.v)]
        K1 = dist_band.MeshKernels(statics, cfg, m)
        K2 = dist_band.MeshKernels(statics, cfg, m, cards=cards)
        one, two = [K1.stack(a) for a in sh], [K2.stack(a) for a in sh]

        def g1(fields):
            return [pmesh.gather(K1.unstack(a, m)) for a in fields]

        def g2(fields):
            return [pmesh.gather(K2.unstack(a, m)) for a in fields]

        plan = K1.plan.launches()
        want = {k: 2 * v for k, v in plan.items() if v}
        if name == "fb pass":
            out2 = counted(lambda: K2.fb(*two, 0, st.t, 4), want)
            out1 = K1.fb(*one, 0, st.t, 4)
            ref = fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0, st.t,
                                         cfg, 4)
            agree(f"{tag} K7-fb 4-step pass ({K1.plan.fb_launches(4)}) vs "
                  "one stack", g2(out2), g1(out1), None)
            agree(f"{tag} K7-fb 4-step pass vs K1", g2(out2), ref, None)
            timing("K7-fb 4-step pass", lambda: K1.fb(*one, 0, st.t, 4),
                   lambda: K2.fb(*two, 0, st.t, 4),
                   {"shard_pass_kernel": len(K1.plan.fb_launches(4))})
        elif name.startswith("split"):
            out2 = counted(lambda: K2.split(*two, st.t, 1), {
                k: 2 * v for k, v in K1.plan.launches(1).items()})
            out1 = K1.split(*one, st.t, 1)
            ref = fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0, st.t,
                                         cfg, 1)
            agree(f"{tag} K7-split {case} nsub 8 route "
                  f"{K1.plan.split.route} vs one stack", g2(out2), g1(out1),
                  None)
            agree(f"{tag} K7-split {case} vs K1s", g2(out2), ref, None)
            keys = ({"shard_tend_kernel": 1, "shard_tail_kernel": 1}
                    if K1.plan.split.route == 2 else
                    {"shard_slow_kernel": 1, "shard_sub_kernel": 1,
                     "shard_rec_kernel": 1})
            timing(f"K7-split step, {name}", lambda: K1.split(*one, st.t, 1),
                   lambda: K2.split(*two, st.t, 1), keys)
        else:
            rng = np.random.default_rng(290)
            p = torch.tensor((0.1 * rng.standard_normal((cfg.ny, cfg.nx)))
                             .astype(cfg.npdtype), device=dev) * grid.mask
            sp = pmesh.shard(p, m)
            p1, p2 = K1.stack(sp), K2.stack(sp)
            for n in (0, 1):
                a2 = counted(lambda: K2.proj_a(*two, n), {"proj_a": 2})
                a1 = K1.proj_a(*one, n)
                one_a = fp.proj_a(st.h, st.u, st.v, statics, n, cfg)
                agree(f"{tag} K7-proj A n={n} vs one stack", g2(a2), g1(a1),
                      None)
                agree(f"{tag} K7-proj A n={n} vs K3a", g2(a2), one_a, None)
                b2 = counted(lambda: K2.proj_b(two[0], a2[0], a2[1], p2,
                                               st.t), {"proj_b": 2})
                b1 = K1.proj_b(one[0], a1[0], a1[1], p1, st.t)
                one_b = fp.proj_b(st.h, one_a[0], one_a[1], p, statics, st.t,
                                  cfg)
                agree(f"{tag} K7-proj B n={n} vs one stack", g2(b2), g1(b1),
                      None)
                agree(f"{tag} K7-proj B n={n} vs K3b", g2(b2), one_b, None)
            # the implicit-FS mesh step over the two cards: the phases
            # around the mesh's solve on the card (each card's blocks of
            # the right-hand side and warm start gathered on the first
            # card after its phase A, one K6 launch there, x copied back
            # into each card's stack before its phase B); 2 steps, bit for
            # bit the one-stack stepper, one K6 launch per step
            from beom_tpu_torch.parallel.dist import make_dist_stepper
            from beom_tpu_torch.stencils import cg_fused
            pcfg = dataclasses.replace(cfg, backend="fused", mesh_y=2,
                                       mesh_x=4)
            t0 = time.perf_counter()
            outs, k6 = [], []
            for c in (None, cards):
                before = cg_fused.LAUNCHES
                outs.append(pmesh.gather_state(make_dist_stepper(
                    grid, forcing, pcfg, m, n_inner=2, cards=c)(
                        pmesh.shard_state(st, m))))
                k6.append(cg_fused.LAUNCHES - before)
            torch.cuda.synchronize()
            if k6 != [2, 2]:
                raise AssertionError(f"{tag} implicit-FS mesh step: K6 "
                                     f"launches {k6}, not one per step")
            agree(f"{tag} implicit-FS mesh step x 2 vs one stack",
                  [getattr(outs[1], f) for f in "huv"],
                  [getattr(outs[0], f) for f in "huv"], None)
            print(f"   {tag} implicit FS: 2 mesh steps each way in "
                  f"{time.perf_counter() - t0:.2f} s, one K6 launch per "
                  "step on the gathered grid")
            timing("K7-proj phase A", lambda: K1.proj_a(*one, 0),
                   lambda: K2.proj_a(*two, 0),
                   {"shard_pas_kernel" if K1.plan.phases.a else
                    "shard_pa_kernel": 1})
            timing("K7-proj phase B",
                   lambda: K1.proj_b(one[0], a1[0], a1[1], p1, st.t),
                   lambda: K2.proj_b(two[0], a2[0], a2[1], p2, st.t),
                   {"shard_pbs_kernel" if K1.plan.phases.b else
                    "shard_pb_kernel": 1})
        del K1, K2, one, two, sh, st, grid, forcing

    # K8 at w = 5 on the gyre's shards, 2-D and layered
    g = torch.Generator(device="cpu").manual_seed(291)
    for lead in ((), (2,)):
        a = pmesh.shard(torch.randn(lead + (BIG, BIG), generator=g)
                        .to(dev), m)
        before = halo_pad.LAUNCHES
        out2 = halo_pad.halo_pad(a, 5, cards=cards)
        torch.cuda.synchronize()
        if halo_pad.LAUNCHES != before + 2:
            raise AssertionError(f"{tag} K8: not one launch per card")
        equal_blocks(f"{tag} K8 w=5 {lead} vs one stack", out2,
                     halo_pad.halo_pad(a, 5))
        equal_blocks(f"{tag} K8 w=5 {lead} vs pad2d", out2,
                     halo_pad.halo_pad_plain(a, 5))
        print(f"   {tag} K8 w=5 lead {lead}: one launch per card, bit for "
              "bit the one-stack launch and pad2d")
        if not lead:
            flat = a
    # timed on the 2-D field, as phase 22 times it
    timing("K8 pad2d w=5", lambda: halo_pad.halo_pad(flat, 5),
           lambda: halo_pad.halo_pad(flat, 5, cards=cards),
           {"halo_pad_kernel": 1})

    # run(): the mesh fb path over the two cards, against one stack
    from beom_tpu_torch.cases import make_case
    n_steps = 400
    cfg, grid, forcing, st = make_case(
        "double_gyre", nx=BIG, ny=BIG, device=dev, backend="fused",
        steps_per_pass=4, diag_every=100, mesh_y=2, mesh_x=4)
    log1, log2 = io.StringIO(), io.StringIO()
    ref = run(cfg, grid, forcing, st, n_steps, log=log1)
    torch.cuda.synchronize()
    dist_band.LAUNCHES.update(dict.fromkeys(dist_band.LAUNCHES, 0))
    t0 = time.perf_counter()
    out = run(cfg, grid, forcing, st, n_steps, log=log2, devices=m.devices,
              cards=cards)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in dist_band.LAUNCHES.items() if v}
    plan = dist_band.mesh_plan(cfg, torch.float32, m)
    want = {k: 2 * v * n_steps // 4 for k, v in plan.launches(4).items()
            if v}
    if counts != want:
        raise AssertionError(f"{tag} run(): K7 launches {counts}, not "
                             f"{want}")
    if log2.getvalue() != log1.getvalue() or len(
            log2.getvalue().splitlines()) != n_steps // 100:
        raise AssertionError(f"{tag} run(): diagnostics differ")
    got, want_st = pmesh.gather_state(out), pmesh.gather_state(ref)
    for f in "huv":
        if not torch.equal(getattr(got, f), getattr(want_st, f)):
            raise AssertionError(f"{tag} run(): {f} is not the one-stack "
                                 "run's")
    print(f"   {tag} run(): {n_steps} steps, K7 launches {counts} (one per "
          "card and kernel), diagnostics every 100 and final state equal to "
          f"the one-stack run's bit for bit; {wall:.3f} s wall")
    return times


def cards_phase(dev, smi):
    """Phase 27: the fused mesh over several cards, checked on the one
    card as two stacks on two streams; returns the times by split."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh

    phase(f"27 the fused mesh over two cards: two stacks on two streams "
          f"of the one card ({smi})")
    m = pmesh.make_mesh(2, 4, devices=[dev])
    times = {}
    for i, split in enumerate(CARD_SPLITS):
        # the times on the first split alone: the script's time limit
        times[split] = card_legs(dev, m, split, two_cards(m, split), i == 0,
                                 smi)
    if torch.cuda.device_count() >= 2:
        pair = [torch.device("cuda", 0), torch.device("cuda", 1)]
        for split, labels in CARD_SPLITS.items():
            devices = dict(zip(("a", "b"), pair))
            m2 = pmesh.make_mesh(2, 4, devices=[devices[x] for x in labels])
            card_legs(pair[0], m2, split, m2.cards, False, smi)
            print(f"   the legs of {split} again over cuda:0 and cuda:1")
    else:
        print("   the legs over two real cards: skipped, one card is "
              "visible (torch.cuda.device_count() == 1)")
    return times


# phase 28: the shelf at full width with many layers and constituents.
# 2048^2 f32 at 32 layers is past K1's wall of 24 layers under wet/dry and
# K3a / K3b's of 32 (K1, K3a and K3b layer-streamed, and K1s's route 3
# from 4 layers; K7-fb, K7-split and K7-proj streamed with them); 512^2
# f64 at 16 layers past K1's 13 and K3a / K3b's 16 (the time limit cuts
# the f64 grid); nz 8 f32, where every route builds, holds the routes
# forced by the plans' own parameter against the shared-memory route
LAYERS28 = 32
TIDES28 = 13
TIDE_SEED28 = 28
LAYERS28_F64 = 16
N28_F64 = 512
BOTH28 = 8
MESH28 = (2, 2)


@functools.lru_cache(maxsize=4)
def layers_tides(device, n, dtype):
    """(omegas, amplitudes, phases) of TIDES28 of TPXO's constituents on an
    n x n grid (shelf_forced.constituents: M2 at the case's uniform 0.5 m,
    the others at amplitudes below 0.1 m and phases from numpy's generator
    of the seed TIDE_SEED28), the maps on `device`; made once per size."""
    import numpy as np
    import torch

    from beom_tpu_torch.cases import shelf_forced

    om, amp, ph = shelf_forced.constituents(TIDES28, n, n, TIDE_SEED28,
                                            dtype=np.dtype(dtype))
    return om, torch.tensor(amp, device=device), torch.tensor(ph,
                                                              device=device)


def layers_case(device, seed, nz, dtype, n, **kw):
    """The shelf (wet/dry, the open boundary with Flather, sponge, wind,
    bottom drag) at n x n, perturbed by `seed`, its bottom layer split up
    to nz layers, with TIDES28 of TPXO's constituents at the open boundary
    (layers_tides), at a time where the tides are on."""
    cfg, grid, forcing, st = perturbed_case(device, seed, "shelf_forced",
                                            nx=n, ny=n, dtype=dtype, **kw)
    cfg, forcing, st = layered(cfg, forcing, st, nz)
    om, amp, ph = layers_tides(str(device), n, cfg.npdtype.name)
    cfg = dataclasses.replace(cfg, tides=om)
    forcing = dataclasses.replace(forcing, tide_amp=amp, tide_phase=ph)
    return cfg, grid, forcing, st.replace(t=cfg.npdtype.type(7 * cfg.dt))


def layers_specs():
    """Every build phase 28 launches but the solve's (cg_jacobi)."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band
    from beom_tpu_torch.stencils import fused_fb
    from beom_tpu_torch.stencils import fused_projection as fp

    specs = set()
    legs = [(LAYERS28, "float32", True), (LAYERS28_F64, "float64", True),
            (BOTH28, "float32", False)]
    for nz, dtype, mesh in legs:
        for scheme in ("fb", "split", "implicit_fs"):
            cfg, grid, forcing, st = layers_case("cpu", 0, nz, dtype, 64,
                                                 scheme=scheme, nsub=8,
                                                 precond="jacobi")
            dm = fp.derived_masks(grid)
            forced = (False,) if mesh else (False, True)
            for off in forced:
                if scheme == "implicit_fs":
                    specs.add(fp.build_spec(cfg, cfg.tdtype,
                                            fp.plan(cfg, cfg.tdtype, off),
                                            dm))
                    if off:
                        specs.add(fp.build_spec(cfg, cfg.tdtype, fp.PhasePlan(
                            None, None, False), dm))
                else:
                    specs |= {fused_fb.build_spec(cfg, cfg.tdtype, m,
                                                  off_smem=off and m == 1)
                              for m in fused_fb.plan(cfg, cfg.tdtype, 1,
                                                     off).launches(1)}
                    if scheme == "split" and off:
                        # the shared-memory route the plan leaves at nz 8
                        specs.add(fused_fb.build_spec(
                            cfg, cfg.tdtype, sp=dataclasses.replace(
                                fused_fb.split_plan(cfg, cfg.tdtype),
                                stream=False)))
            m = pmesh.make_mesh(*MESH28, devices=["cpu"])
            if mesh:
                # K7 on one stack and as two cards' stacks
                for cards in (False, True):
                    specs |= dist_band.build_specs(cfg, cfg.tdtype, m,
                                                   dmask=dm, cards=cards)
            elif scheme != "implicit_fs":
                # K7-fb and K7-split on the forced route
                specs |= dist_band.build_specs(cfg, cfg.tdtype, m,
                                               off_smem=True)
    return specs


def layers_leg(dev, smi, nz, dtype, n, timed, timed_proj=False,
               cards=False):
    """Phase 28's checks of one leg (nz layers at n^2): K1's layer-streamed
    kernels, K1s's layer-streamed slow phase and recomposition (route 3),
    and K3a / K3b layer-streamed, each bit for bit its plain version (K3a's
    div within 4 ulp / 1e-12 of its scale; both sweep parities where the
    kernel takes one), their plans printed, and K7-fb, K7-split and
    K7-proj on a 2 x 2 mesh of shards of the card (layer-streamed, as the
    single-device kernels) bit for bit the single-device kernels; with
    `cards`, each also as two cards' stacks (the BEOM_CARDS build) bit for
    bit the one-stack route.  With `timed` (`timed_proj`: the projection's
    kernels alone), each kernel's time between CUDA events and on the
    device beside its plain version's (K1's step, both launches, between
    events; its two kernels each on the device, beside the plain
    continuity and the plain momentum and finalize; K1s's recomposition,
    both launches, between events and each on the device; K7-split's slow
    phase and recomposition each alone).  Returns {kernel: (err, (ms,
    plain_ms), device ms)} of the timed kernels (K1s's recomposition and
    the K7 rows: the device times by kernel name), and under "fb_parts"
    {K1's kernel: (err, device ms, plain part's ms)}."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band, fused_fb
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import fb, split

    from beom_tpu_torch.core.state import advance_time

    tag = f"{n}^2 {dtype} nz={nz}"
    out = {}
    # K1 on its plan's route (layer-streamed), both parities
    cfg, grid, forcing, st = layers_case(dev, 28, nz, dtype, n)
    statics = (grid, forcing)
    pl = fused_fb.plan(cfg, cfg.tdtype, 1)
    print(f"   K1 {tag}: {pl.describe()}")
    if not pl.stream:
        raise AssertionError(f"K1 {tag} is not layer-streamed")
    for par in (0, 1):
        args = (st.h, st.u, st.v, statics, par, st.t, cfg, 1)
        got = fused_fb.fused_fb_step(*args)
        torch.cuda.synchronize()
        ref = fused_fb.fused_fb_step_plain(*args)
        err = agree(f"K1 {tag} n={par} vs plain", got, ref, None)
    if timed:
        # the step (both launches) between events; each kernel on the
        # device, beside the plain version of its part of the step: the
        # continuity, and the momentum with finalize from its h1
        args = (st.h, st.u, st.v, statics, 0, st.t, cfg, 1)
        ms = time_pair(f"K1 {tag} (layer-streamed, both launches)",
                       lambda: fused_fb.fused_fb_step_plain(*args),
                       lambda: fused_fb.fused_fb_step(*args), 2, 10)
        dev_ms = device_ms(f"K1 {tag}", lambda: fused_fb.fused_fb_step(
            *args), 5, {"fb_cont_kernel": 1, "fb_mom_kernel": 1})
        s0 = st.replace(n=0)
        h1 = fb.continuity_update(s0, grid, forcing, cfg)
        plain_c = time_ms(lambda: fb.continuity_update(s0, grid, forcing,
                                                       cfg), 2)
        plain_m = time_ms(lambda: fb.finalize(h1, *fb.momentum_update(
            h1, s0, grid, forcing, cfg), s0, grid, forcing, cfg), 2)
        got = fused_fb.fused_fb_step(*args)
        ref = fused_fb.fused_fb_step_plain(*args)
        torch.cuda.synchronize()
        err_c = agree(f"K1 {tag}: the continuity's h1 vs plain", got[:1],
                      ref[:1], None)
        err_m = agree(f"K1 {tag}: the momentum's u, v vs plain", got[1:],
                      ref[1:], None)
        print(f"   K1 {tag}: plain continuity {plain_c!r} ms, plain "
              f"momentum and finalize {plain_m!r} ms ({smi})")
        out["fb_step"] = (max(err, err_c, err_m), ms,
                          None if None in dev_ms.values() else
                          sum(dev_ms.values()))
        out["fb_parts"] = {
            "fb_cont_kernel": (err_c, dev_ms["fb_cont_kernel"], plain_c),
            "fb_mom_kernel": (err_m, dev_ms["fb_mom_kernel"], plain_m)}
    del cfg, grid, forcing, st, statics
    torch.cuda.empty_cache()

    # K1s at nsub 8 on its plan's route, one step: each kernel from the
    # plain phases' inputs, then the step
    cfg, grid, forcing, st = layers_case(dev, 29, nz, dtype, n,
                                         scheme="split", nsub=8)
    statics = (grid, forcing)
    sp = fused_fb.split_plan(cfg, cfg.tdtype)
    print(f"   K1s {tag} nsub=8: {sp.describe()}")
    if not (sp.route == 3 and sp.stream):
        raise AssertionError(f"K1s {tag} is not layer-streamed on route 3")
    sp_ref = split.slow_phase(st, grid, forcing, cfg)
    got = fused_fb.split_slow(st.h, st.u, st.v, statics, cfg)
    torch.cuda.synchronize()
    err_s = agree(f"K1s slow {tag} (layer-streamed) vs plain", got, sp_ref,
                  None)
    sub_ref = split.subcycle_phase(sp_ref, grid, cfg)
    got = fused_fb.split_subcycle(sp_ref, st.h, st.u, st.v, statics, cfg)
    torch.cuda.synchronize()
    agree(f"K1s subcycle {tag} vs plain", got, sub_ref, None)
    got = fused_fb.split_recompose(sp_ref, sub_ref, st.h, st.u, st.v,
                                   statics, st.t, cfg)
    torch.cuda.synchronize()
    ref = _recompose_plain(sp_ref, sub_ref, st, grid, forcing, cfg)
    err_r = agree(f"K1s recompose {tag} (layer-streamed) vs plain", got,
                  (ref.h, ref.u, ref.v), None)
    if timed:
        slow = lambda: fused_fb.split_slow(st.h, st.u, st.v, statics, cfg)
        rec = lambda: fused_fb.split_recompose(sp_ref, sub_ref, st.h, st.u,
                                               st.v, statics, st.t, cfg)
        ms_s = time_pair(f"K1s slow {tag} (layer-streamed)",
                         lambda: split.slow_phase(st, grid, forcing, cfg),
                         slow, 2, 10)
        ms_r = time_pair(f"K1s recompose {tag} (layer-streamed, both "
                         "launches)", lambda: _recompose_plain(
                             sp_ref, sub_ref, st, grid, forcing, cfg), rec,
                         2, 10)
        dev_ms = device_ms(f"K1s {tag}", lambda: (slow(), rec()), 5,
                           {"split_slow_layers_kernel": 1,
                            "split_rec_h_layers_kernel": 1,
                            "split_rec_uv_layers_kernel": 1})
        out["split_slow"] = (err_s, ms_s, dev_ms["split_slow_layers_kernel"])
        out["split_recompose"] = (err_r, ms_r, dev_ms)
    del sp_ref, sub_ref, got, ref
    args = (st.h, st.u, st.v, statics, 0, st.t, cfg, 1)
    got = fused_fb.fused_fb_step(*args)
    torch.cuda.synchronize()
    agree(f"K1s step {tag} vs plain", got,
          fused_fb.fused_fb_step_plain(*args), None)
    del statics, grid, forcing, st
    torch.cuda.empty_cache()

    # K3a / K3b under the implicit free surface, both parities
    cfg, grid, forcing, st = layers_case(dev, 30, nz, dtype, n,
                                         scheme="implicit_fs",
                                         precond="jacobi")
    statics = (grid, forcing)
    ph = fp.Phases(grid, forcing, cfg)
    print(f"   K3a / K3b {tag}: {ph.plan.describe()}")
    if not (ph.plan.stream_a and ph.plan.stream_b):
        raise AssertionError(f"K3a / K3b {tag} are not layer-streamed")
    p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=dev) * grid.mask
    # div's layer sum: the kernel adds the layers from the surface, the
    # plain version's torch.sum in an order of its own past two layers,
    # so div is held within 4 ulp (f32) / 1e-12 (f64) of its scale
    near = (4 * 2.0 ** -23 if dtype == "float32" else 1e-12)
    for par in (0, 1):
        a = ph.a(st.h, st.u, st.v, par)
        a_ref = fp.proj_a_plain(st.h, st.u, st.v, statics, par, cfg)
        b = ph.b(st.h, a_ref[0], a_ref[1], p, st.t)
        b_ref = fp.proj_b_plain(st.h, a_ref[0], a_ref[1], p, statics, st.t,
                                cfg)
        torch.cuda.synchronize()
        err_a = max(agree(f"K3a u*, v* {tag} n={par} vs plain", a[:2],
                          a_ref[:2], None),
                    agree(f"K3a div {tag} n={par} vs plain", a[2:],
                          a_ref[2:], lambda r: near * float(
                              r.abs().max())))
        err_b = agree(f"K3b {tag} n={par} vs plain", b, b_ref, None)
    if timed or timed_proj:
        ms_a = time_pair(
            f"K3a {tag} (layer-streamed)",
            lambda: fp.proj_a_plain(st.h, st.u, st.v, statics, 0, cfg),
            lambda: ph.a(st.h, st.u, st.v, 0), 2, 10)
        ms_b = time_pair(
            f"K3b {tag} (layer-streamed)",
            lambda: fp.proj_b_plain(st.h, a_ref[0], a_ref[1], p, statics,
                                    st.t, cfg),
            lambda: ph.b(st.h, a_ref[0], a_ref[1], p, st.t), 2, 10)
        dev_ms = device_ms(f"K3a / K3b {tag}", lambda: (
            ph.a(st.h, st.u, st.v, 0), ph.b(st.h, a_ref[0], a_ref[1], p,
                                            st.t)), 5,
            {"proj_a_layers_kernel": 1, "proj_b_layers_kernel": 1})
        out["proj_a"] = (err_a, ms_a, dev_ms["proj_a_layers_kernel"])
        out["proj_b"] = (err_b, ms_b, dev_ms["proj_b_layers_kernel"])
    del statics, grid, forcing, st, ph, a, b, a_ref, b_ref
    torch.cuda.empty_cache()

    # K7 on a 2 x 2 mesh of shards of the card against the single-device
    # kernels: the fb step, the split step, the projection phases
    m = pmesh.make_mesh(*MESH28, devices=[dev])
    for scheme, kw in (("fb", {}), ("split", dict(nsub=8)),
                       ("implicit_fs", dict(precond="jacobi"))):
        cfg, grid, forcing, st = layers_case(dev, 31, nz, dtype, n,
                                             scheme=scheme, **kw)
        statics = (grid, forcing)
        K = dist_band.MeshKernels(statics, cfg, m)
        print(f"   K7 {scheme} {tag} on {MESH28}: {K.plan.describe()}")
        if not K.plan.streamed:
            raise AssertionError(f"K7-{scheme} {tag} is not layer-streamed")
        f = [dist_band.stack_global(a, m) for a in (st.h, st.u, st.v)]
        gather = lambda outs: [pmesh.gather(dist_band.unstack(a, m))
                               for a in outs]
        if scheme != "implicit_fs":
            one = lambda: fused_fb.fused_fb_step(st.h, st.u, st.v, statics,
                                                 1, st.t, cfg, 1)
            seven = lambda: K.step(*f, 1, st.t, 1)
            got, ref = seven(), one()
            torch.cuda.synchronize()
            err7 = agree(f"K7-{scheme} {tag} (layer-streamed) vs "
                         f"K1{'s' * (scheme != 'fb')}", gather(got), ref,
                         None)
            if cards:
                step_two_cards(K, statics, cfg, m, f, st.t, got, tag)
            keys = ({"shard_cont_layers_kernel": 1,
                     "shard_mom_layers_kernel": 1, "fb_cont_kernel": 1,
                     "fb_mom_kernel": 1}
                    if scheme == "fb" else
                    {"shard_slow_layers_kernel": 1, "shard_sub_kernel": 1,
                     "shard_rec_h_layers_kernel": 1,
                     "shard_rec_uv_layers_kernel": 1,
                     "split_slow_layers_kernel": 1, "split_sub_kernel": 1,
                     "split_rec_h_layers_kernel": 1,
                     "split_rec_uv_layers_kernel": 1})
            if scheme == "split":
                # each kernel alone, for its row
                t1 = advance_time(st.t, cfg.dt, cfg.npdtype)
                slow7 = K.slow(*f)
                sub7 = K.subcycle(slow7, *f)
                parts = {"slow": lambda: K.slow(*f),
                         "recompose": lambda: K.recompose(slow7, sub7, *f,
                                                          t1)}
        else:
            p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype,
                            device=dev) * grid.mask
            ps = dist_band.stack_global(p, m)
            ph1 = fp.Phases(grid, forcing, cfg)

            def seven():
                a = K.proj_a(*f, 0)
                return a, K.proj_b(f[0], a[0], a[1], ps, st.t)

            def one():
                a = ph1.a(st.h, st.u, st.v, 0)
                return a, ph1.b(st.h, a[0], a[1], p, st.t)

            (a7, b7), (a1, b1) = seven(), one()
            torch.cuda.synchronize()
            err7 = agree(f"K7-proj A {tag} (layer-streamed) vs K3a", gather(
                a7), a1, None)
            agree(f"K7-proj B {tag} (layer-streamed) vs K3b", gather(b7), b1,
                  None)
            if cards:
                proj_two_cards(K, statics, cfg, m, f, ps, st.t, a7, b7, tag)
            keys = {"shard_pal_kernel": 1, "shard_pbl_kernel": 1,
                    "proj_a_layers_kernel": 1, "proj_b_layers_kernel": 1}
            # each phase alone, for its row
            parts = {"A": lambda: K.proj_a(*f, 0),
                     "B": lambda: K.proj_b(f[0], a7[0], a7[1], ps, st.t)}
        timing7 = timed or (timed_proj and scheme == "implicit_fs")
        if timing7:
            ms7 = time_ms(seven, 5)
            ms1 = time_ms(one, 5)
            dev_ms = device_ms(f"K7-{scheme} {tag} and the single-device "
                               "kernels", lambda: (seven(), one()), 5, keys)
            print(f"   K7-{scheme} {tag}: {ms7!r} ms per call between "
                  f"events, the single-device kernels {ms1!r} ms ({smi})")
            if scheme == "fb":
                out["shard_fb"] = (err7, ms7, dev_ms)
            else:
                name = "proj" if scheme == "implicit_fs" else "split"
                for x, fn in parts.items():
                    ms = time_ms(fn, 5)
                    print(f"   K7-{name} {x} {tag} alone: {ms!r} ms between "
                          f"events ({smi})")
                    out[f"shard_{name}_{x.lower()}"] = (err7, ms, dev_ms)
        del K, f, statics, grid, forcing, st
        torch.cuda.empty_cache()
    return out


def two_cards_of(m):
    """The 2 x 2 mesh m of shards of the one card as two cards' stacks
    split along x (the second on a side stream)."""
    from beom_tpu_torch.parallel.mesh import card_groups

    return [dataclasses.replace(c, device=m.devices[0])
            for c in card_groups(["a", "b"] * 2, 2, 2)]


def step_two_cards(K1, statics, cfg, m, one, t, got1, tag):
    """One step of K7-fb or K7-split over two cards' stacks of the one card
    (the build with BEOM_CARDS = 1, two_cards_of), from the one-stack
    route's fields `one`, bit for bit the one-stack route's got1 (K1's
    step); each card's launches of the streamed kernels counted: K7-fb's
    continuity and momentum once per card, K7-split's slow phase once and
    its recomposition's two.  The second card's momentum (velocities)
    launch reads h1 that the first card's continuity launch wrote."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band

    K2 = dist_band.MeshKernels(statics, cfg, m, cards=two_cards_of(m))
    if not K2.plan.streamed:
        raise AssertionError(f"K7-{cfg.scheme} {tag} over two cards is not "
                             "layer-streamed")
    two = [K2.stack(K1.unstack(a, m)) for a in one]
    saved = dict(dist_band.STREAM_LAUNCHES)
    dist_band.STREAM_LAUNCHES.update(dict.fromkeys(saved, 0))
    got2 = K2.step(*two, 1, t, 1)
    torch.cuda.synchronize()
    counts = {k: v for k, v in dist_band.STREAM_LAUNCHES.items() if v}
    dist_band.STREAM_LAUNCHES.update(saved)
    want = {"fb_continuity": 2, "fb_momentum": 2} if cfg.scheme == "fb" \
        else {"split_slow": 2, "split_recompose": 4}
    if counts != want:
        raise AssertionError(f"K7-{cfg.scheme} {tag} over two cards: "
                             f"streamed launches {counts}, want {want}")
    agree(f"K7-{cfg.scheme} {tag}, two cards (BEOM_CARDS) vs one stack",
          [pmesh.gather(K2.unstack(a, m)) for a in got2],
          [pmesh.gather(K1.unstack(a, m)) for a in got1], None)
    print(f"   K7-{cfg.scheme} {tag} over two cards: streamed launches "
          f"{counts}")


def proj_two_cards(K1, statics, cfg, m, one, p1, t, a1, b1, tag):
    """K7-proj over two cards' stacks of the one card (the build with
    BEOM_CARDS = 1, the second card on a side stream), the 2 x 2 mesh m
    split along x: phase A from the one-stack route's fields `one` and
    phase B from its u*, v* and p1, bit for bit the one-stack route's a1,
    b1 (K1's), one launch per card and phase, each counted as
    streamed."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band

    K2 = dist_band.MeshKernels(statics, cfg, m, cards=two_cards_of(m))
    if not K2.plan.streamed:
        raise AssertionError(f"K7-proj {tag} over two cards is not "
                             "layer-streamed")
    two = [K2.stack(K1.unstack(a, m)) for a in one]
    p2 = K2.stack(K1.unstack(p1, m))
    us, vs = (K2.stack(K1.unstack(a, m)) for a in a1[:2])
    saved = dict(dist_band.STREAM_LAUNCHES)
    dist_band.STREAM_LAUNCHES.update(dict.fromkeys(saved, 0))
    a2 = K2.proj_a(*two, 0)
    b2 = K2.proj_b(two[0], us, vs, p2, t)
    torch.cuda.synchronize()
    counts = {k: v for k, v in dist_band.STREAM_LAUNCHES.items() if v}
    dist_band.STREAM_LAUNCHES.update(saved)
    if counts != {"proj_a": 2, "proj_b": 2}:
        raise AssertionError(f"K7-proj {tag} over two cards: streamed "
                             f"launches {counts}")
    g1 = lambda fields: [pmesh.gather(K1.unstack(a, m)) for a in fields]
    g2 = lambda fields: [pmesh.gather(K2.unstack(a, m)) for a in fields]
    agree(f"K7-proj A {tag}, two cards (BEOM_CARDS) vs one stack", g2(a2),
          g1(a1), None)
    agree(f"K7-proj B {tag}, two cards (BEOM_CARDS) vs one stack", g2(b2),
          g1(b1), None)
    print(f"   K7-proj {tag} over two cards: streamed launches {counts}")


def both_routes(dev, smi, nz):
    """Phase 28's last leg: at nz layers (2048^2 f32), where every route
    builds, the routes off shared memory forced by the plans' own
    parameter (fused_fb.plan, split_plan, fused_projection.plan,
    dist_band.mesh_plan: K1, K3a, K3b, the split step, K7-fb and K7-split
    layer-streamed) bit for bit the shared-memory route, each timed beside
    it; and four paths through the forced routes, their kernels' counts
    read from 0: 2 steps of K1 and of the split step, and one each of K7-fb
    and K7-split on 2 x 2 shards of the card, bit for bit the single-device
    kernels on the shared-memory route.  Returns {kernel: (err, ms, device
    ms, launches)} of the forced split kernels (the streamed
    recomposition's device ms by kernel)."""
    import torch

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band, fused_fb
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import split as split_mod

    tag = f"{BIG}^2 f32 nz={nz}"
    out = {}
    for scheme in ("fb", "split"):
        cfg, grid, forcing, st = layers_case(dev, 32, nz, "float32", BIG,
                                             scheme=scheme, nsub=8)
        statics = (grid, forcing)
        args = (st.h, st.u, st.v, statics, 1, st.t, cfg, 1)
        # the split step's plan streams at nz 8 too: the same plan with
        # stream off is its shared-memory route, which fits there
        forced = fused_fb.plan(cfg, cfg.tdtype, 1, True) if scheme == "fb" \
            else fused_fb.split_plan(cfg, cfg.tdtype, True)
        usual = fused_fb.plan(cfg, cfg.tdtype, 1) if scheme == "fb" \
            else dataclasses.replace(fused_fb.split_plan(cfg, cfg.tdtype),
                                     stream=False)
        print(f"   {scheme} {tag}, forced: {forced.describe()}; the plan's: "
              f"{usual.describe()}")
        got = fused_fb.fused_fb_step(*args, pl=forced)
        smem_out = fused_fb.fused_fb_step(*args, pl=usual)
        torch.cuda.synchronize()
        route = "the layer-streamed route"
        agree(f"{scheme} {tag}: {route} vs the shared-memory route",
              got, smem_out, None)
        ms = time_pair(f"{scheme} {tag} shared-memory route (as 'plain') vs "
                       f"{route}", lambda: fused_fb.fused_fb_step(
                           *args, pl=usual), lambda: fused_fb.fused_fb_step(
                           *args, pl=forced), 10, 10, unit="step")
        if scheme == "fb":
            # the forced route's path: 2 steps, the counts from 0
            saved = dict(fused_fb.STREAM_LAUNCHES)
            fused_fb.STREAM_LAUNCHES.update(dict.fromkeys(saved, 0))
            fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0, st.t, cfg,
                                   2, pl=forced)
            torch.cuda.synchronize()
            counts = dict(fused_fb.STREAM_LAUNCHES)
            fused_fb.STREAM_LAUNCHES.update(saved)
            print(f"   fb {tag}, 2 steps on the forced route: launches "
                  f"{counts}")
            if counts != {**dict.fromkeys(counts, 0), "fb_continuity": 2,
                          "fb_momentum": 2}:
                raise AssertionError(f"the forced fb path: {counts}")
            # K7-fb on the forced route: one step on 2 x 2 shards of the
            # card, its streamed launches counted from 0, bit for bit the
            # single-device K1 on the shared-memory route (`smem_out`)
            m = pmesh.make_mesh(*MESH28, devices=[dev])
            K = dist_band.MeshKernels(statics, cfg, m, pl=dist_band.mesh_plan(
                cfg, cfg.tdtype, m, True))
            print(f"   K7-fb {tag} on {MESH28}, forced: {K.plan.describe()}")
            f = [dist_band.stack_global(a, m) for a in (st.h, st.u, st.v)]
            saved = dict(dist_band.STREAM_LAUNCHES)
            dist_band.STREAM_LAUNCHES.update(dict.fromkeys(saved, 0))
            seven = K.step(*f, 1, st.t, 1)
            torch.cuda.synchronize()
            counts7 = {k: v for k, v in dist_band.STREAM_LAUNCHES.items()
                       if v}
            dist_band.STREAM_LAUNCHES.update(saved)
            print(f"   K7-fb {tag}, 1 step on the forced route: streamed "
                  f"launches {counts7}")
            if counts7 != {"fb_continuity": 1, "fb_momentum": 1}:
                raise AssertionError(f"the forced K7-fb path: {counts7}")
            agree(f"K7-fb {tag} (layer-streamed) vs K1 (shared-memory "
                  "route)", [pmesh.gather(dist_band.unstack(a, m))
                             for a in seven], smem_out, None)
            del K, f, seven
        if scheme == "split":
            # the forced route's path: 2 steps, the counts from 0
            saved = dict(fused_fb.STREAM_LAUNCHES)
            fused_fb.STREAM_LAUNCHES.update(dict.fromkeys(saved, 0))
            fused_fb.fused_fb_step(st.h, st.u, st.v, statics, 0, st.t, cfg,
                                   2, pl=forced)
            torch.cuda.synchronize()
            counts = dict(fused_fb.STREAM_LAUNCHES)
            fused_fb.STREAM_LAUNCHES.update(saved)
            print(f"   split {tag}, 2 steps on the forced route: streamed "
                  f"launches {counts}")
            if counts != {"fb_continuity": 0, "fb_momentum": 0,
                          "split_slow": 2, "split_tend": 0,
                          "split_recompose": 2}:
                raise AssertionError(f"the forced split path: {counts}")
            sp_ref = split_mod.slow_phase(st, grid, forcing, cfg)
            sub_ref = split_mod.subcycle_phase(sp_ref, grid, cfg)
            slow = lambda: fused_fb.split_slow(st.h, st.u, st.v, statics,
                                               cfg, forced)
            rec = lambda: fused_fb.split_recompose(
                sp_ref, sub_ref, st.h, st.u, st.v, statics, st.t, cfg,
                forced)
            err_s = agree(f"K1s slow {tag} (layer-streamed) vs plain",
                          slow(), sp_ref, None)
            ref = _recompose_plain(sp_ref, sub_ref, st, grid, forcing, cfg)
            err_r = agree(f"K1s recompose {tag} (layer-streamed) vs plain",
                          rec(), (ref.h, ref.u, ref.v), None)
            # each forced kernel bit for bit the shared-memory route's
            shared = usual
            agree(f"K1s slow {tag}: the layer-streamed route vs the "
                  "shared-memory route", slow(), fused_fb.split_slow(
                      st.h, st.u, st.v, statics, cfg, shared), None)
            agree(f"K1s recompose {tag}: the layer-streamed route vs the "
                  "shared-memory route", rec(), fused_fb.split_recompose(
                      sp_ref, sub_ref, st.h, st.u, st.v, statics, st.t, cfg,
                      shared), None)
            ms_s = time_pair(f"K1s slow {tag} (layer-streamed)",
                             lambda: split_mod.slow_phase(st, grid, forcing,
                                                          cfg), slow, 3, 10)
            ms_r = time_pair(f"K1s recompose {tag} (layer-streamed, both "
                             "launches)",
                             lambda: _recompose_plain(sp_ref, sub_ref, st,
                                                      grid, forcing, cfg),
                             rec, 3, 10)
            dev_ms = device_ms(f"K1s slow / recompose {tag} (layer-streamed)",
                               lambda: (slow(), rec()), 5,
                               {"split_slow_layers_kernel": 1,
                                "split_rec_h_layers_kernel": 1,
                                "split_rec_uv_layers_kernel": 1})
            out["split_slow"] = (err_s, ms_s,
                                 dev_ms["split_slow_layers_kernel"],
                                 counts["split_slow"])
            out["split_recompose"] = (
                err_r, ms_r, {k: v for k, v in dev_ms.items()
                              if "rec" in k},
                counts["split_recompose"])
            # K7-split on the forced route (the plan's here): one step on
            # 2 x 2 shards of the card, its streamed launches counted from
            # 0, bit for bit the single-device K1s on the shared-memory
            # route (`smem_out`)
            m = pmesh.make_mesh(*MESH28, devices=[dev])
            K = dist_band.MeshKernels(statics, cfg, m, pl=dist_band.mesh_plan(
                cfg, cfg.tdtype, m, True))
            print(f"   K7-split {tag} on {MESH28}, forced: "
                  f"{K.plan.describe()}")
            f = [dist_band.stack_global(a, m) for a in (st.h, st.u, st.v)]
            saved = dict(dist_band.STREAM_LAUNCHES)
            dist_band.STREAM_LAUNCHES.update(dict.fromkeys(saved, 0))
            seven = K.step(*f, 1, st.t, 1)
            torch.cuda.synchronize()
            counts7 = {k: v for k, v in dist_band.STREAM_LAUNCHES.items()
                       if v}
            dist_band.STREAM_LAUNCHES.update(saved)
            print(f"   K7-split {tag}, 1 step on the forced route: streamed "
                  f"launches {counts7}")
            if counts7 != {"split_slow": 1, "split_recompose": 2}:
                raise AssertionError(f"the forced K7-split path: {counts7}")
            err7 = agree(f"K7-split {tag} (layer-streamed) vs K1s "
                         "(shared-memory route)",
                         [pmesh.gather(dist_band.unstack(a, m))
                          for a in seven], smem_out, None)
            t1 = st.t + cfg.npdtype.type(cfg.dt)
            slow7 = K.slow(*f)
            sub7 = K.subcycle(slow7, *f)
            slow7_fn = lambda: K.slow(*f)
            rec7_fn = lambda: K.recompose(slow7, sub7, *f, t1)
            ms7 = (time_ms(slow7_fn, 10), time_ms(rec7_fn, 10))
            dev7 = device_ms(f"K7-split slow / recompose {tag} "
                             "(layer-streamed)",
                             lambda: (slow7_fn(), rec7_fn()), 5,
                             {"shard_slow_layers_kernel": 1,
                              "shard_rec_h_layers_kernel": 1,
                              "shard_rec_uv_layers_kernel": 1})
            print(f"   K7-split {tag} (layer-streamed): slow {ms7[0]!r} ms, "
                  f"recompose {ms7[1]!r} ms between events ({smi})")
            out["shard_split_slow"] = (err7, (ms7[0], ms_s[1]), dev7,
                                       counts7["split_slow"])
            out["shard_split_recompose"] = (
                err7, (ms7[1], ms_r[1]),
                {k: v for k, v in dev7.items() if "rec" in k},
                counts7["split_recompose"])
            del K, f, seven, slow7, sub7
        del statics, grid, forcing, st
        torch.cuda.empty_cache()
    cfg, grid, forcing, st = layers_case(dev, 33, nz, "float32", BIG,
                                         scheme="implicit_fs",
                                         precond="jacobi")
    forced = fp.Phases(grid, forcing, cfg,
                       phase_plan=fp.plan(cfg, cfg.tdtype, True))
    usual = fp.Phases(grid, forcing, cfg,
                      phase_plan=fp.PhasePlan(None, None, False))
    print(f"   K3a / K3b {tag}, forced: {forced.plan.describe()}; beside "
          f"the single-step kernels of the shared-memory route")
    if not (forced.plan.stream_a and forced.plan.stream_b):
        raise AssertionError(f"K3a / K3b {tag} forced are not "
                             "layer-streamed")
    p = torch.randn(cfg.ny, cfg.nx, dtype=st.h.dtype, device=dev) * grid.mask
    for par in (0, 1):
        a, a1 = forced.a(st.h, st.u, st.v, par), usual.a(st.h, st.u, st.v,
                                                         par)
        b = forced.b(st.h, a1[0], a1[1], p, st.t)
        b1 = usual.b(st.h, a1[0], a1[1], p, st.t)
        torch.cuda.synchronize()
        agree(f"K3a {tag} n={par}: the layer-streamed route vs the "
              "shared-memory route", a, a1, None)
        agree(f"K3b {tag} n={par}: the layer-streamed route vs the "
              "shared-memory route", b, b1, None)
    time_pair(f"K3a {tag} shared-memory route (as 'plain') vs the "
              "layer-streamed route", lambda: usual.a(st.h, st.u, st.v, 0),
              lambda: forced.a(st.h, st.u, st.v, 0), 10, 10)
    time_pair(f"K3b {tag} shared-memory route (as 'plain') vs the "
              "layer-streamed route", lambda: usual.b(st.h, a1[0], a1[1], p,
                                                      st.t),
              lambda: forced.b(st.h, a1[0], a1[1], p, st.t), 10, 10)
    del forced, usual, grid, forcing, st
    torch.cuda.empty_cache()
    return out


def layers_paths(dev, smi):
    """Phase 28's paths at 2048^2 f32 on the shelf with LAYERS28 layers and
    TIDES28 constituents, each driven with the kernels' counts set to 0
    just before and read just after: run() with backend='fused' (fb, 100
    steps, diagnostics every 50: K1 layer-streamed, its two kernels once
    per step), run() of the split scheme (nsub 8, 10 steps, diagnostics
    every 5: K1s's layer-streamed slow phase and recomposition, four
    launches per step), run() of the implicit free surface (3 steps: K3a
    and K3b layer-streamed around K6), and the three paths again on a 2 x
    2 mesh of shards of the card (K7-fb's two streamed kernels once per
    step, K7-split's slow phase once and its recomposition's two,
    K7-proj's phases layer-streamed; the fb and split runs' diagnostics
    lines those of the single-device runs); and the implicit free surface
    at N28_F64^2 f64 with LAYERS28_F64 layers, on one device and on 2 x 2
    shards (3 steps each).  Returns the counts by path."""
    import torch

    from beom_tpu_torch.parallel import dist
    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.run import run
    from beom_tpu_torch.stencils import (cg_fused, dist_band, fused_fb,
                                         mesh_solve)
    from beom_tpu_torch.stencils import fused_projection as fp
    from beom_tpu_torch.stepping import prepare_state

    counts, logs = {}, {}
    f32 = (LAYERS28, "float32", BIG)
    f64 = (LAYERS28_F64, "float64", N28_F64)
    for label, scheme, kw, n_steps, (nz, dtype, n) in (
            ("fb", "fb", {}, 100, f32),
            ("split", "split", dict(nsub=8), 10, f32),
            ("implicit FS", "implicit_fs", dict(precond="jacobi"), 3, f32),
            ("fb on 2 x 2 shards", "fb", dict(mesh_y=2, mesh_x=2), 100, f32),
            ("split on 2 x 2 shards", "split",
             dict(nsub=8, mesh_y=2, mesh_x=2), 10, f32),
            ("implicit FS on 2 x 2 shards", "implicit_fs",
             dict(precond="jacobi", mesh_y=2, mesh_x=2), 3, f32),
            ("implicit FS f64", "implicit_fs", dict(precond="jacobi"), 3,
             f64),
            ("implicit FS f64 on 2 x 2 shards", "implicit_fs",
             dict(precond="jacobi", mesh_y=2, mesh_x=2), 3, f64)):
        cfg, grid, forcing, st = layers_case(
            dev, 34, nz, dtype, n, scheme=scheme,
            backend="fused", diag_every=min(50, n_steps // 2), **kw)
        counters = (fused_fb.STREAM_LAUNCHES, fused_fb.SPLIT_LAUNCHES,
                    fp.STREAM_LAUNCHES, dist_band.LAUNCHES,
                    dist_band.STREAM_LAUNCHES)
        saved = [dict(c) for c in counters] + [fused_fb.LAUNCHES,
                                                cg_fused.LAUNCHES]
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        fused_fb.LAUNCHES = cg_fused.LAUNCHES = 0
        log = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(cfg, grid, forcing, st, n_steps, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"K1": fused_fb.LAUNCHES,
               "K1 continuity": fused_fb.STREAM_LAUNCHES["fb_continuity"],
               "K1 momentum": fused_fb.STREAM_LAUNCHES["fb_momentum"],
               "K1s slow": fused_fb.SPLIT_LAUNCHES["slow"],
               "K1s subcycle": fused_fb.SPLIT_LAUNCHES["subcycle"],
               "K1s recompose": fused_fb.SPLIT_LAUNCHES["recompose"],
               "K1s slow stream": fused_fb.STREAM_LAUNCHES["split_slow"],
               "K1s rec stream": fused_fb.STREAM_LAUNCHES["split_recompose"],
               "K3a stream": fp.STREAM_LAUNCHES["proj_a"],
               "K3b stream": fp.STREAM_LAUNCHES["proj_b"],
               "K7-fb continuity":
                   dist_band.STREAM_LAUNCHES["fb_continuity"],
               "K7-fb momentum": dist_band.STREAM_LAUNCHES["fb_momentum"],
               "K7-split subcycle": dist_band.LAUNCHES["split_subcycle"],
               "K7-split slow stream": dist_band.STREAM_LAUNCHES["split_slow"],
               "K7-split rec stream":
                   dist_band.STREAM_LAUNCHES["split_recompose"],
               "K7-proj A stream": dist_band.STREAM_LAUNCHES["proj_a"],
               "K7-proj B stream": dist_band.STREAM_LAUNCHES["proj_b"],
               "K6": cg_fused.LAUNCHES}
        for c, v in zip(counters, saved):
            c.update(v)
        fused_fb.LAUNCHES, cg_fused.LAUNCHES = saved[-2:]
        diags = [json.loads(x) for x in log.getvalue().splitlines()]
        mesh = "mesh_y" in kw
        want = {("fb", False): {"K1": n_steps, "K1 continuity": n_steps,
                                "K1 momentum": n_steps},
                ("split", False): dict.fromkeys(
                    ("K1s slow", "K1s subcycle", "K1s recompose",
                     "K1s slow stream", "K1s rec stream"), n_steps),
                ("implicit_fs", False): {"K3a stream": n_steps,
                                         "K3b stream": n_steps,
                                         "K6": n_steps},
                ("fb", True): {"K7-fb continuity": n_steps,
                               "K7-fb momentum": n_steps},
                ("split", True): {"K7-split subcycle": n_steps,
                                  "K7-split slow stream": n_steps,
                                  "K7-split rec stream": 2 * n_steps},
                ("implicit_fs", True): {"K7-proj A stream": n_steps,
                                        "K7-proj B stream": n_steps,
                                        "K6": n_steps}}[
            scheme, mesh]
        if any(got[k] != v for k, v in want.items()) or any(
                v for k, v in got.items() if k not in want):
            raise AssertionError(f"{label}: launches {got}, want {want}")
        if not diags or any(d["finite"] != 1.0 for d in diags):
            raise AssertionError(f"{label}: diagnostics {diags}")
        if mesh and scheme != "implicit_fs" and dtype == "float32":
            # the shards' run is the single-device run's, line for line
            if log.getvalue() != logs[scheme]:
                raise AssertionError(f"{label}: diagnostics {diags}, not "
                                     "the single-device run's")
            print(f"   run() {label}: diagnostics equal to the "
                  "single-device run's")
        logs.setdefault(scheme, log.getvalue())
        print(f"   run() {label}, {n_steps} steps: launches {got} (the "
              f"plan's: each once per step); diagnostics {diags[-1]}; "
              f"{wall / n_steps * 1e3!r} ms/step wall with the call's "
              f"set-up ({smi})")
        counts[label] = got
        if mesh and scheme == "implicit_fs" and dtype == "float32":
            # the mesh step by its stepper, from the same state: ms per
            # step between events and K6's device time in it
            m = pmesh.make_mesh(2, 2, devices=[dev])
            step = dist.make_dist_stepper(grid, forcing, cfg, m)
            s0 = pmesh.shard_state(prepare_state(st, cfg), m)
            step_ms = time_ms(lambda: step(s0), 5)
            k6_ms = device_ms(f"{label}, a step", lambda: step(s0), 3,
                              {"cg_jacobi_kernel": 1})["cg_jacobi_kernel"]
            route = mesh_solve.describe(cfg, (2, 2), dist.pressure_lam(cfg))
            print(f"   {label}: {step_ms!r} ms/step between events, K6's "
                  f"device time {k6_ms!r} ms of it; the solve: {route} "
                  f"({smi})")
            del step, s0
        del out, grid, forcing, st
        torch.cuda.empty_cache()
    return counts


def layers_phase(dev, smi):
    """Phase 28: every fused kernel at any number of layers and tidal
    constituents; returns the JSON entries of the layer-streamed kernels,
    K7's among them."""
    import torch

    phase(f"28 many layers: the shelf at {BIG}^2 f32 with {LAYERS28} layers "
          f"and {TIDES28} constituents, {N28_F64}^2 f64 with {LAYERS28_F64},"
          f" and both routes at {BIG}^2 f32 nz={BOTH28} ({smi})")
    counts = layers_paths(dev, smi)
    timed = layers_leg(dev, smi, LAYERS28, "float32", BIG, True, cards=True)
    timed64 = layers_leg(dev, smi, LAYERS28_F64, "float64", N28_F64, False,
                         timed_proj=True, cards=True)
    forced = both_routes(dev, smi, BOTH28)
    cfg = layers_case("cpu", 0, LAYERS28, "float32", 16)[0]
    pts = BIG * BIG
    cont, mom = stream_fields(cfg)
    # K1's step, one row: the function is the step, whatever launches the
    # route makes, so its bound is the step's operands once (step_fields);
    # the two kernels' launches, device times and plain parts beside it,
    # and the bytes the two-launch design itself moves (each launch's
    # operands once, h1 read back by the momentum launch)
    own_ms = (cont + mom + cfg.nz) * pts * 4 / HBM_BYTES_PER_S * 1e3
    err, ms, dev_ms = timed["fb_step"]
    labels = {"fb_cont_kernel": "K1 continuity",
              "fb_mom_kernel": "K1 momentum"}
    parts = {kernel: {"launches": counts["fb"][labels[kernel]],
                      "max_abs_err": e, "device_ms": d, "plain_ms": p}
             for kernel, (e, d, p) in timed["fb_parts"].items()}
    entries = [kernel_entry(
        f"fb_step_stream_nz{LAYERS28}", "fb_step.cu", "band.py:200",
        sum(v["launches"] for v in parts.values()), err, ms,
        step_fields(cfg) * pts * 4, 150 * cfg.nz * pts, device=dev_ms,
        extra={"kernels": parts, "design_bytes_ms": own_ms})]
    print(f"   the fb step's bound at nz={LAYERS28} (its operands once): "
          f"{entries[0]['bound_ms']!r} ms; the layer-streamed kernels' own "
          f"bytes, h1 read back by the momentum launch: {own_ms!r} ms")
    # K3a and K3b layer-streamed, and K7-proj's streamed phases on 2 x 2
    # shards, at 2048^2 f32 and 512^2 f64
    entries += proj_stream_rows(cfg, timed, counts["implicit FS"],
                                counts["implicit FS on 2 x 2 shards"], pts,
                                4, "")
    cfg64 = layers_case("cpu", 0, LAYERS28_F64, "float64", 16)[0]
    entries += proj_stream_rows(cfg64, timed64, counts["implicit FS f64"],
                                counts["implicit FS f64 on 2 x 2 shards"],
                                N28_F64 * N28_F64, 8, "_f64")
    cfg32 = layers_case("cpu", 0, LAYERS28, "float32", 16, scheme="split")[0]
    for name, n_fields in split_fields(cfg32).items():
        print(f"   K1s / K7-split {name} at nz={LAYERS28}, route 3: bound "
              f"{n_fields * pts * 4 / HBM_BYTES_PER_S * 1e3!r} ms (bytes)")
    # K1s's layer-streamed slow phase and recomposition (both launches, one
    # row: held to the function's operands once), with the bytes the
    # streamed design itself moves (split_stream_fields)
    entries += split_stream_rows(cfg32, timed, counts["split"], LAYERS28,
                                 pts, "split_step.cu", "band.py:200")
    # K7's rows on 2 x 2 shards: its time between events, the plain
    # version of the same function on the same data (the single-device
    # row's), its kernels' device times and launches, held to the
    # function's bound, the streamed design's own bytes beside it
    err, ms, dev_ms = timed["shard_fb"]
    labels = {"shard_cont_layers_kernel": "K7-fb continuity",
              "shard_mom_layers_kernel": "K7-fb momentum"}
    parts = {k: {"launches": counts["fb on 2 x 2 shards"][lab],
                 "device_ms": dev_ms[k]} for k, lab in labels.items()}
    entries.append(kernel_entry(
        f"shard_step_stream_nz{LAYERS28}", "shard_step.cu", "dist_band.py:63",
        sum(v["launches"] for v in parts.values()), err,
        (ms, timed["fb_step"][1][1]), step_fields(cfg) * pts * 4,
        150 * cfg.nz * pts,
        device=None if any(v["device_ms"] is None for v in parts.values())
        else sum(v["device_ms"] for v in parts.values()),
        extra={"kernels": parts, "design_bytes_ms": own_ms}))
    entries += shard_split_rows(
        cfg32, {k[6:]: (timed[k][0], (timed[k][1], timed[k[6:]][1][1]),
                        timed[k][2]) for k in ("shard_split_slow",
                                               "shard_split_recompose")},
        counts["split on 2 x 2 shards"], LAYERS28, pts)
    # fields moved (split_fields) and operations per point
    cfg8 = layers_case("cpu", 0, BOTH28, "float32", 16, scheme="split")[0]
    entries += split_stream_rows(
        cfg8, {k: v[:3] for k, v in forced.items()},
        {"K1s slow stream": forced["split_slow"][3],
         "K1s rec stream": forced["split_recompose"][3]}, BOTH28,
        pts, "split_step.cu", "band.py:200")
    entries += shard_split_rows(
        cfg8, {k[6:]: forced[k][:3] for k in ("shard_split_slow",
                                              "shard_split_recompose")},
        {"K7-split slow stream": forced["shard_split_slow"][3],
         "K7-split rec stream": forced["shard_split_recompose"][3]}, BOTH28,
        pts)
    torch.cuda.synchronize()
    return entries


def shard_split_rows(cfg, timed, counts, nz, pts):
    """The JSON rows of K7-split's layer-streamed slow phase and
    recomposition on 2 x 2 shards at nz layers: `timed` {"split_slow",
    "split_recompose"}: (err, (ms, plain ms), device ms by kernel name),
    the plain time the single-device row's plain version of the same
    function; each held to its function's bound (split_fields), the
    recomposition's two kernels under its `kernels` key, the design's own
    bytes (split_stream_fields) as `design_bytes_ms`."""
    own = split_stream_fields(cfg)
    rows = []
    err, ms, dev = timed["split_slow"]
    rows.append(kernel_entry(
        f"shard_split_slow_stream_nz{nz}", "shard_split.cu",
        "dist_band.py:63", counts["K7-split slow stream"], err, ms,
        split_fields(cfg)["split_slow"] * pts * 4, 150 * cfg.nz * pts,
        device=dev["shard_slow_layers_kernel"], extra={
            "design_bytes_ms": own["split_slow"] * pts * 4
            / HBM_BYTES_PER_S * 1e3}))
    err, ms, dev = timed["split_recompose"]
    labels = ("shard_rec_h_layers_kernel", "shard_rec_uv_layers_kernel")
    parts = {k: {"launches": counts["K7-split rec stream"] // 2,
                 "device_ms": dev[k]} for k in labels}
    rows.append(kernel_entry(
        f"shard_split_recompose_stream_nz{nz}", "shard_split.cu",
        "dist_band.py:63", counts["K7-split rec stream"], err, ms,
        split_fields(cfg)["split_recompose"] * pts * 4, 40 * cfg.nz * pts,
        device=None if any(dev[k] is None for k in labels) else sum(
            dev[k] for k in labels),
        extra={"kernels": parts, "design_bytes_ms":
               own["split_recompose"] * pts * 4 / HBM_BYTES_PER_S * 1e3}))
    for row in rows:
        print(f"   {row['name']}: bound {row['bound_ms']!r} ms, the "
              f"design's own bytes {row['design_bytes_ms']!r} ms")
    return rows


def pal_fields(cfg):
    """Fields the layer-streamed K3a moves by its design, beyond
    phase_fields' operands once: the three staggered masks and f, which
    the reference's band rebuilds, and under the interfacial drag u and v
    of the layers beside each layer, read again from device memory (4 nz;
    the halo's points come from the L2)."""
    rint = cfg.r_int != 0.0 and cfg.nz > 1
    return phase_fields(cfg)[0] + 4 + 4 * cfg.nz * rint


def proj_stream_rows(cfg, timed, one, mesh, pts, elem, suffix):
    """The JSON rows of the layer-streamed K3a and K3b at cfg.nz layers on
    pts points of `elem` bytes, and of K7-proj's streamed phases on 2 x 2
    shards, from layers_leg's `timed` and the launches of the paths `one`
    (one device) and `mesh` (the shards); each held to its function's
    operands once (phase_fields), K3a with its design's own bytes
    (pal_fields) as `design_bytes_ms`; a K7 row's plain time is the
    single-device row's plain version of the same function."""
    fa, fb_ = phase_fields(cfg)
    nz = cfg.nz
    rows = []
    for key, src, site, count, kernel, n_fields, ops in (
            ("proj_a", "projection.cu", "band.py:200", one["K3a stream"],
             None, fa, 150),
            ("proj_b", "projection.cu", "band.py:200", one["K3b stream"],
             None, fb_, 60),
            ("shard_proj_a", "shard_projection.cu", "dist_band.py:63",
             mesh["K7-proj A stream"], "shard_pal_kernel", fa, 150),
            ("shard_proj_b", "shard_projection.cu", "dist_band.py:63",
             mesh["K7-proj B stream"], "shard_pbl_kernel", fb_, 60)):
        err, ms, dev_ms = timed[key]
        if kernel is not None:
            ms, dev_ms = (ms, timed[key[6:]][1][1]), dev_ms[kernel]
        extra = None
        if key.endswith("proj_a"):
            extra = {"design_bytes_ms": pal_fields(cfg) * pts * elem
                     / HBM_BYTES_PER_S * 1e3}
        rows.append(kernel_entry(
            f"{key}_stream_nz{nz}{suffix}", src, site, count, err, ms,
            n_fields * pts * elem, ops * nz * pts, device=dev_ms,
            extra=extra))
        print(f"   {rows[-1]['name']}: bound {rows[-1]['bound_ms']!r} ms"
              + (f", the design's own bytes {extra['design_bytes_ms']!r} ms"
                 if extra else ""))
    return rows


def split_stream_fields(cfg):
    """Fields K1s's layer-streamed slow phase and recomposition move by
    their design, beyond split_fields' operands once: the slow phase reads
    u and v again and du', dv' back and writes du', dv' twice (6 nz); the
    recomposition writes h1, reads it back and writes it rescaled, reads
    it again for the gates and Flather, and reads u', v' and the three
    masks in both launches (5 nz + 3)."""
    base = split_fields(cfg)
    return {"split_slow": base["split_slow"] + 6 * cfg.nz,
            "split_recompose": base["split_recompose"] + 5 * cfg.nz + 3}


def split_stream_rows(cfg, timed, counts, nz, pts, src, site):
    """The JSON rows of K1s's layer-streamed slow phase and recomposition
    at nz layers from layers_leg's (or both_routes') `timed` results and
    the path's launch counts: each row held to its function's bound
    (split_fields), the recomposition's two kernels under its `kernels`
    key, the design's own bytes as `design_bytes_ms`."""
    own = split_stream_fields(cfg)
    rows = []
    err, ms, dev = timed["split_slow"]
    rows.append(kernel_entry(
        f"split_slow_stream_nz{nz}", src, site, counts["K1s slow stream"],
        err, ms, split_fields(cfg)["split_slow"] * pts * 4,
        150 * cfg.nz * pts, device=dev, extra={
            "design_bytes_ms": own["split_slow"] * pts * 4
            / HBM_BYTES_PER_S * 1e3}))
    err, ms, dev = timed["split_recompose"]
    # each entry call launches both kernels, and counts once
    labels = ("split_rec_h_layers_kernel", "split_rec_uv_layers_kernel")
    parts = {k: {"launches": counts["K1s rec stream"], "device_ms": dev[k]}
             for k in labels}
    rows.append(kernel_entry(
        f"split_recompose_stream_nz{nz}", src, site,
        sum(v["launches"] for v in parts.values()), err, ms,
        split_fields(cfg)["split_recompose"] * pts * 4, 40 * cfg.nz * pts,
        device=None if any(dev[k] is None for k in labels) else sum(
            dev[k] for k in labels),
        extra={"kernels": parts, "design_bytes_ms":
               own["split_recompose"] * pts * 4 / HBM_BYTES_PER_S * 1e3}))
    for row in rows:
        print(f"   {row['name']}: bound {row['bound_ms']!r} ms, the "
              f"design's own bytes {row['design_bytes_ms']!r} ms")
    return rows


def _recompose_plain(sp, sub, st, grid, forcing, cfg):
    """split.recompose followed by fb.finalize, eager."""
    from beom_tpu_torch.stepping import fb, split

    h1, u1, v1 = split.recompose(sp, *sub, st.h, grid, cfg)
    return fb.finalize(h1, u1, v1, st, grid, forcing, cfg)


def cards_only():
    """Phase 27 alone (`python3 chip_smoke.py --cards`), its builds first:
    the quick check of the route over cards while it changes."""
    import torch

    sys.path.insert(0, str(ROOT))
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    from beom_tpu_torch.stencils import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    phase("2 build: the builds of phase 27")
    build.build_all(["halo_pad", "peers"] + sorted(card_specs()))
    cards_phase(torch.device("cuda", torch.cuda.current_device()), smi)


def layers_only():
    """Phase 28 alone (`python3 chip_smoke.py --layers`), its builds first:
    the quick check of the kernels at many layers while they change.
    Prints the phase's kernel rows as one JSON line."""
    import torch

    sys.path.insert(0, str(ROOT))
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    from beom_tpu_torch.stencils import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    phase("2 build: the builds of phase 28")
    specs = ["cg_jacobi"] + sorted(layers_specs())
    for i in range(0, len(specs), 16):
        build.build_all(specs[i:i + 16])
    for item in specs:
        if item[0].startswith("shard_") or "BEOM_STREAM=1" in item[1]:
            # the streamed kernels' registers and spills
            print_build(build, build.label(item))
        else:
            print(f"   {build.label(item)}: {build.BUILD_LOG.get(build.label(item), ('cached',))[0]!r} s")
    print(json.dumps({"kernels": layers_phase(
        torch.device("cuda", torch.cuda.current_device()), smi)}))


def mesh_only():
    """Phases 23 to 25 alone (`python3 chip_smoke.py --mesh`), their shard
    and solver builds first: the quick check of the mesh's paths while
    they change.  Prints the mesh solve's kernel rows as one JSON line."""
    import torch

    sys.path.insert(0, str(ROOT))
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no CUDA card")
    from beom_tpu_torch.stencils import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    phase("2 build: the builds of phases 23 to 25")
    specs = ["cg_jacobi", "cg_fused", "rb_sweep"] + sorted(
        scheme_mesh_specs())
    for i in range(0, len(specs), 16):
        build.build_all(specs[i:i + 16])
    entries = scheme_mesh_phases(
        torch.device("cuda", torch.cuda.current_device()), smi, rel, ulps)
    print(json.dumps({"kernels": [e for e in entries
                                  if e["name"].startswith("mesh_solve")]}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--cards"]:
        cards_only()
        sys.exit(0)
    if sys.argv[1:] == ["--mesh"]:
        mesh_only()
        sys.exit(0)
    if sys.argv[1:] == ["--layers"]:
        layers_only()
        sys.exit(0)
    record = main()
    import torch

    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
