"""The fused forward-backward step (K1) and its plain PyTorch version.

The CUDA kernel `csrc/fb_step.cu` replaces the TPU kernel
beom_tpu/stencils/band.py::_band_kernel running the body of
beom_tpu/stencils/fused_fb.py::make_pallas_stepper.  One launch advances
one fb_step of (h, u, v); a pass of k = cfg.steps_per_pass steps is k
launches, each with its own FB-Coriolis sweep order (n + i) % 2.

It is bounded by device-memory bytes: a stencil of ~150 flops per point
against 14 fields moved, far below the H100's ratio of operations to
bytes.  The design keeps every intermediate of the step in shared memory:
one CTA per 2-D tile, loaded with a periodic halo on both axes that
covers the step's dependence cone, so a point costs one read of each
operand and one write of each result.  Masks and f_q are streamed as
operands.

`fused_fb_step` runs the kernel on CUDA tensors and the plain version,
`fused_fb_step_plain`, on CPU tensors.  It never falls back from one to
the other: on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from beom_tpu_torch.core.config import Config
from beom_tpu_torch.core.grid import Grid, Forcing
from beom_tpu_torch.core.state import State, advance_time
from beom_tpu_torch.stepping import fb as fb_mod

# kernel launches made by fused_fb_step; a run reads it to show that its
# main path went through the kernel
LAUNCHES = 0

_ENTRY = {torch.float32: "beom_fb_step_f32", torch.float64: "beom_fb_step_f64"}
_STATIC_NAMES = ("H", "mask", "mask_u", "mask_v", "mask_q", "f_q")


def check_config(cfg: Config) -> None:
    """Raise NotImplementedError on any term the kernel lacks."""
    unsupported = [name for name, on in (
        ("wetdry", cfg.wetdry), ("obc", cfg.obc), ("sponge", cfg.sponge),
        ("tides", bool(cfg.tides)), ("nu4", cfg.nu4 != 0.0),
        ("cd_bot", cfg.cd_bot != 0.0), ("r_int", cfg.r_int != 0.0),
        ("nz > 1", cfg.nz != 1), ("scheme != 'fb'", cfg.scheme != "fb"),
    ) if on]
    if unsupported:
        raise NotImplementedError(
            "the fused fb kernel does not implement: "
            + ", ".join(unsupported))


def fused_fb_step_plain(h, u, v, statics, n: int, t, cfg: Config, k: int):
    """k eager fb_steps: the plain PyTorch version of the kernel.

    statics = (grid, forcing).  Returns (h, u, v) after k steps.
    """
    grid, forcing = statics
    s = State(h=h, u=u, v=v, t=t, n=n)
    for _ in range(k):
        s = fb_mod.fb_step(s, grid, forcing, cfg)
    return s.h, s.u, s.v


def _kernel_args(statics):
    grid, forcing = statics
    return [getattr(grid, name) for name in _STATIC_NAMES] + [
        forcing.taux, forcing.tauy]


def _entry(dtype):
    """The kernel's C entry point for `dtype`, built on first use."""
    from beom_tpu_torch.stencils import build

    lib = build.load("fb_step")
    fn = getattr(lib, _ENTRY[dtype])
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = [P] * 14 + [I] * 7 + [D] * 8 + [P]
    fn.restype = I
    return lib, fn


def _launch(h, u, v, statics, parity: int, cfg: Config):
    global LAUNCHES
    from beom_tpu_torch.stencils import build

    lib, fn = _entry(h.dtype)
    outs = [torch.empty_like(h) for _ in range(3)]
    ins = [h, u, v] + _kernel_args(statics)
    code = fn(*[a.data_ptr() for a in ins + outs], cfg.ny, cfg.nx,
              int(parity == 0), int(cfg.adv_scheme == "sadourny_energy"),
              int(cfg.slip == "free"), int(cfg.nu2 != 0.0), int(cfg.wind),
              cfg.dt, 1.0 / cfg.dx, 1.0 / cfg.dy, cfg.gprime[0], cfg.nu2,
              cfg.rho0, cfg.h_min, cfg.r_bot,
              torch.cuda.current_stream(h.device).cuda_stream)
    build.check(lib, code, "fb_step kernel launch")
    LAUNCHES += 1
    return outs


def fused_fb_step(h, u, v, statics, n: int, t, cfg: Config, k: int):
    """Advance (h, u, v) by k fb steps from step n at time t.

    CPU tensors take the plain version.  CUDA tensors take the kernel,
    one launch per step; a config the kernel cannot run raises.
    """
    if h.device.type == "cpu":
        return fused_fb_step_plain(h, u, v, statics, n, t, cfg, k)
    if h.device.type != "cuda":
        raise NotImplementedError(
            f"the fused fb step runs on cuda or cpu, not {h.device.type}")
    check_config(cfg)
    for a in [h, u, v] + _kernel_args(statics):
        if a.device != h.device or a.dtype != h.dtype \
                or not a.is_contiguous() or a.shape[-2:] != (cfg.ny, cfg.nx):
            raise ValueError(
                "fused fb step: every operand must be a contiguous "
                f"{h.dtype} tensor of (.., {cfg.ny}, {cfg.nx}) on {h.device}")
    if h.dtype not in _ENTRY or h.dtype != cfg.tdtype:
        raise ValueError(f"fused fb step: dtype {h.dtype} with cfg.dtype "
                         f"{cfg.dtype}")
    with torch.cuda.device(h.device):
        for i in range(k):
            h, u, v = _launch(h, u, v, statics, (n + i) % 2, cfg)
    return h, u, v


def make_fused_stepper(grid: Grid, forcing: Forcing, cfg: Config):
    """step(state) -> state advancing cfg.steps_per_pass steps in one
    call of the fused step."""
    k = cfg.steps_per_pass
    statics = (grid, forcing)

    def step(state: State) -> State:
        h, u, v = fused_fb_step(state.h, state.u, state.v, statics,
                                state.n, state.t, cfg, k)
        t = state.t
        for _ in range(k):
            t = advance_time(t, cfg.dt, cfg.npdtype)
        return State(h=h, u=u, v=v, t=t, n=state.n + k)

    return step
