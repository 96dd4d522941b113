"""Guards of the port: it never imports jax, and its root exports what
beom_tpu's does and builds nothing; the fused fb / split step
takes every term and refuses only the projection schemes and what exceeds
its operand slots; the projection phases' config check raises on each term
those kernels lack; every case and scheme builds; an unknown case raises;
the projection configurations that use multigrid build; and the CLI
refuses --device cuda where there is no card."""

import dataclasses
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import beom_tpu_torch
from beom_tpu_torch.cases import make_case
from beom_tpu_torch.core.config import Config
from beom_tpu_torch.run import main, run
from beom_tpu_torch.stencils.fused_fb import check_config
from beom_tpu_torch.stencils.fused_projection import (
    check_config as projection_check, make_fused_projection_stepper)
from beom_tpu_torch.stepping import get_step, prepare_state, projection

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_module_imports_jax():
    """Import every module of the package in a fresh interpreter: neither
    jax nor beom_tpu may be loaded."""
    mods = sorted(m.name for m in pkgutil.walk_packages(
        beom_tpu_torch.__path__, "beom_tpu_torch."))
    assert "beom_tpu_torch.stencils.fused_fb" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'beom_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_root_exports_and_imports_no_jax():
    """The package root exports what beom_tpu's does (Config,
    default_config, Grid, make_grid, State, init_state); importing it in a
    fresh interpreter loads neither jax nor beom_tpu and builds no
    kernel."""
    kernels = os.path.join(REPO, "build", "kernels")

    def built():
        return sorted(os.listdir(kernels)) if os.path.isdir(kernels) else []

    before = built()
    code = (
        "import sys\n"
        "import beom_tpu_torch as b\n"
        "names = ('Config', 'default_config', 'Grid', 'make_grid', "
        "'State', 'init_state')\n"
        "assert all(hasattr(b, n) for n in names)\n"
        "assert b.default_config(nx=64).nx == 64\n"
        "assert b.default_config() == b.Config()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'beom_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    assert built() == before
    for name in ("Config", "default_config", "Grid", "make_grid", "State",
                 "init_state"):
        assert getattr(beom_tpu_torch, name).__module__.startswith(
            "beom_tpu_torch.core")


# the terms of the eager step, which every fused kernel takes
TERMS = {
    "wetdry": dict(wetdry=True),
    "obc": dict(obc=True),
    "sponge": dict(sponge=True),
    "tides": dict(tides=(1.4e-4,)),
    "nu4": dict(nu4=1e9),
    "cd_bot": dict(cd_bot=2.5e-3),
    "r_int": dict(r_int=1e-4),
    "nz > 1": dict(nz=2, rho=(1026.0, 1027.5)),
    "scheme": dict(scheme="split"),
}
BASE = Config(wind=True, nu2=300.0, r_bot=1e-3, beta=2e-11)


@pytest.mark.parametrize("term", list(TERMS))
def test_kernel_config_check_accepts(term):
    """check_config refuses none of the terms of the eager step, alone or
    all together, under fb and split."""
    check_config(BASE)
    check_config(dataclasses.replace(BASE, adv_scheme="linear", slip="no"))
    check_config(dataclasses.replace(BASE, **TERMS[term]))
    every = {k: v for t in TERMS.values() for k, v in t.items()}
    check_config(dataclasses.replace(BASE, **every))


@pytest.mark.parametrize("kw,match", [
    (dict(scheme="rigid_lid"), "fused_projection"),
    (dict(scheme="implicit_fs"), "fused_projection"),
    (dict(nz=9, rho=(1027.0,) * 9), None),
    (dict(obc=True, tides=(1e-4,) * 9), None),
])
def test_kernel_config_check_raises(kw, match):
    """What the fused step cannot run: the projection schemes.  Nine
    layers and nine constituents (match None) it accepts: its scalar
    slots are sized by the build, and the plans leave shared memory (K1
    and the split step layer-streamed, on one device and on the shards)
    where no tile fits."""
    cfg = dataclasses.replace(BASE, **kw)
    if match is None:
        check_config(cfg)
        return
    with pytest.raises(NotImplementedError, match=match):
        check_config(cfg)


def test_unknown_case_raises():
    with pytest.raises(KeyError, match="unknown case"):
        make_case("no_such_case", device="cpu")


@pytest.mark.parametrize("scheme", ["fb", "split", "rigid_lid",
                                    "implicit_fs"])
@pytest.mark.parametrize("name", ["double_gyre", "two_layer", "rigid_lid",
                                  "coastal_wetdry", "shelf_forced"])
def test_every_case_and_scheme_steps(name, scheme):
    """make_case builds all five cases and get_step takes all four
    schemes: one eager step of each pair stays finite."""
    cfg, grid, forcing, st = make_case(name, nx=16, ny=16, device="cpu",
                                       dtype="float64", scheme=scheme)
    out = get_step(cfg)(prepare_state(st, cfg), grid, forcing, cfg)
    assert out.n == 1
    for f in "huv":
        assert bool(torch.isfinite(getattr(out, f)).all()), f


# projection configurations that use multigrid
MULTIGRID = {
    "solver=mg rigid_lid": dict(scheme="rigid_lid", solver="mg"),
    "solver=mg implicit_fs": dict(scheme="implicit_fs", solver="mg"),
    "precond=mg": dict(scheme="implicit_fs", precond="mg"),
    "rigid_lid cg auto": dict(scheme="rigid_lid"),
}


@pytest.mark.parametrize("name", list(MULTIGRID))
def test_multigrid_configurations_step(name):
    """get_step, the eager solve and the fused stepper all take them: one
    eager and one fused step at 32^2 agree within 1e-5 x max(scale, 1)
    (the fused tier's gamma schedule differs from the eager W-cycle)."""
    cfg, grid, forcing, st = make_case("rigid_lid", nx=32, ny=32,
                                       device="cpu", **MULTIGRID[name])
    lam = projection.solve_lam(cfg)
    x = projection._solve(grid.H * grid.mask / grid.H.max() - 0.5, grid,
                          cfg, lam=lam)
    assert bool(torch.isfinite(x).all())
    a = get_step(cfg)(st, grid, forcing, cfg)
    b = make_fused_projection_stepper(grid, forcing, cfg)(st)
    for f in "huv":
        ref = getattr(a, f)
        err = float((getattr(b, f) - ref).abs().max())
        assert err <= 1e-5 * max(float(ref.abs().max()), 1.0), f


@pytest.mark.parametrize("term", [t for t in TERMS if t != "scheme"])
def test_fused_projection_config_check_raises(term):
    base = Config(scheme="implicit_fs", wind=True, nu2=300.0, r_bot=1e-3,
                  beta=2e-11)
    projection_check(base)
    projection_check(dataclasses.replace(base, scheme="rigid_lid",
                                         adv_scheme="linear", slip="no"))
    # the phase kernels take every term of the eager step at any number
    # of layers and constituents; what is left to refuse is another scheme
    projection_check(dataclasses.replace(base, **TERMS[term]))
    every = {k: v for t in TERMS.values() for k, v in t.items()
             if k != "scheme"}
    projection_check(dataclasses.replace(base, **every))
    with pytest.raises(ValueError, match="projection schemes"):
        projection_check(Config())
    projection_check(dataclasses.replace(
        base, nz=9, rho=tuple(1020.0 + k for k in range(9))))
    projection_check(dataclasses.replace(base, obc=True,
                                         tides=(1e-4,) * 9))


def test_mesh_raises():
    """What a mesh run refuses: a mesh whose devices are missing, and a
    halo wider than a shard's block."""
    from beom_tpu_torch.parallel.mesh import make_mesh

    cfg, grid, forcing, st = make_case("double_gyre", nx=16, ny=16,
                                       device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 8 devices, have 0"):
            make_mesh(2, 4)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_mesh(2, 2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="exceeds local block"):
        run(dataclasses.replace(cfg, mesh_x=4), grid, forcing, st, 1)


def test_mesh_kernels_refuse_several_devices():
    """The shard step and the halo pad read the neighbour shards' blocks
    through raw pointers, one launch per card: a mesh over several devices
    must give each device an equal rectangle of shards, and its shards
    must all lie on CUDA cards.  A placement of unequal rectangles raises
    ValueError naming the devices; a mesh that mixes CPU and CUDA shards
    raises ValueError; a mesh on one device is one card."""
    from beom_tpu_torch.parallel.mesh import (Mesh, device_type, make_mesh,
                                              shard)
    from beom_tpu_torch.stencils import dist_band, halo_pad

    one = make_mesh(2, 2, devices=["cpu"])
    assert device_type(one) == "cpu" and len(one.cards) == 1
    cuda = [torch.device("cuda", i) for i in range(3)]
    two = Mesh([cuda[0], cuda[1]] * 2, 2, 2)
    assert [c.shape for c in two.cards] == [(2, 1), (2, 1)]
    uneven = Mesh([cuda[0], cuda[0], cuda[1], cuda[2]], 2, 2)
    with pytest.raises(ValueError, match="different shapes") as err:
        uneven.cards
    assert "cuda:1" in str(err.value)
    scattered = Mesh([cuda[0], cuda[1], cuda[1], cuda[0]], 2, 2)
    with pytest.raises(ValueError, match="not a rectangle") as err:
        scattered.cards
    assert "cuda:0" in str(err.value)
    mixed = Mesh([torch.device("cpu"), cuda[0]] * 2, 2, 2)
    a = shard(torch.zeros(8, 8), one)
    a.mesh = mixed
    for call in (lambda: device_type(mixed),
                 lambda: halo_pad.halo_pad(a, 1),
                 lambda: dist_band.MeshKernels(None, *make_case(
                     "double_gyre", nx=16, ny=16, device="cpu",
                     backend="fused")[:1], mixed)):
        with pytest.raises(ValueError, match="mixes"):
            call()


def test_fused_mesh_paths_take_meshes_over_several_cards():
    """No fused mesh path asks for a mesh on one device: Mesh has no
    single_device, and neither the shard kernels nor the halo pad name
    it."""
    import inspect

    from beom_tpu_torch.parallel import mesh as pmesh
    from beom_tpu_torch.stencils import dist_band, halo_pad

    assert not hasattr(pmesh.Mesh, "single_device")
    for module in (dist_band, halo_pad, pmesh):
        assert "single_device" not in inspect.getsource(module)


def test_cli_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["double_gyre", "-n", "1", "--set", "nx=16", "--set", "ny=16"])
