"""Guards of the port: it never imports jax; the fused kernel's config
check raises on each term the kernel lacks; the parts not yet ported
raise; and the CLI refuses --device cuda where there is no card."""

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
from beom_tpu_torch.stepping import get_step

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


UNSUPPORTED = {
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


@pytest.mark.parametrize("term", list(UNSUPPORTED))
def test_kernel_config_check_raises(term):
    base = Config(wind=True, nu2=300.0, r_bot=1e-3, beta=2e-11)
    check_config(base)
    check_config(dataclasses.replace(base, adv_scheme="linear", slip="no"))
    with pytest.raises(NotImplementedError, match=term.split()[0]):
        check_config(dataclasses.replace(base, **UNSUPPORTED[term]))


@pytest.mark.parametrize("name", ["two_layer", "coastal_wetdry",
                                  "shelf_forced", "rigid_lid"])
def test_unported_cases_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_case(name, device="cpu")
    with pytest.raises(KeyError, match="unknown case"):
        make_case("no_such_case", device="cpu")


@pytest.mark.parametrize("scheme", ["split", "rigid_lid", "implicit_fs"])
def test_unported_schemes_raise(scheme):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_step(Config(scheme=scheme))


def test_mesh_raises():
    cfg, grid, forcing, st = make_case("double_gyre", nx=16, ny=16,
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        run(dataclasses.replace(cfg, mesh_x=2), grid, forcing, st, 1)


def test_cli_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["double_gyre", "-n", "1", "--set", "nx=16", "--set", "ny=16"])
