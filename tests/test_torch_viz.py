"""The port's quicklooks (beom_tpu_torch/viz), twin of beom_tpu/viz: the
PNG of the port's quicklook, decoded by matplotlib, equals beom_tpu's
pixel for pixel for the same state at f64, also from a sharded state;
plot_series reads the diag records of the port's run() log; and viz is
the only module of the port that imports matplotlib."""

import ast
import dataclasses
import io
import os
import pkgutil
import subprocess
import sys

import matplotlib.image as mpimg
import numpy as np
import pytest

from beom_tpu.stepping import run_steps as jax_run_steps
from beom_tpu.viz import quicklook as jax_quicklook

import beom_tpu_torch
from beom_tpu_torch.parallel.mesh import make_mesh, shard_pytree
from beom_tpu_torch.run import run
from beom_tpu_torch.viz import plot_series, quicklook

from tests.torch_parity import perturbed_case, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def stepped():
    """A two-layer state 5 steps into a perturbed run, on both sides."""
    (jcfg, jgrid, jforcing, jst), _ = perturbed_case(
        "two_layer", seed=4, nx=32, ny=24, dtype="float64")
    jst = jax_run_steps(jst, jgrid, jforcing, jcfg, 5)
    return (jcfg, jgrid, jforcing, jst), to_port(jcfg, jgrid, jforcing, jst)


@pytest.mark.parametrize("layer", [0, 1])
def test_quicklook_equals_reference_pixel_for_pixel(stepped, tmp_path,
                                                    layer):
    (jcfg, jgrid, _, jst), (cfg, grid, _, st) = stepped
    jax_quicklook(jst, jgrid, jcfg, tmp_path / "ref.png", layer=layer)
    quicklook(st, grid, cfg, tmp_path / "port.png", layer=layer)
    ref = mpimg.imread(tmp_path / "ref.png")
    got = mpimg.imread(tmp_path / "port.png")
    assert got.shape == ref.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got, ref)


def test_quicklook_of_a_sharded_state(stepped, tmp_path):
    """A sharded state and grid are gathered first: the same picture."""
    (jcfg, jgrid, _, jst), (cfg, grid, _, st) = stepped
    mesh = make_mesh(2, 4, devices=["cpu"])
    jax_quicklook(jst, jgrid, jcfg, tmp_path / "ref.png")
    quicklook(shard_pytree(st, mesh), shard_pytree(grid, mesh), cfg,
              tmp_path / "mesh.png")
    np.testing.assert_array_equal(mpimg.imread(tmp_path / "mesh.png"),
                                  mpimg.imread(tmp_path / "ref.png"))


def test_plot_series_reads_a_run_log(stepped, tmp_path):
    """run()'s diag records carry the keys plot_series plots; lines that
    are not JSON are skipped; a log without diag records raises."""
    _, (cfg, grid, forcing, st) = stepped
    cfg = dataclasses.replace(cfg, diag_every=2)
    log = io.StringIO()
    log.write("# a comment line\n")
    run(cfg, grid, forcing, st, 6, log=log)
    p = tmp_path / "run.jsonl"
    p.write_text(log.getvalue())
    plot_series(p, tmp_path / "series.png")
    img = mpimg.imread(tmp_path / "series.png")
    assert img.ndim == 3 and img.shape[0] > 100
    q = tmp_path / "empty.jsonl"
    q.write_text("# nothing\n")
    with pytest.raises(ValueError, match="no diag records"):
        plot_series(q, tmp_path / "none.png")


def test_only_viz_imports_matplotlib():
    """Import every module of the port but viz in a fresh interpreter:
    matplotlib is not loaded (the card's machine has none); and no import
    statement of chip_smoke.py names matplotlib or viz."""
    mods = sorted(m.name for m in pkgutil.walk_packages(
        beom_tpu_torch.__path__, "beom_tpu_torch.")
        if not m.name.startswith("beom_tpu_torch.viz"))
    assert "beom_tpu_torch.entry" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == "
        "'matplotlib']\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    names += [f"{n.module}.{a.name}" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module
              for a in n.names]
    assert "beom_tpu_torch.entry" in names
    bad = [m for m in names if m.split(".")[0] == "matplotlib"
           or m.startswith("beom_tpu_torch.viz")]
    assert not bad, bad
