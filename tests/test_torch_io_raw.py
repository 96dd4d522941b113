"""The port's raw snapshots, async writer and load_toml
(beom_tpu_torch/io/snapshots.py, io/native.py, io/config.py): twins of
tests/unit/test_io.py's TOML and raw-binary tests and of
tests/unit/test_native_io.py, plus raw files carried across the two
packages both ways (bit for bit, states carried by convert), a sharded
state written as the global file, and the writer's copy of a buffer that
is freed right after submit."""

import dataclasses
import gc
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.io import snapshots as jsnap

from beom_tpu_torch.cases import make_case
from beom_tpu_torch.io import config as ioconfig
from beom_tpu_torch.io import native, snapshots
from beom_tpu_torch.parallel.mesh import make_mesh, shard_state
from beom_tpu_torch.stepping import run_steps

from tests.torch_parity import perturb, to_port


def test_toml_roundtrip(tmp_path):
    p = tmp_path / "cfg.toml"
    p.write_text('nx = 64\nny = 32\ndt = 150.0\nscheme = "split"\n'
                 'nsub = 4\nrho = [1026.0, 1027.5]\nnz = 2\n')
    cfg = ioconfig.load_toml(p)
    assert (cfg.nx, cfg.ny, cfg.dt, cfg.scheme, cfg.nsub) == \
        (64, 32, 150.0, "split", 4)
    assert cfg.rho == (1026.0, 1027.5)


def test_toml_unknown_key(tmp_path):
    p = tmp_path / "cfg.toml"
    p.write_text("bogus = 1\n")
    with pytest.raises(KeyError, match="bogus"):
        ioconfig.load_toml(p)


def test_toml_case_and_overrides_match_reference(tmp_path):
    """`case = "<name>"` starts from the case's Config (built on the CPU)
    and the overrides come last: the same Config as beom_tpu's
    load_toml, backend names mapped."""
    from beom_tpu.io import config as jconfig

    p = tmp_path / "cfg.toml"
    p.write_text('case = "two_layer"\nnx = 48\nny = 40\nnu2 = 250.0\n')
    cfg = ioconfig.load_toml(p, overrides=["dtype='float64'", "nsub=6"])
    ref = jconfig.load_toml(p, overrides=["dtype='float64'", "nsub=6"])
    d = dataclasses.asdict(ref)
    d["backend"] = "eager"
    assert dataclasses.asdict(cfg) == d
    assert (cfg.nz, cfg.nx, cfg.ny, cfg.nu2, cfg.nsub) == (2, 48, 40,
                                                           250.0, 6)


def test_raw_binary_roundtrip(tmp_path):
    cfg, grid, forcing, state = make_case("double_gyre", nx=16, ny=12,
                                          dtype="float64", device="cpu")
    out = run_steps(state, grid, forcing, cfg, 5)
    p = tmp_path / "fields.bin"
    snapshots.save_raw(p, out, cfg)
    back = snapshots.load_raw(p, cfg, device="cpu")
    assert torch.equal(back.h, out.h)
    assert torch.equal(back.u, out.u) and torch.equal(back.v, out.v)
    assert back.n == 0 and back.t == 0 and back.t.dtype == np.float64
    # header-free size check: 3 fields x nz*ny*nx x 8 bytes
    assert os.path.getsize(p) == 3 * cfg.nz * cfg.ny * cfg.nx * 8


def test_raw_short_file_raises(tmp_path):
    cfg, _, _, state = make_case("double_gyre", nx=16, ny=12, device="cpu")
    p = tmp_path / "short.bin"
    snapshots.save_raw(p, state, cfg)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 4)
    with pytest.raises(ValueError, match=r"expected 576 values, got 575"):
        snapshots.load_raw(p, cfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_raw_files_cross_packages(tmp_path, dtype):
    """A raw file written by beom_tpu loads bit for bit through the port's
    load_raw, and the port's file through beom_tpu's; both files are
    byte-equal."""
    jcfg, jgrid, jforcing, jst = jax_make_case("two_layer", nx=24, ny=20,
                                               dtype=dtype)
    jst = perturb(jcfg, jgrid, jst, 3)
    cfg, grid, forcing, st = to_port(jcfg, jgrid, jforcing, jst)
    jp, pp = tmp_path / "jax.bin", tmp_path / "port.bin"
    jsnap.save_raw(jp, jst, jcfg)
    snapshots.save_raw(pp, st, cfg)
    assert jp.read_bytes() == pp.read_bytes()
    back = snapshots.load_raw(jp, cfg, device="cpu")
    jback = jsnap.load_raw(pp, jcfg)
    for f in "huv":
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jst, f)))
        np.testing.assert_array_equal(np.asarray(getattr(jback, f)),
                                      getattr(st, f).numpy())
        assert getattr(back, f).dtype == cfg.tdtype


def test_raw_sharded_state_is_the_global_file(tmp_path):
    cfg, grid, forcing, state = make_case("double_gyre", nx=32, ny=16,
                                          dtype="float64", device="cpu")
    out = run_steps(state, grid, forcing, cfg, 3)
    sharded = shard_state(out, make_mesh(2, 4, devices=["cpu"]))
    a, b = tmp_path / "one.bin", tmp_path / "mesh.bin"
    snapshots.save_raw(a, out, cfg)
    snapshots.save_raw(b, sharded, cfg)
    assert a.read_bytes() == b.read_bytes()


needs_gpp = pytest.mark.skipif(not native.available(),
                               reason="g++ toolchain unavailable")


@needs_gpp
def test_native_roundtrip(tmp_path):
    w = native.AsyncWriter()
    arrs = [np.random.default_rng(i).normal(size=(64, 64)).astype("f4")
            for i in range(4)]
    for i, a in enumerate(arrs):
        w.submit(str(tmp_path / f"s{i}.bin"), a)
    w.flush()
    assert w.errors == 0
    for i, a in enumerate(arrs):
        back = np.fromfile(tmp_path / f"s{i}.bin",
                           dtype="f4").reshape(64, 64)
        np.testing.assert_array_equal(back, a)
    w.close()


@needs_gpp
def test_native_error_counting(tmp_path):
    w = native.AsyncWriter()
    w.submit(str(tmp_path / "no_such_dir" / "x.bin"),
             np.zeros(4, dtype="f4"))
    w.flush()
    assert w.errors == 1
    w.close()


@needs_gpp
def test_save_raw_async(tmp_path):
    cfg, grid, forcing, state = make_case("double_gyre", nx=16, ny=12,
                                          dtype="float64", device="cpu")
    state = state.replace(h=state.h + torch.rand_like(state.h))
    p = tmp_path / "snap.bin"
    with native.AsyncWriter() as w:
        snapshots.save_raw(p, state, cfg, writer=w)
    back = snapshots.load_raw(p, cfg, device="cpu")
    assert torch.equal(back.h, state.h)
    q = tmp_path / "sync.bin"
    snapshots.save_raw(q, state, cfg)
    assert p.read_bytes() == q.read_bytes()


@needs_gpp
def test_native_submit_copies_the_buffer(tmp_path):
    """submit returns with its own copy: each buffer, overwritten and freed
    right after submit (with a queue small enough that submit waits for
    the writer), is written as it was at submit."""
    w = native.AsyncWriter(max_queued_bytes=1 << 20)
    want = []
    for i in range(8):
        buf = np.random.default_rng(i).normal(size=(256, 256))  # 512 KiB
        want.append(buf.copy())
        w.submit(tmp_path / f"b{i}.bin", buf)
        buf[...] = np.nan
        del buf
        gc.collect()
    w.flush()
    assert w.errors == 0
    for i, a in enumerate(want):
        np.testing.assert_array_equal(
            np.fromfile(tmp_path / f"b{i}.bin").reshape(a.shape), a)
    w.close()


def test_async_writer_raises_without_library(monkeypatch):
    """No fallback: a writer whose library cannot be built raises."""
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="snapwriter unavailable"):
        native.AsyncWriter()


def test_native_builds_into_build_dir():
    """The library comes from the port's own source into build/native/;
    nothing is built under native/."""
    repo = Path(__file__).resolve().parents[1]
    assert native._SRC == repo / "beom_tpu_torch" / "csrc" / "snapwriter.cpp"
    assert native._SO.parent == repo / "build" / "native"
