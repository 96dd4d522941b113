"""The cases two_layer, coastal_wetdry and shelf_forced in the port: the
arrays make_case builds against beom_tpu's, the twins of
tests/test_parity.py's legs against the f64 NumPy oracle and the XLA path,
the plain version of the fused step against beom_tpu's Pallas stepper in
interpret mode as tests/unit/test_pallas.py runs it, the build each case's
kernels get, snapshots crossing the packages, and the CLI."""

import dataclasses
import json

import numpy as np
import pytest

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.io import snapshots as jsnap
from beom_tpu.oracle import oracle_for
from beom_tpu.stencils.fused_fb import make_pallas_stepper
from beom_tpu.stepping import run_steps as j_run_steps

from beom_tpu_torch import convert
from beom_tpu_torch.cases import make_case
from beom_tpu_torch.io import snapshots
from beom_tpu_torch.run import main
from beom_tpu_torch.stencils import dist_band, fused_fb
from beom_tpu_torch.stepping import make_stepper, run_steps

from tests.torch_parity import assert_close, perturbed_case, to_port

NEW_CASES = ["two_layer", "coastal_wetdry", "shelf_forced"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", NEW_CASES)
def test_make_case_equals_reference(name, dtype):
    """Config, Grid, Forcing and State are the reference's bit for bit, at
    the default size and at a size given through nx, ny."""
    for kw in ({}, dict(nx=40, ny=24)):
        jcfg, jgrid, jforcing, jst = jax_make_case(name, dtype=dtype, **kw)
        cfg, grid, forcing, st = make_case(name, dtype=dtype, device="cpu",
                                           **kw)
        d, g, f, s = convert.to_numpy(cfg, grid, forcing, st)
        assert d == dataclasses.asdict(jcfg)
        for arrays, ref in ((g, jgrid), (f, jforcing)):
            for key, a in arrays.items():
                np.testing.assert_array_equal(
                    a, np.asarray(getattr(ref, key)), err_msg=key)
        for key in "huv":
            np.testing.assert_array_equal(s[key],
                                          np.asarray(getattr(jst, key)))
        assert s["h"].dtype == np.dtype(dtype) and st.n == 0 and st.t == 0


@pytest.mark.parametrize("name,n_steps,atol_uv,size", [
    ("two_layer", 300, 1e-10, (32, 32)),
    ("coastal_wetdry", 400, 1e-9, (48, 32)),
    ("shelf_forced", 300, 1e-9, (48, 32)),
])
def test_parity_case(name, n_steps, atol_uv, size):
    """The twins of tests/test_parity.py::test_parity_two_layer,
    _coastal_wetdry and _shelf_forced at f64: within the oracle's envelope
    (h 1e-7, u/v as there) and within 1e-10 relative of the XLA path;
    h >= 0 under wet/dry."""
    jcase = jax_make_case(name, nx=size[0], ny=size[1], dtype="float64")
    jcfg, jgrid, jforcing, jst = jcase
    cfg, grid, forcing, st = to_port(*jcase)
    out = run_steps(st, grid, forcing, cfg, n_steps)
    ref = j_run_steps(jst, jgrid, jforcing, jcfg, n_steps)
    ho, uo, vo = oracle_for(jcfg, jgrid, jforcing).run(
        np.asarray(jst.h), np.asarray(jst.u), np.asarray(jst.v), n_steps)
    np.testing.assert_allclose(out.h.numpy(), ho, rtol=0, atol=1e-7)
    np.testing.assert_allclose(out.u.numpy(), uo, rtol=0, atol=atol_uv)
    np.testing.assert_allclose(out.v.numpy(), vo, rtol=0, atol=atol_uv)
    assert np.abs(uo).max() > 1e-8        # the run did something
    for f in "huv":
        assert_close(getattr(out, f), getattr(ref, f), 1e-10, f)
    if cfg.wetdry:
        assert float(out.h.min()) >= 0.0


def test_shelf_f32_error_is_precision_not_port():
    """ROADMAP fault 3e: the reference's f32 shelf run ends about 2 % off
    the f64 oracle in v, unexplained there.  The f64 control above puts the
    port within 1e-9 of the oracle, so the port's op order is not the
    source.  Here the same 300 steps at f32: the port's distance to the
    reference's f32 run (op-order noise, amplified by the limiter's
    branches) stays below the distance of either f32 run to its own f64
    run (precision growth).  No f32 envelope is pinned."""
    runs = {}
    for dtype in ("float32", "float64"):
        jcase = jax_make_case("shelf_forced", nx=48, ny=32, dtype=dtype)
        cfg, grid, forcing, st = to_port(*jcase)
        runs["port", dtype] = run_steps(st, grid, forcing, cfg, 300)
        runs["ref", dtype] = j_run_steps(jcase[3], *jcase[1:3], jcase[0], 300)

    def dist(a, b, f):
        x = np.asarray(getattr(runs[a], f), np.float64) \
            if a[0] == "ref" else getattr(runs[a], f).double().numpy()
        y = np.asarray(getattr(runs[b], f), np.float64) \
            if b[0] == "ref" else getattr(runs[b], f).double().numpy()
        return float(np.abs(x - y).max())

    for f in "huv":
        port_vs_ref = dist(("port", "float32"), ("ref", "float32"), f)
        precision = max(dist(("port", "float32"), ("port", "float64"), f),
                        dist(("ref", "float32"), ("ref", "float64"), f))
        assert port_vs_ref <= 4.0 * precision + 1e-12, (f, port_vs_ref,
                                                        precision)


@pytest.mark.parametrize("name,n_steps,atol_scale", [
    ("two_layer", 3, 1e-12),
    ("coastal_wetdry", 3, 1e-11),
    ("shelf_forced", 4, 1e-12),
])
def test_plain_matches_pallas_interpret(name, n_steps, atol_scale):
    """The plain version of the fused fb step against the Pallas stepper at
    128x96 with by=48 in interpret mode, the legs
    test_pallas_fb_parity_2layer, _wetdry and _shelf_obc_tides_sponge of
    tests/unit/test_pallas.py with their bounds, atol_scale x max(scale,
    1) (the wet/dry leg's is 1e-11 there too), from a perturbed state."""
    (jcfg, jgrid, jforcing, jst), (cfg, grid, forcing, st) = perturbed_case(
        name, nx=128, ny=96, dtype="float64", seed=14)
    jstep = make_pallas_stepper(jgrid, jforcing, jcfg, by=48, bx=64,
                                interpret=True)
    for _ in range(n_steps):
        jst = jstep(jst)
    out = fused_fb.fused_fb_step(st.h, st.u, st.v, (grid, forcing), st.n,
                                 st.t, cfg, n_steps)
    for f, a in zip("huv", out):
        ref = np.asarray(getattr(jst, f))
        np.testing.assert_allclose(
            a.numpy(), ref, rtol=0,
            atol=atol_scale * max(np.abs(ref).max(), 1.0), err_msg=f)


@pytest.mark.parametrize("scheme", ["fb", "split"])
@pytest.mark.parametrize("name", NEW_CASES)
def test_fused_stepper_runs_case(name, scheme):
    """backend='fused' takes every case under fb and split: 4 steps in one
    pass equal 4 eager steps bit for bit on CPU tensors, and no kernel is
    launched there."""
    cfg, grid, forcing, st = make_case(name, nx=40, ny=24, dtype="float64",
                                       device="cpu", scheme=scheme, nsub=4)
    before = (fused_fb.LAUNCHES, dict(fused_fb.SPLIT_LAUNCHES))
    out = make_stepper(grid, forcing, dataclasses.replace(
        cfg, backend="fused", steps_per_pass=4))(st)
    ref = run_steps(st, grid, forcing, cfg, 4)
    assert out.n == 4 and out.t == ref.t
    for f in "huv":
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      getattr(ref, f).numpy())
    assert (fused_fb.LAUNCHES, fused_fb.SPLIT_LAUNCHES) == before


# the compile-time switches each case's kernels are built with
SWITCHES = {
    "double_gyre": dict(NZ=1),
    "two_layer": dict(NZ=2),
    "coastal_wetdry": dict(NZ=1, WETDRY=1, CDBOT=1),
    "shelf_forced": dict(NZ=2, WETDRY=1, OBC=1, SPONGE=1, NTIDE=1, CDBOT=1),
}


@pytest.mark.parametrize("scheme", ["fb", "split"])
@pytest.mark.parametrize("name", list(SWITCHES))
def test_build_spec_of_case(name, scheme):
    """The source and the -D switches of a case's build: only what the
    case turns on, and the largest tile at both precisions."""
    cfg = make_case(name, nx=16, ny=16, device="cpu", scheme=scheme)[0]
    for dtype in ("float32", "float64"):
        source, defines = fused_fb.build_spec(
            dataclasses.replace(cfg, dtype=dtype))
        assert source == ("fb_step" if scheme == "fb" else "split_step")
        got = {d.split("=")[0][5:]: int(d.split("=")[1]) for d in defines}
        want = dict(NZ=1, WETDRY=0, OBC=0, SPONGE=0, NTIDE=0, NU4=0, CDBOT=0,
                    RINT=0, TX=32, TY=16)
        if scheme == "split":       # the subcycle's substeps and its tile,
            # and the geometry of the two-launch step's tail
            pl = fused_fb.split_plan(dataclasses.replace(cfg, dtype=dtype))
            want.update(NSUB=8, SX=64 if dtype == "float32" else 32, SY=32,
                        QX=pl.qx, QS=pl.qs, QP=pl.qp)
        want.update(SWITCHES[name])
        assert got == want


def test_shared_memory_picks_the_tile():
    """smem_bytes counts the kernels' planes; a configuration too large
    for the first tile gets a smaller one, one too large for the last
    streams its layers (K1, and the shard kernels by the same build
    switches: planes of one layer in shared memory, none in device
    memory), and a subcycle too large for its last tile raises with the
    byte count."""
    cfg = make_case("shelf_forced", nx=16, ny=16, device="cpu", nu4=1e6)[0]
    # 7 nz + 4 + 2 nz + 1 = 23 planes of 42 x 26 points, and the offsets
    assert fused_fb.smem_bytes(cfg, (32, 16), (64, 32), 8)["fb_step"] \
        == 42 * 26 * (23 * 8 + 4)
    # the subcycle: 10 planes of (64 + 2 nsub) x (32 + 2 nsub) points
    assert fused_fb.smem_bytes(cfg, (32, 16), (64, 32), 4)["split_subcycle"] \
        == 10 * 80 * 48 * 4
    wide = dataclasses.replace(cfg, nz=6, rho=(1026.0,) * 6,
                               dtype="float64")
    defines = dict(d.split("=") for d in fused_fb.build_spec(wide)[1])
    assert (defines["BEOM_TX"], defines["BEOM_TY"]) == ("16", "8")
    assert fused_fb.smem_bytes(wide, (32, 8), (64, 32), 8)["fb_step"] \
        > 232448
    fused_fb._TILES, saved = ((32, 16),), fused_fb._TILES
    try:
        defines = dict(d.split("=") for d in fused_fb.build_spec(wide)[1])
        assert defines["BEOM_STREAM"] == "1" and "BEOM_SPILL" not in defines
        name, shard = dist_band.build_spec(wide)
        assert name == "shard_step" and shard == fused_fb.build_spec(wide)[1]
        assert (defines["BEOM_TX"], defines["BEOM_TY"]) == ("32", "16")
        assert fused_fb.single_tile(wide) == ((32, 16), True)
        # one layer's planes: the momentum's 15 of 38 x 22 points (halo 3),
        # the continuity's 11 of 36 x 20 (halo LO = 2), and the offsets
        smem = fused_fb.stream_smem(wide, (32, 16), 8)
        assert smem == {"fb_momentum": 38 * 22 * (15 * 8 + 4),
                        "fb_continuity": 36 * 20 * (11 * 8 + 4)}
    finally:
        fused_fb._TILES = saved
    # nsub = 12 keeps the large tile at f32; nsub = 60 fits no tile
    split = dataclasses.replace(cfg, scheme="split", nsub=12,
                                dtype="float32")
    assert "BEOM_SX=64" in fused_fb.build_spec(split)[1]
    with pytest.raises(NotImplementedError, match="subcycle of nsub = 60"):
        fused_fb.build_spec(dataclasses.replace(split, nsub=60))


@pytest.mark.parametrize("name", NEW_CASES)
def test_snapshot_round_trip_between_packages(name, tmp_path):
    """A snapshot of each new case written by either package loads into
    the other with every field, t and n intact (nz = 2 included)."""
    jcase = jax_make_case(name, nx=24, ny=16, dtype="float64")
    jst = j_run_steps(jcase[3], jcase[1], jcase[2], jcase[0], 3)
    p = jsnap.write_snapshot(str(tmp_path / "ref"), jst)
    st = snapshots.load_state(p, device="cpu")
    assert st.n == 3 and st.t == np.asarray(jst.t)
    assert st.h.shape == (jcase[0].nz, 16, 24)
    q = snapshots.write_snapshot(str(tmp_path / "port"), st)
    back = jsnap.load_state(q)
    assert int(back.n) == 3 and np.asarray(back.t) == st.t
    for f in "huv":
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)))
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jst, f)))
    # and the forcing's OBC, sponge and tide fields cross with convert
    cfg, grid, forcing, _ = to_port(*jcase)
    d, g, f, s = convert.to_numpy(cfg, grid, forcing, st)
    again = convert.from_reference(d, g, f, s, "cpu")
    for field in dataclasses.fields(forcing):
        np.testing.assert_array_equal(
            getattr(again[2], field.name).numpy(),
            np.asarray(getattr(jcase[2], field.name)), err_msg=field.name)


@pytest.mark.parametrize("name", NEW_CASES + ["double_gyre"])
def test_cli_runs_case_and_split(name, capfd):
    """python -m beom_tpu_torch.run <case> with fb and with
    --set scheme=split --set backend=fused, on the CPU because asked."""
    size = ["--set", "nx=24", "--set", "ny=16", "--set", "diag_every=2",
            "--device", "cpu"]
    main([name, "-n", "2"] + size)
    main([name, "-n", "2", "--set", "scheme=split", "--set", "nsub=4",
          "--set", "backend=fused"] + size)
    diags = [json.loads(line) for line in capfd.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [d["n"] for d in diags] == [2, 2]
    assert all(d["finite"] == 1.0 for d in diags)
