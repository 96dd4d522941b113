"""The slice as a whole: beom_tpu_torch.run.run against beom_tpu.run.run
(backend='xla') on the 32x32 double gyre at f64, 122 steps with
diagnostics every 40, so the last chunk of 2 steps runs the pass-and-tail
bookkeeping.  The port runs 'eager' and 'fused' with steps_per_pass=4;
beom_tpu rejects steps_per_pass=4 on a 32-row grid, so its single steps
are the reference.  Tolerance: 1e-10 relative.  Also: resume, the NaN
abort, the CLI, and snapshots loading across both packages."""

import dataclasses
import io
import json
import os

import numpy as np
import pytest

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.io import snapshots as jsnap
from beom_tpu.run import run as jax_run

from beom_tpu_torch.io import config as ioconfig
from beom_tpu_torch.io import snapshots
from beom_tpu_torch.run import InstabilityError, main, run
from beom_tpu_torch.stencils import fused_fb

from tests.torch_parity import assert_close, to_port

REL = 1e-10
N_STEPS = 122


def _diags(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    jcase = jax_make_case("double_gyre", nx=32, ny=32, dtype="float64",
                          diag_every=40)
    log = io.StringIO()
    rd = str(tmp_path_factory.mktemp("jax_run"))
    out = jax_run(*jcase, N_STEPS, run_dir=rd, log=log)
    return jcase, out, _diags(log.getvalue()), rd


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_run_matches_reference(reference, backend, tmp_path):
    jcase, jout, jdiags, _ = reference
    cfg, grid, forcing, st = to_port(*jcase)
    cfg = dataclasses.replace(cfg, backend=backend, steps_per_pass=4)
    log = io.StringIO()
    out = run(cfg, grid, forcing, st, N_STEPS, run_dir=str(tmp_path),
              log=log)
    diags = _diags(log.getvalue())
    assert [d["n"] for d in diags] == [d["n"] for d in jdiags] \
        == [40, 80, 120, 122]
    for d, jd in zip(diags, jdiags):
        assert d.keys() == jd.keys()
        for key in d:
            assert d[key] == pytest.approx(jd[key], rel=REL, abs=1e-300), key
    for f in "huv":
        assert_close(getattr(out, f), getattr(jout, f), REL, f)
    assert out.n == int(jout.n) == N_STEPS
    assert out.t == pytest.approx(float(jout.t), rel=1e-14)
    assert sorted(os.listdir(tmp_path)) == ["last_good.npz",
                                            "snap_000000122.npz"]


def test_run_resumes_from_snapshot(reference, tmp_path):
    """Stop at step 80, rerun into the same directory: the second run
    resumes from the latest snapshot and ends where one run of 122
    steps ends, bit for bit."""
    jcase, _, _, _ = reference
    cfg, grid, forcing, st = to_port(*jcase)
    rd = str(tmp_path)
    quiet = io.StringIO()
    full = run(cfg, grid, forcing, st, N_STEPS, log=quiet)
    run(cfg, grid, forcing, st, 80, run_dir=rd, log=quiet)
    log = io.StringIO()
    out = run(cfg, grid, forcing, st, N_STEPS - 80, run_dir=rd, log=log)
    assert "resumed from" in log.getvalue() and out.n == N_STEPS
    for f in "huv":
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      getattr(full, f).numpy())


def test_snapshots_cross_packages(reference, tmp_path):
    """A beom_tpu snapshot loads into the port, and the port's loads into
    beom_tpu, with every field, t and n intact."""
    _, jout, _, jrd = reference
    st = snapshots.load_state(jsnap.latest_snapshot(jrd), device="cpu")
    assert st.n == N_STEPS and st.t == np.asarray(jout.t)
    for f in "huv":
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jout, f)))
    p = snapshots.write_snapshot(str(tmp_path), st)
    back = jsnap.load_state(p)
    assert int(back.n) == N_STEPS and back.n.dtype == np.int32
    assert np.asarray(back.t) == st.t
    for f in "huv":
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      getattr(st, f).numpy())


def test_snapshot_phi_without_phi_prev(tmp_path):
    """A snapshot that has phi but no phi_prev loads with phi_prev = phi
    (the reference's ROADMAP fault 3a, not copied)."""
    p = tmp_path / "old.npz"
    z = np.zeros((1, 4, 5))
    phi = np.arange(20.0).reshape(4, 5)
    np.savez(p, h=z, u=z, v=z, t=np.float64(3.0), n=np.int32(7), phi=phi)
    st = snapshots.load_state(p, device="cpu")
    assert st.n == 7 and st.t == 3.0
    np.testing.assert_array_equal(st.phi_prev.numpy(), phi)


def test_run_aborts_on_instability(tmp_path):
    from beom_tpu_torch.cases import make_case

    cfg, grid, forcing, st = make_case("double_gyre", nx=24, ny=24,
                                       dtype="float64", device="cpu")
    bad = dataclasses.replace(cfg, dt=cfg.dt * 10.0)   # way past CFL
    with pytest.raises(InstabilityError, match="last_good"):
        run(bad, grid, forcing, st, 400, run_dir=str(tmp_path),
            log=io.StringIO())


def test_cli_and_toml_case(tmp_path, capfd):
    p = tmp_path / "run.toml"
    p.write_text('case = "double_gyre"\nnx = 32\nny = 32\n'
                 'dtype = "float64"\ndiag_every = 4\n')
    cfg, grid, _, _ = ioconfig.load_toml_case(p, ["ny=24"], device="cpu")
    assert (cfg.nx, cfg.ny) == (32, 24) and grid.mask.shape == (24, 32)
    before = fused_fb.LAUNCHES
    main([str(p), "-n", "6", "--device", "cpu", "--set", "backend='fused'",
          "--set", "steps_per_pass=4"])
    main(["double_gyre", "-n", "4", "--device", "cpu", "--set", "nx=16",
          "--set", "ny=16", "--set", "diag_every=2"])
    diags = _diags(capfd.readouterr().out)
    assert [d["n"] for d in diags] == [4, 6, 2, 4]
    assert all(d["finite"] == 1.0 for d in diags)
    assert fused_fb.LAUNCHES == before     # CPU tensors: plain version
