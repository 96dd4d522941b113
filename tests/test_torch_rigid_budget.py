"""The rigid-lid double gyre under an unconverged red-black SOR budget:
beom_tpu.run.run (backend='xla') against beom_tpu_torch.run.run (the eager
port) at f64, 96 x 96, solver='redblack' with solver_maxiter = 16 sweeps,
far below what the solve needs at that size.  Such a budget leaves a
residual in every step's pressure that the next step grows, so the run
goes non-finite; at 2048^2 f32 the card's fused path does so by step 102
with a budget of 480 sweeps.  The two packages must agree step by step
and raise InstabilityError at the same step: the blow-up is the
configuration's own, not the port's.  Tolerance: relative 1e-10 on every
diagnostic of every step whose kinetic energy is below 1e30 (it grows
about 1.8 times a step, then overflows within two steps; in those last
steps the mass, a sum of thicknesses near 1e30 that cancel, keeps no
digits)."""

import io
import json

import pytest

from beom_tpu.cases import make_case as jax_make_case
from beom_tpu.run import InstabilityError as JaxInstabilityError
from beom_tpu.run import run as jax_run

from beom_tpu_torch.run import InstabilityError, run

from tests.torch_parity import to_port

N = 96
BUDGET = 16          # red-black sweeps per solve: two passes of 8
MAX_STEPS = 80
REL = 1e-10
KE_CAP = 1e30


def _diags(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _run(fn, error, case):
    log = io.StringIO()
    with pytest.raises(error, match="non-finite state at step") as info:
        fn(*case, MAX_STEPS, log=log)
    return _diags(log.getvalue()), str(info.value)


def test_unconverged_redblack_budget_blows_up_in_both_packages():
    jcase = jax_make_case("rigid_lid", nx=N, ny=N, dtype="float64",
                          solver="redblack", solver_maxiter=BUDGET,
                          diag_every=1, backend="xla")
    jd, jmsg = _run(jax_run, JaxInstabilityError, jcase)
    d, msg = _run(run, InstabilityError, to_port(*jcase))
    assert msg == jmsg
    assert [x["n"] for x in d] == [x["n"] for x in jd]
    assert 10 < len(d) < MAX_STEPS, len(d)
    grown = [(x, jx) for x, jx in zip(d, jd) if jx["ke"] < KE_CAP]
    assert len(grown) >= len(d) - 3
    for x, jx in grown:
        assert x["finite"] == jx["finite"] == 1.0
        for key in ("mass", "ke", "pe", "max_speed", "eta_rms"):
            assert x[key] == pytest.approx(jx[key], rel=REL), (x["n"], key)
    # the state grows without bound before it overflows: the unconverged
    # solve, not one bad step
    assert grown[-1][1]["ke"] > 1e9 * d[0]["ke"]
    assert d[-1]["finite"] == jd[-1]["finite"] == 0.0
