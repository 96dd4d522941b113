"""The port's multi-process helpers (beom_tpu_torch/parallel/multihost.py),
twin of beom_tpu/parallel/multihost.py: a single process skips init, is
primary, and gathers a sharded field through its mesh (as beom_tpu's
gather_to_host gives np.asarray of the global array); two gloo processes
on the loopback interface gather their parts on rank 0, and rank 1 gets
None."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch
import torch.distributed as dist

from beom_tpu.parallel import multihost as jmultihost

from beom_tpu_torch.parallel import multihost
from beom_tpu_torch.parallel.mesh import gather, make_mesh, shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_single_process_init_is_a_no_op():
    multihost.init(num_processes=1)
    multihost.init(coordinator_address="127.0.0.1:1", num_processes=0)
    assert not dist.is_initialized()
    assert multihost.is_primary()


def test_single_process_gather_to_host():
    """A Sharded field comes back as the global array, a tensor as itself,
    both equal to beom_tpu's gather_to_host of the same numpy array."""
    a = torch.tensor(np.random.default_rng(5).normal(size=(2, 16, 24)))
    mesh = make_mesh(2, 4, devices=["cpu"])
    sh = shard(a, mesh)
    got = multihost.gather_to_host(sh)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, gather(sh).numpy())
    np.testing.assert_array_equal(got, jmultihost.gather_to_host(a.numpy()))
    np.testing.assert_array_equal(multihost.gather_to_host(a), a.numpy())


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from beom_tpu_torch.parallel import multihost
    from beom_tpu_torch.parallel.mesh import make_mesh, shard
    port, rank = sys.argv[1], int(sys.argv[2])
    multihost.init(f"127.0.0.1:{port}", num_processes=2, process_id=rank)
    assert multihost.is_primary() == (rank == 0)
    # each process holds its part: a (2, 6, 8) field on a 1 x 2 mesh
    part = torch.arange(96, dtype=torch.float64).reshape(2, 6, 8) \\
        + 1000.0 * rank
    got = multihost.gather_to_host(shard(part, make_mesh(1, 2,
                                                         devices=["cpu"])))
    if rank == 0:
        want = np.concatenate([part.numpy(), part.numpy() + 1000.0])
        np.testing.assert_array_equal(got, want)
        print("rank 0 gathered", got.shape)
    else:
        assert got is None
        print("rank 1 got None")
    torch.distributed.destroy_process_group()
""")


def test_two_process_gloo_gather():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(port),
                               str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    assert "rank 0 gathered (4, 6, 8)" in outs[0]
    assert "rank 1 got None" in outs[1]
