"""The port's mesh and halo exchange (beom_tpu_torch/parallel/mesh.py,
halo.py) against beom_tpu.parallel.halo under shard_map on the 8 virtual
CPU devices, and the plain version of the halo-pad kernel (K8) against
beom_tpu's rdma_pad2d in interpret mode.  Inputs come from a numpy seed;
a pad is a copy, so it is held bit for bit."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from beom_tpu.parallel import halo as jhalo
from beom_tpu.parallel.mesh import make_mesh as j_make_mesh
from beom_tpu.parallel.rdma_halo import rdma_pad2d

from beom_tpu_torch.parallel import halo
from beom_tpu_torch.parallel.mesh import (Sharded, gather, make_mesh, shard,
                                          shard_pytree, gather_pytree)
from beom_tpu_torch.stencils import halo_pad

MESHES = [(2, 4), (1, 8), (8, 1)]


def _field(seed, shape, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _jax_blocks(fn, a, mesh_shape):
    """fn applied to the local blocks of `a` under shard_map; the result
    is the blocks' concatenation, as gather() lays the port's out."""
    spec = P(None, "y", "x") if a.ndim == 3 else P("y", "x")
    return np.asarray(jax.jit(shard_map(
        fn, mesh=j_make_mesh(*mesh_shape), in_specs=spec,
        out_specs=spec))(jnp.asarray(a)))


@pytest.mark.parametrize("shape", [(32, 64), (3, 32, 64)])
@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_pad2d_matches_reference(mesh_shape, w, shape):
    a = _field(0, shape)
    ref = _jax_blocks(lambda x: jhalo.pad2d(x, w), a, mesh_shape)
    mesh = make_mesh(*mesh_shape, devices=["cpu"])
    halo.reset_counts()
    out = halo.pad2d(shard(torch.tensor(a), mesh), w)
    np.testing.assert_array_equal(gather(out).numpy(), ref)
    assert halo.COUNTS["moved"] > 0 and halo.COUNTS["reductions"] == 0
    # crop2d undoes it
    np.testing.assert_array_equal(gather(halo.crop2d(out, w)).numpy(), a)


@pytest.mark.parametrize("axis_name", ["y", "x"])
def test_pad_axis_matches_reference(axis_name):
    a = _field(1, (3, 32, 64))
    axis = 1 if axis_name == "y" else 2
    ref = _jax_blocks(lambda x: jhalo.pad_axis(x, 2, axis, axis_name), a,
                      (2, 4))
    mesh = make_mesh(2, 4, devices=["cpu"])
    out = halo.pad_axis(shard(torch.tensor(a), mesh), 2, axis, axis_name)
    np.testing.assert_array_equal(gather(out).numpy(), ref)
    same = halo.pad_axis(shard(torch.tensor(a), mesh), 0, axis, axis_name)
    np.testing.assert_array_equal(gather(same).numpy(), a)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_dist_dots_match_reference(mesh_shape):
    """One mesh reduction for a batch of dots; the values agree with the
    reference's psum to the rounding of another summation order (1e-13
    relative)."""
    a, b = _field(2, (32, 64)), _field(3, (32, 64))
    jmesh = j_make_mesh(*mesh_shape)
    ref = np.asarray(jax.jit(shard_map(
        lambda x, y: jhalo.dist_dots([(x, y), (x, x)]), mesh=jmesh,
        in_specs=(P("y", "x"), P("y", "x")), out_specs=P()))(
            jnp.asarray(a), jnp.asarray(b)))
    mesh = make_mesh(*mesh_shape, devices=["cpu"])
    sa, sb = shard(torch.tensor(a), mesh), shard(torch.tensor(b), mesh)
    halo.reset_counts()
    out = halo.dist_dots([(sa, sb), (sa, sa)])
    assert halo.COUNTS == {"reductions": 1, "moved": 0}
    for blk in out.blocks:              # replicated on every shard
        np.testing.assert_allclose(blk.numpy(), ref, rtol=1e-13)
    one = halo.dist_dot(sa, sb)
    np.testing.assert_allclose(float(one), ref[0], rtol=1e-13)
    assert halo.COUNTS["reductions"] == 2


@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_halo_pad_plain_matches_rdma_interpret(mesh_shape, w):
    """K8's plain version against the TPU kernel it replaces, run as
    tests/dist/test_rdma_halo.py runs it (the Pallas TPU interpreter on
    the virtual mesh)."""
    a = _field(4, (3, 32, 64), np.float32)
    ref = _jax_blocks(lambda x: rdma_pad2d(x, w), a, mesh_shape)
    mesh = make_mesh(*mesh_shape, devices=["cpu"])
    sa = shard(torch.tensor(a), mesh)
    np.testing.assert_array_equal(
        gather(halo_pad.halo_pad_plain(sa, w)).numpy(), ref)
    before = halo_pad.LAUNCHES
    with halo.impl("rdma"):             # CPU blocks: the plain version
        out = halo.pad2d(sa, w)
    np.testing.assert_array_equal(gather(out).numpy(), ref)
    assert halo_pad.LAUNCHES == before


def test_halo_pad_2d_field_and_single_shard():
    a = _field(5, (16, 32), np.float32)
    ref = _jax_blocks(lambda x: rdma_pad2d(x, 2), a, (2, 4))
    sa = shard(torch.tensor(a), make_mesh(2, 4, devices=["cpu"]))
    np.testing.assert_array_equal(gather(halo_pad.halo_pad(sa, 2)).numpy(),
                                  ref)
    # one shard: the pad is the periodic wrap of the field itself
    s1 = shard(torch.tensor(a), make_mesh(1, 1, devices=["cpu"]))
    wrap = np.pad(a, 2, mode="wrap")
    np.testing.assert_array_equal(gather(halo_pad.halo_pad(s1, 2)).numpy(),
                                  wrap)
    assert halo_pad.halo_pad(s1, 0) is s1


def test_impl_switch():
    with pytest.raises(ValueError, match="unknown halo impl"):
        with halo.impl("nccl"):
            pass
    with halo.impl("rdma"):
        assert halo._PAD_IMPL == "rdma"
    assert halo._PAD_IMPL == "ppermute"


def test_make_mesh_devices():
    """devices=None takes one visible CUDA device per shard, as the
    reference takes jax.devices(); one named device serves every shard."""
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 8 devices, have 0"):
            make_mesh(2, 4)
    mesh = make_mesh(2, 4, devices=["cpu"])
    assert mesh.n == 8 and mesh.shape == {"y": 2, "x": 4}
    assert mesh.coords(5) == (1, 1) and mesh.index(-1, 4) == 4
    assert mesh.neighbour(0, -1, -1) == 7
    with pytest.raises(ValueError, match="does not divide"):
        shard(torch.zeros(3, 30, 30), mesh)


def test_shard_gather_roundtrip_and_pytree():
    from beom_tpu_torch.cases import make_case

    cfg, grid, forcing, st = make_case("shelf_forced", nx=48, ny=32,
                                       device="cpu", dtype="float64")
    mesh = make_mesh(2, 4, devices=["cpu"])
    for tree in (grid, forcing, st):
        sh = shard_pytree(tree, mesh)
        back = gather_pytree(sh)
        for name, a in vars(tree).items():
            if isinstance(a, torch.Tensor):
                assert isinstance(getattr(sh, name), Sharded)
                assert getattr(sh, name).shape[-2:] == (16, 12)
                assert torch.equal(getattr(back, name), a)
            else:
                assert getattr(sh, name) is a or getattr(sh, name) == a


def test_sharded_runs_tensor_code_per_block():
    """Operators, torch functions, methods and indexing map over the
    blocks; numpy scalars on the left defer to them."""
    a = torch.tensor(_field(6, (2, 8, 16)))
    mesh = make_mesh(2, 2, devices=["cpu"])
    s = shard(a, mesh)

    def f(x):
        y = 2.0 * x - x / 3 + np.float64(0.5) * torch.roll(x, 1, -1)
        y = torch.where(y > 0, y, -y).clamp_min(0.1)
        z = torch.stack([y[0], y[1] ** 2], dim=0)
        z[:, :1] += 1.0
        return torch.sum(z, dim=0), z.abs().max()

    out, top = f(s)
    for k, blk in enumerate(s.blocks):
        ref, rtop = f(blk)
        assert torch.equal(out.blocks[k], ref)
        assert torch.equal(top.blocks[k], rtop)
    assert out.shape == (4, 8) and out.dtype == torch.float64
    assert float(halo.pmax2(top)) == max(float(b) for b in top.blocks)
