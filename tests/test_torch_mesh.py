"""ssdx_torch.mesh in one process: the no-op cases, the slicing, and the
collectives in a one-rank gloo group on the CPU (the two-rank cases are in
tests/test_torch_sync_bn.py and tests/test_torch_multiproc.py).

The JAX counterpart (tests/test_mesh.py) shards arrays over 8 virtual
devices; here a rank's tensors are its shard, so ``shard_batch`` is held
against the rows ``jax.device_put`` with ``batch_sharding`` gives each device.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ssdx import mesh as jax_mesh
from ssdx_torch import mesh as M
from ssdx_torch.api import Detector
from ssdx_torch.train.step import Batch
from torch_dist import CLASSES, free_port, images


def test_initialize_is_a_noop_for_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    M.initialize_distributed()
    M.initialize_distributed(device="cpu")
    assert not dist.is_initialized()
    mesh = M.create_mesh("cpu")
    assert (mesh.group, mesh.size, mesh.rank, mesh.backend) == (None, 1, 0, None)
    assert mesh.device == torch.device("cpu")


@pytest.mark.parametrize("mesh", [None, M.Mesh(None, 1, 0, torch.device("cpu"))])
def test_collectives_are_identities_without_a_group(mesh, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a collective was called")

    for name in ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, boom)
    t = torch.arange(6.0).reshape(3, 2)
    assert M.all_reduce_sum(t, mesh) is t and M.all_gather_batch(t, mesh) is t
    assert M.broadcast_(t, mesh) is t and M.shard_batch(t, mesh) is t
    M.barrier(mesh)


@pytest.mark.parametrize("size", [2, 4, 8])
def test_shard_batch_gives_the_rows_jax_gives_each_device(size):
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    jm = jax_mesh.create_mesh(jax.devices()[:size])
    sharded = jax_mesh.shard_batch(x, jm)
    rows = {s.device.id: np.asarray(s.data) for s in sharded.addressable_shards}
    for rank, device in enumerate(jm.devices.ravel()):
        mesh = M.Mesh(object(), size, rank, torch.device("cpu"))
        np.testing.assert_array_equal(M.shard_batch(x, mesh), rows[device.id])
        batch = Batch(torch.as_tensor(x), x, [x, x], {"k": x})
        got = M.shard_batch(batch, mesh)
        assert isinstance(got, Batch) and isinstance(got.images, torch.Tensor)
        np.testing.assert_array_equal(got.images.numpy(), rows[device.id])
        np.testing.assert_array_equal(got.gt_labels[1], rows[device.id])
        np.testing.assert_array_equal(got.gt_valid["k"], rows[device.id])


def test_shard_batch_needs_a_leading_axis_that_divides():
    with pytest.raises(ValueError, match="divide evenly"):
        M.shard_batch(np.zeros((7, 2)), M.Mesh(object(), 2, 0, torch.device("cpu")))


@pytest.fixture(scope="module")
def one_rank():
    M.initialize_distributed(init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                             device="cpu")
    yield M.create_mesh("cpu")
    M.finalize_distributed()
    assert not dist.is_initialized()


def test_one_rank_group_runs_its_collectives(one_rank):
    mesh = one_rank
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo") and mesh.group is not None
    t = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    y = M.all_reduce_sum(t * 2, mesh)
    (y * torch.tensor([1.0, 10.0, 100.0])).sum().backward()
    assert y.tolist() == [2.0, 4.0, 6.0] and t.grad.tolist() == [2.0, 20.0, 200.0]
    for src in (torch.arange(6).reshape(3, 2), torch.tensor([True, False]),
                torch.ones(2, 2, dtype=torch.bfloat16)):
        out = M.all_gather_batch(src, mesh)
        assert out.dtype == src.dtype and torch.equal(out, src) and out is not src
    b = torch.full((3,), 7.0)
    assert M.broadcast_(b, mesh) is b and b.tolist() == [7.0] * 3
    M.barrier(mesh)


def test_detector_in_a_one_rank_mesh_equals_no_mesh(one_rank):
    kw = dict(rng_seed=3, width_mult=0.25)
    single = Detector(CLASSES, device="cpu", **kw)
    meshed = Detector(CLASSES, mesh=one_rank, **kw)
    assert meshed.device.type == "cpu" and meshed.mesh is one_rank
    x = images(3)
    for a, b in zip(single.forward(x), meshed.forward(x)):
        assert torch.equal(a, b)
    p1 = single.predict(x, score_thresh=0.1)
    p2 = meshed.predict(x, score_thresh=0.1)
    for a, b in zip(p1, p2):
        for k in ("labels", "scores", "boxes"):
            np.testing.assert_array_equal(a[k], b[k])
