"""The port's LM meshes (``repro_torch.launch.mesh``) against the
reference's (``repro.launch.mesh``).

The production meshes are built on a fake process group
(``launch.mesh.init_fake_group``: 256 or 512 ranks inside this one
process); the reference's ``dp_axes`` and ``dp_size`` read a
``jax.sharding.AbstractMesh`` of the same shape. A fixture destroys the
group after each test: an xdist worker may run another file's tests next.
"""
import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.launch import mesh as JM
from repro_torch.launch import mesh as M


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod,shape,names", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh_on_a_fake_group(no_group, multi_pod, shape, names):
    """The reference's shapes and axis names, over the first ranks of the
    group; its DP axes and size are the reference's."""
    M.init_fake_group(512)
    mesh = M.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert isinstance(mesh, torch.distributed.device_mesh.DeviceMesh)
    assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
    assert mesh.size() == (512 if multi_pod else 256)
    assert M.axis_sizes(mesh) == dict(zip(names, shape))
    jmesh = JAbstractMesh(shape, names)
    assert M.dp_axes(mesh) == JM.dp_axes(jmesh)
    assert M.dp_size(mesh) == JM.dp_size(jmesh) == shape[-2] * (
        2 if multi_pod else 1)
    assert mesh.get_group("data").size() == 16


@pytest.mark.parametrize("world", [None, 1, 255])
def test_production_mesh_refused_when_the_world_is_short(no_group, world):
    """As the reference refuses a mesh with too few devices; the message
    names what to run instead."""
    if world is not None:
        M.init_fake_group(world)
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="fake process group") as e:
            M.make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert "COORDINATOR_ADDRESS" in str(e.value)


def test_host_mesh_without_a_group(no_group):
    """No group: a 1 x 1 mesh of the port's own kind on the caller's
    device (default cuda), with the reference's names; it creates none."""
    mesh = M.make_host_mesh(device="cpu")
    assert isinstance(mesh, M.AbstractMesh) and not dist.is_initialized()
    assert mesh.mesh_dim_names == ("data", "model") and mesh.shape == (1, 1)
    assert mesh.device == torch.device("cpu") and mesh.size() == 1
    assert M.make_host_mesh().device == torch.device("cuda")
    assert M.dp_axes(mesh) == ("data",) and M.dp_size(mesh) == 1
    with pytest.raises(ValueError, match="one device"):
        M.make_host_mesh(model=2, device="cpu")


@pytest.mark.parametrize("world,model", [(8, 1), (8, 2), (1, 1)])
def test_host_mesh_over_a_group(no_group, world, model):
    """With a group (fake here; gloo or NCCL in a fleet): (world // model,
    model), a real DeviceMesh whose DP size the reference's rule gives."""
    M.init_fake_group(world)
    mesh = M.make_host_mesh(model=model, device="cpu")
    assert isinstance(mesh, torch.distributed.device_mesh.DeviceMesh)
    assert tuple(mesh.shape) == (world // model, model)
    assert mesh.mesh_dim_names == ("data", "model")
    jmesh = JAbstractMesh((world // model, model), ("data", "model"))
    assert M.dp_size(mesh) == JM.dp_size(jmesh) == world // model
    with pytest.raises(ValueError, match="does not divide"):
        M.make_host_mesh(model=3, device="cpu")


@pytest.mark.parametrize("shape,names", [
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
    ((4, 2), ("data", "model")), ((1, 1), ("data", "model"))])
def test_dp_axes_and_size_as_the_reference(shape, names):
    """On an AbstractMesh of each shape, and on a slot mesh (no DP axes)."""
    jmesh = JAbstractMesh(shape, names)
    mesh = M.AbstractMesh(shape, names)
    assert M.dp_axes(mesh) == JM.dp_axes(jmesh)
    assert M.dp_size(mesh) == JM.dp_size(jmesh)
    assert M.axis_sizes(mesh) == dict(jmesh.shape)
    slots = M.make_serving_mesh(devices=["cpu"] * 4)
    assert M.dp_axes(slots) == () and M.dp_size(slots) == 1
    assert jax.sharding.AbstractMesh((4,), ("slots",)).axis_names == \
        slots.axis_names
