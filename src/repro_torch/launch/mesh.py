"""Device meshes. Port of ``repro.launch.mesh``.

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the ``pod`` axis is the HFEL "cloud" tier, ``data``
the "edge" tier, ``model`` tensor parallelism.

Each function builds a named ``torch.distributed`` device mesh with
``init_device_mesh`` and needs a process group of as many ranks, which the
caller initialises (as ``torchrun`` or a test's spawned ranks do). A mesh is
on CUDA devices unless the caller asks for ``device_type="cpu"`` (gloo).
A rank finds its place on the mesh with :func:`coordinates` and the group
of each axis with :func:`axis_group`.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A small mesh for integration tests (``shape`` ranks in all)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch is sharded over."""
    if "pod" in mesh.mesh_dim_names:
        return ("pod", "data")
    return ("data",)


def n_pods(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index("pod")) if "pod" in names else 1


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a device mesh; a mapping of axis sizes
    (as the placement rules accept in place of a mesh) is returned as a
    dict."""
    if isinstance(mesh, dict) or hasattr(mesh, "items"):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def coordinates(mesh) -> dict:
    """``{axis name: this rank's index along it}`` on a device mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis`` (the ranks that
    differ from it on ``axis`` alone)."""
    return mesh.get_group(axis)
