"""Mesh construction over `torch.distributed` -- the reference's
`repro.launch.mesh`.

A mesh is a `DeviceMesh` with the reference's axis names.  FUNCTIONS, not
module constants: importing this module touches no process group.  Single
pod: 16x16 = 256 ranks (data x model).  Multi-pod: 2 x 16 x 16 = 512 ranks
with a leading pure-DP "pod" axis.  Every function here and in
`launch.sharding` also takes an `AbstractMesh` (axis names and sizes
only), as the reference's rules take any object with `axis_names` and a
`shape` dict.

The reference's `jit_shardings` (a jax-version shim turning specs into
shardings) has `launch.sharding.placements` as its counterpart: a spec
turned into DTensor placements on a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh that holds no process group."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size}, for a DeviceMesh or any object with
    `axis_names` and a `shape` dict."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _device_mesh(device_type: str, shape: tuple, names: tuple, ranks=None):
    """A DeviceMesh over `ranks` (the first prod(shape) ranks of the default
    group by default, which must exist: `dist.init_process_group` is the
    caller's).  Only the ranks of the mesh call this."""
    from torch.distributed.device_mesh import DeviceMesh
    if ranks is None:
        ranks = range(math.prod(shape))
    grid = torch.tensor(list(ranks)).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device_type, shape, axes)


def make_host_mesh(data: int = 2, model: int = 2, device_type: str = "cuda"):
    """Small mesh over however many ranks the default group has, shrunk
    as the reference shrinks to `len(jax.devices())`."""
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return _device_mesh(device_type, (data, model), ("data", "model"))


def mesh_context(mesh):
    """The reference activates its mesh for `jit(in_shardings=...)`; a
    DTensor carries its mesh, so there is nothing to activate."""
    return contextlib.nullcontext(mesh)


def batch_axes(mesh) -> tuple:
    """Logical batch axis = all pure-DP mesh axes."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in batch_axes(mesh))


def sum_over(t: torch.Tensor, mesh, dims=None) -> torch.Tensor:
    """`t` summed in place over the mesh dims `dims` (all by default), one
    all-reduce per dim: over every dim, a sum over the mesh's ranks only."""
    for i in range(mesh.ndim) if dims is None else dims:
        dist.all_reduce(t, group=mesh.get_group(i))
    return t
