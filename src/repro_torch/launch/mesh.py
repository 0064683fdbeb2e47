"""Mesh construction on ``torch.distributed``.

Port of ``repro.launch.mesh``.  Single pod: (data=16, model=16), 256
ranks.  Multi-pod: (pod=2, data=16, model=16), 512 ranks.  The pod axis
is data-parallel replication by default; ``distributed.pipeline``
repurposes it as pipeline stages.

Functions, not module constants: importing this module touches no
device and no process-group state.  A real mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group (one rank per device); an abstract one (:class:`AbstractMesh`)
holds axis sizes only, which is all the sharding rules read.
"""

from __future__ import annotations

from typing import Dict, Sequence


class AbstractMesh:
    """Device-free mesh: axis names and sizes, JAX's ``AbstractMesh``.
    ``shape`` maps each axis name to its size, in mesh order."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order, for an :class:`AbstractMesh`
    or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the sharding rules need a mesh with named dims")
    return dict(zip(names, mesh.shape))


def _device_type() -> str:
    """The mesh's device type: the card under NCCL, else the CPU."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")`` or, multi-pod, (2, 16, 16)
    ``("pod", "data", "model")`` over the default process group; raises
    unless it has 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    """Device-free mesh for static sharding-rule checks (axis sizes
    only)."""
    return AbstractMesh(tuple(shape), tuple(axes))


def make_host_mesh(model_parallel: int = 1):
    """A ``("data", "model")`` mesh over every rank of the default group,
    ``model_parallel`` ranks on ``model`` when it divides the world size
    (else 1)."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    mp = model_parallel if n % model_parallel == 0 else 1
    return _mesh((n // mp, mp), ("data", "model"))


def dp_axes(mesh) -> tuple:
    """Axes carrying pure data parallelism (pod axis included if
    present)."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
