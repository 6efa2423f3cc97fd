"""Device meshes for the distributed aggregation engine, the port of
``repro.launch.mesh``.

Single pod: (data=16, model=16) = 256 cards. Multi-pod: (pod=2, data=16,
model=16) = 512 cards. The shapes and axis names are the reference's.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
default process group, one process per device. These functions build
the mesh only: the caller owns rendezvous (torchrun's environment, or
``torch.distributed.init_process_group`` with a ``FileStore`` or a
``tcp://`` address) and initializes the default group first, as in any
``torch.distributed`` program. Meshes live on CUDA devices (NCCL) unless
``device_type="cpu"`` (gloo) is asked for.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch.distributed as dist


def _init_mesh(shape: Sequence[int], axes: Tuple[str, ...],
               device_type: str):
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs an initialized default process group: "
            "call torch.distributed.init_process_group first (torchrun's "
            "environment, a FileStore or a tcp:// address)"
        )
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', "
                         f"got {device_type!r}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init_mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0,
                    device_type: str = "cuda"):
    """Small mesh over the ranks of the default group: tests, examples,
    one machine's cards."""
    if pod:
        return _init_mesh((pod, data, model), ("pod", "data", "model"),
                          device_type)
    return _init_mesh((data, model), ("data", "model"), device_type)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axis_names(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def n_data_shards(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axis_names(mesh):
        n *= int(sizes[a])
    return n
