"""The (data, model) device mesh of the port, on ``torch.distributed``.

The JAX package builds a ``jax.sharding.Mesh`` with a ``data`` axis (batch
sharding) and a ``model`` axis (the denoiser's hidden dimension split,
``parallel/sharding.py``), and XLA inserts the collectives
(``flamed_tts_tpu/parallel/mesh.py``).  Here the mesh is a
``DeviceMesh`` over the processes of one ``torch.distributed`` world (one
process a card, started by ``torchrun``; gloo on the CPU, NCCL on the
cards), ``init_device_mesh(device_type, (n_data, n_model),
mesh_dim_names=("data", "model"))``: rank = data index * n_model + model
index.  The port writes its collectives itself: ``shard_batch`` stands in
for ``data_sharding``'s ``P("data")`` (this rank's rows of a batch that
every rank holds whole); replication needs no call.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MESH_AXES = ("data", "model")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """The (data, model) mesh over the processes of the initialized world.
    ``n_data`` defaults to every process on the data axis;
    ``n_data * n_model`` must equal the world size.  ``device_type``
    defaults to ``cuda`` under NCCL, else ``cpu``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed world "
                           "(init_distributed, or torchrun)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=MESH_AXES)


def init_distributed(device: Union[str, torch.device], init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None) -> torch.device:
    """Join the world: NCCL for ``cuda`` (the process's card is
    ``cuda:LOCAL_RANK``), gloo for ``cpu``.  Without arguments the world is
    the one torchrun describes to its processes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT).  Returns this process's device."""
    device = torch.device(device)
    if device.type == "cuda":
        local = dist.get_node_local_rank(fallback_rank=0) if device.index is None else device.index
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kwargs = {}
        if init_method is not None:
            kwargs = {"init_method": init_method, "world_size": world_size, "rank": rank}
        if device.type == "cuda":
            kwargs["device_id"] = device
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", **kwargs)
    return device


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def is_rank0(mesh: Optional[DeviceMesh]) -> bool:
    """The one process that writes files: rank 0 of the world (every
    process without a mesh)."""
    return mesh is None or dist.get_rank() == 0


def rows_of(total: int, mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of a batch of ``total`` rows on the data
    axis: chunks of ceil(total / n_data) rows, as ``torch.chunk`` cuts, so
    a batch that the axis divides splits evenly and a short one leaves the
    last ranks fewer rows or none."""
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    per = -(-total // n)
    return min(total, r * per), min(total, (r + 1) * per)


def shard_batch(batch: Dict, mesh: Optional[DeviceMesh]) -> Dict:
    """This rank's rows of every array of ``batch`` (numpy or tensors, the
    batch axis first): the port's ``P("data")``.  A training batch must
    split evenly: ``len % n_data == 0``."""
    if mesh is None:
        return batch
    total = len(next(iter(batch.values())))
    if total % axis_size(mesh, "data"):
        raise ValueError(f"a batch of {total} rows does not split over {axis_size(mesh, 'data')} "
                         "data ranks")
    lo, hi = rows_of(total, mesh)
    return {k: v[lo:hi] for k, v in batch.items()}


def group_sum(t: torch.Tensor, mesh: Optional[DeviceMesh], axis: Optional[str] = None) -> torch.Tensor:
    """``t`` summed over the ranks of ``axis`` (the whole world where
    None); out of place, no gradient."""
    if mesh is None or (axis is not None and mesh[axis].size() == 1) or dist.get_world_size() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=None if axis is None else mesh[axis].get_group())
    return out


def gather_rows(t: torch.Tensor, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """The data ranks' equal row blocks of ``t`` gathered in rank order:
    the whole batch on every rank."""
    if mesh is None or mesh["data"].size() == 1:
        return t
    wire = t.to(torch.int32) if t.dtype in (torch.bool, torch.int16) else t  # types NCCL lacks
    parts = [torch.empty_like(wire) for _ in range(mesh["data"].size())]
    dist.all_gather(parts, wire.contiguous(), group=mesh["data"].get_group())
    return torch.cat(parts).to(t.dtype)


def pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` with ``n`` repeats of its row 0 appended (the JAX sampler's pad
    of a batch to a multiple of the data axis)."""
    if n == 0:
        return a
    return np.concatenate([a, np.repeat(a[:1], n, axis=0)], axis=0)
