"""Device mesh (port of vibevoice_tpu/parallel/mesh.py, ``make_mesh`` only).

The JAX package's sharding rules (tensor, data and FSDP parallelism), its
hybrid multi-slice mesh and multi-host set-up are not ported yet.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(dp: int = 1, tp: int = 1) -> DeviceMesh:
    """A DeviceMesh with dims ("dp", "tp") over every rank of the default
    process group, whose world size must be dp * tp. It holds CUDA devices
    when the group's backend is NCCL and CPU devices otherwise."""
    world = dist.get_world_size()
    if dp * tp != world:
        raise ValueError(f"a {dp} x {tp} mesh needs a world of {dp * tp} ranks, not {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))
