"""The ray mesh: data parallelism over the pixels, as the JAX package's
`cpu_ray_tracer_tpu/parallel/mesh.py` (a 1-D `rays` mesh, the scene
replicated on every device, the rays sharded).

PyTorch runs one process a device, so the mesh is the process group of
`torch.distributed` with this process's rank, the world size and the
rank's device.  A launcher (`torchrun --nproc-per-node N`) sets `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`; without one,
`make_mesh` makes a world of one over a `FileStore` in a fresh temporary
directory.  The backend is NCCL on the card and gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from cpu_ray_tracer_tpu_torch.core import device as device_mod


@dataclasses.dataclass
class Mesh:
    """This process's place in the ray mesh: `rank` of `world`, on
    `device`.  `owned`: `make_mesh` started the process group, and
    `close` ends it."""

    rank: int
    world: int
    device: torch.device
    backend: str
    owned: bool = False
    store_dir: str | None = None

    def block(self, n: int) -> tuple[int, int]:
        """This rank's contiguous block [start, end) of `n` items; `n` must
        divide by the world size (the JAX package's sharded.py:34)."""
        if n % self.world:
            raise ValueError(f"{n} pixels do not divide among {self.world} ranks")
        per = n // self.world
        return self.rank * per, (self.rank + 1) * per

    def close(self) -> None:
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)
        self.owned, self.store_dir = False, None


def make_mesh(n_devices: int | None = None, device=device_mod.DEFAULT) -> Mesh:
    """The mesh of this process, in the process group the caller started,
    else starting one: from the launcher's environment (`RANK`,
    `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`), or without a launcher a
    world of one.  `device` "cuda" (the default: NCCL, the rank's card
    `LOCAL_RANK`; without a CUDA device it raises) or "cpu" (gloo).
    `n_devices`, where given, must be the world size: a process drives one
    device, and more devices take more processes."""
    dev = device_mod.resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    owned, store_dir = False, None
    if not dist.is_initialized():
        owned = True
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            store_dir = tempfile.mkdtemp(prefix="crt_mesh_")
            store = dist.FileStore(os.path.join(store_dir, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = Mesh(rank, world, dev, dist.get_backend(), owned, store_dir)
    if n_devices is not None and n_devices != world:
        mesh.close()
        raise ValueError(f"n_devices={n_devices} but the world has {world} process(es): one "
                         f"process drives one device; start {n_devices} with "
                         f"`torchrun --nproc-per-node {n_devices} ...`")
    if dev.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        mesh.device = torch.device("cuda", index)
        torch.cuda.set_device(mesh.device)
    return mesh


def replicate_scene(scene, mesh: Mesh):
    """The scene on the rank's device (every rank holds all of it)."""
    return scene.to(mesh.device)


def shard_rays(o: torch.Tensor, d: torch.Tensor, mesh: Mesh):
    """The rank's contiguous block of the rays (o, d) [N, 3]."""
    a, b = mesh.block(o.shape[0])
    return o[a:b], d[a:b]
