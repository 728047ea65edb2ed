"""The sharded render pass, as the JAX package's
`cpu_ray_tracer_tpu/parallel/sharded.py`: data parallelism over the
pixels of a frame, the scene replicated on every rank (`parallel/mesh.py`).

Each rank traces its contiguous block of pixels through
`pathtracer.sample_radiance`, with the seeds and jitter of those pixel
ids (`core/rng.pixel_seeds`), so the split cannot change a sample: the
gathered image is the unsharded pass's.  On the card each rank runs the
kernels the unsharded pass runs (the wavefront kernel at depth 0, its
lanes in the camera's lane order restricted to the block, and the
closest-hit walk at the host depths).  The blocks are `all_gather`ed,
`rays_traced` is `all_reduce`d, and `psum_grads` sums the ranks'
gradients as the JAX package's `psum` does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.core import rng
from cpu_ray_tracer_tpu_torch.parallel.mesh import Mesh
from cpu_ray_tracer_tpu_torch.render import pathtracer


def block_rays(camera: cam_mod.Camera, spp_index: int, start: int, end: int, device):
    """The jittered camera rays (o, d) [end - start, 3] and seeds of the
    pixels [start, end) in scanline order: `pathtracer.camera_rays` of
    those pixel ids alone."""
    pixel_ids = torch.arange(start, end, dtype=torch.int64, device=device)
    seeds = rng.pixel_seeds(pixel_ids, spp_index)
    seeds, jx = rng.random_float(seeds)
    seeds, jy = rng.random_float(seeds)
    xs, ys = cam_mod.pixel_grid(camera, device)
    o, d = cam_mod.primary_rays(camera, xs[start:end] + jx, ys[start:end] + jy)
    return o, d, seeds


def block_lane_order(camera: cam_mod.Camera, start: int, end: int, device) -> torch.Tensor:
    """The camera's lane order (`core/camera.lane_order`) restricted to the
    pixels [start, end), as indices into the block."""
    lanes = cam_mod.lane_order(camera, device)
    return (lanes[(lanes >= start) & (lanes < end)] - start).to(lanes.dtype)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' blocks `x` (equal shapes) joined in rank order along
    dim 0."""
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=0)


def sharded_render_pass(scene, camera: cam_mod.Camera, mesh: Mesh,
                        depth_limit: int = constants.DEPTH_LIMIT):
    """A one-sample path-tracer pass whose pixels are split over the ranks
    of `mesh`, every rank holding `scene` on its device.  The pixel count
    must divide by the world size.  Returns `run(spp_index) -> (radiance
    [H, W, 3], stats)` on every rank: stats hold `rays_traced` (the sum
    over the ranks) and the frame's per-pixel `traversed` and `tested`
    [W*H], as `pathtracer.render_pass` returns them."""
    n = camera.width * camera.height
    start, end = mesh.block(n)
    dev = scene.device
    perm = block_lane_order(camera, start, end, dev)

    def run(spp_index: int):
        o, d, seeds = block_rays(camera, spp_index, start, end, dev)
        radiance, stats = pathtracer.sample_radiance(scene, o, d, seeds, depth_limit,
                                                     perm=perm)
        rays = torch.tensor([stats["rays_traced"]], dtype=torch.int64, device=dev)
        dist.all_reduce(rays)
        out = dict(rays_traced=int(rays.item()),
                   traversed=all_gather_rows(stats["traversed"], mesh),
                   tested=all_gather_rows(stats["tested"], mesh))
        return all_gather_rows(radiance, mesh).reshape(camera.height, camera.width, 3), out

    return run


def psum_grads(grads: dict, mesh: Mesh) -> dict:
    """Every gradient summed over the ranks (`all_reduce(SUM)`), in place;
    the dict is returned."""
    for g in grads.values():
        dist.all_reduce(g)
    return grads
