"""PyTorch port of the path tracer's main path, for NVIDIA Hopper GPUs.

Scene XML -> TLAS-baked SAH BVH -> camera rays -> path depths -> film, with
every closest-hit query going through a hand-written CUDA kernel
(`ops/closest_hit.py`, `csrc/closest_hit.cu`).  On CPU tensors each kernel
wrapper runs its plain PyTorch version instead, which the tests hold
against the JAX package (`cpu_ray_tracer_tpu`), the reference.

This package imports torch and numpy only: never JAX, flax, PIL or the JAX
package.
"""
