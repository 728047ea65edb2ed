"""Global numeric constants, the same float32 values as the JAX package's
`cpu_ray_tracer_tpu/constants.py` (the subset the integrators and the
render configuration use)."""

import numpy as np

INVPI = np.float32(0.31830988618379067153777)
TWO_PI = np.float32(2.0 * np.pi)

# Ray-miss sentinel distance (template/ray.h:15 `distance = 1e34f`).
RAY_FAR = np.float32(1e34)
# Möller–Trumbore epsilon (infra/bvh.cpp:209 / :217).
TRI_EPS = np.float32(1e-4)
# Shading offset epsilon (2. WhittedStyle/renderer.h:12).
SHADE_EPS = np.float32(1e-3)

# Default render resolution of the reference (template/camera.h:4-5).
SCRWIDTH = 1024
SCRHEIGHT = 640

# Depth limit of the path tracer (3. PathTracer/renderer.h:53).
DEPTH_LIMIT = 5

# Index of refraction of the dielectric branch (3. PathTracer/renderer.cpp:30).
IOR = np.float32(1.2)

# The scene's single light color (tlas_file_scene.cpp GetLightColor).
LIGHT_COLOR = np.array([24.0, 24.0, 22.0], np.float32)

# Whitted constant ambient term (2. WhittedStyle/renderer.cpp:77).
AMBIENT = np.array([0.3, 0.3, 0.3], np.float32)
