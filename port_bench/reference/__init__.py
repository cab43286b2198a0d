"""The benchmark's plain reference: a frozen copy of the port's plain path.

Copied from real_time_ray_tracing_engine_tpu_torch at commit f325494
(scene/schema.py, scene/compile.py, scene/flat.py, models/camera.py,
utils/rng.py, utils/vecmath.py, utils/perlin.py, ops/intersect.py,
ops/materials.py, ops/lights.py, ops/textures.py, ops/integrator.py and the
op model of utils/profiling.py), so that a later change to the port cannot
move the yardstick it is measured against. Three departures, none of which
changes a value:

  - every function takes the float dtype of its inputs (the control runs
    the same arithmetic in bfloat16);
  - the closest hit picks its winner from a table computed without
    autograd and then recomputes the winner's t with autograd, so a
    gradient pass keeps O(rays) tensors a bounce instead of O(rays x
    primitives); torch.min's gradient flows to the winner alone, so the
    gradient is the same;
  - the BVH oracle is left out: the reference selects over every
    primitive, as the kernels' plain versions do.

This package imports nothing of the port, of JAX or of the JAX package.
"""
