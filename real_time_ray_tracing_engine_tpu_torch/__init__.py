"""Monte-Carlo path tracer on PyTorch + CUDA: the port of the JAX package
`real_time_ray_tracing_engine_tpu` to an NVIDIA H100.

Plain torch around one hand-written CUDA megakernel (csrc/wavefront.cu,
built with nvcc at first use). The scene JSON, the flat-table layout and the
PCG4D sample streams are shared with the JAX package, which stays the
reference; this package never imports JAX.
"""
from .scene.schema import (Scene, CameraConfig, Sphere, Quad, Box, Translate,
                           RotateY, Group, ConstantMedium, Lambertian, Metal,
                           Dielectric, DiffuseLight, Isotropic, SolidColor,
                           Checker, Noise, load_scene, save_scene,
                           scene_to_json, scene_from_json)
from .scene.compile import compile_scene, golden_json
from .scene.flat import FlatScene
from .scene import builders
from .models.render import render, ProgressiveRenderer
from .models import camera
from .ops.integrator import trace
from .utils.color import write_ppm, read_ppm, to_bytes

__version__ = "0.1.0"
