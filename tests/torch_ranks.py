"""Rank bodies the port's multi-process CPU tests spawn
(parallel/distributed.py::spawn_ranks). A spawned rank imports this module
to find its function, so it imports torch and the port only, never JAX."""
import time

import torch

from real_time_ray_tracing_engine_tpu_torch.models import camera as cam_mod
from real_time_ray_tracing_engine_tpu_torch.parallel import distributed
from real_time_ray_tracing_engine_tpu_torch.parallel import train
from real_time_ray_tracing_engine_tpu_torch.parallel.mesh import (
    make_render_mesh, render_on_mesh)
from real_time_ray_tracing_engine_tpu_torch.scene import builders
from real_time_ray_tracing_engine_tpu_torch.scene.compile import \
    compile_scene


def cornell(width: int, spp: int, depth: int):
    scene = builders.cornell_box()
    scene.camera.image_width = width
    scene.camera.samples_per_pixel = spp
    scene.camera.max_depth = depth
    return scene


def mesh_rank(rank, n, init_method, renders, grad_layout, grad_kw):
    """render_on_mesh of the Cornell box on each layout of `renders` at its
    settings (width, spp, depth), and render_loss_grad over every
    trainable family on grad_layout (grad_kw: width, n_strata, max_depth)
    against a black target. Returns this rank's images, loss and
    gradients."""
    distributed.initialize(device="cpu", init_method=init_method, rank=rank,
                           world_size=n, local_rank=rank, local_world_size=n)
    images = {layout: render_on_mesh(cornell(**kw),
                                     mesh=make_render_mesh(*layout),
                                     device="cpu")
              for layout, kw in renders.items()}
    gscene = cornell(grad_kw["width"], 1, 1)
    flat = compile_scene(gscene, device="cpu")
    cam = cam_mod.derive(gscene.camera)
    w, h = cam_mod.image_size(gscene.camera)
    mesh = make_render_mesh(*grad_layout)
    loss, grads = train.render_loss_grad(
        distributed.replicate(flat, mesh), cam, 0, torch.zeros(h, w, 3),
        width=w, height=h, mesh=mesh, fields=train.TRAINABLE_FIELDS,
        **{k: v for k, v in grad_kw.items() if k != "width"})
    return {"images": images, "loss": float(loss), "grads": grads,
            "shard": (mesh.tile, mesh.sample)}


def hang_rank(rank, n, init_method, fail):
    """A rank that never ends, as one stuck in a collective would; with
    `fail`, rank 1 raises at once."""
    if fail and rank == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(600)
