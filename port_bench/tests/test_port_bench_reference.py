"""The frozen reference against the port's plain engine at a tiny size:
images equal, and the training step's loss and gradients of every family
equal to rounding."""
import dataclasses

import pytest
import torch

from harness import loader
from reference import camera as ref_cam
from reference import render as ref_render
from reference import scene as ref_scene

import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu_torch.models import camera as pt_cam
from real_time_ray_tracing_engine_tpu_torch.parallel import train

FIELDS = ("tex_color", "mat_fuzz", "mat_ior", "sph_center", "sph_radius")


def _path(name):
    return str(loader.BENCH_ROOT / "configs" / f"{name}.json")


@pytest.mark.parametrize("name,width,depth", [("cornell_box", 20, 8),
                                              ("bouncing_spheres", 24, 8)])
def test_reference_image_equals_the_plain_engine(name, width, depth):
    s = pt.load_scene(_path(name))
    s.camera.image_width, s.camera.samples_per_pixel = width, 4
    s.camera.max_depth = depth
    img = pt.render(s, device="cpu", seed=123456789012)
    r = ref_scene.load_scene(_path(name))
    r.camera = dataclasses.replace(r.camera, image_width=width,
                                   samples_per_pixel=4, max_depth=depth)
    w, h = ref_cam.image_size(r.camera)
    ref = ref_render.image(ref_scene.compile_scene(r),
                           ref_cam.derive(r.camera), width=w, height=h,
                           seed=123456789012, n_strata=2, max_depth=depth,
                           sky_gradient=False)
    assert torch.equal(img, ref)


@pytest.mark.parametrize("name,sky", [("cornell_box", False),
                                      ("bouncing_spheres", True)])
def test_reference_gradients_equal_the_plain_engine(name, sky):
    """Cornell's 9 slots take the plain tangent bundles, bouncing's 2,013
    the plain adjoint: the reference's autograd agrees with both."""
    w, d, n = 16, 4, 2
    s = pt.load_scene(_path(name))
    s.camera = dataclasses.replace(s.camera, image_width=w, sky_gradient=sky)
    flat, cam = pt.compile_scene(s), pt_cam.derive(s.camera)
    _, h = pt_cam.image_size(s.camera)
    r = ref_scene.load_scene(_path(name))
    r.camera = dataclasses.replace(r.camera, image_width=w)
    rflat, rcam = ref_scene.compile_scene(r), ref_cam.derive(r.camera)
    kw = dict(width=w, height=h, n_strata=n, max_depth=d, sky_gradient=sky)
    target = ref_render.image(rflat, rcam, seed=99, **kw)
    p0 = {k: getattr(flat, k).clone() for k in FIELDS}
    p0["tex_color"] = p0["tex_color"] * 0.9
    p0["mat_ior"] = torch.where(p0["mat_ior"] > 1.01, p0["mat_ior"] + 0.05,
                                p0["mat_ior"])
    loss, g = train.render_loss_grad(dataclasses.replace(flat, **p0), cam, 5,
                                     target, fields=FIELDS, engine="torch",
                                     **kw)
    rloss, rg = ref_render.loss_grad(rflat, p0, rcam, target, seed=5, **kw)
    assert float(loss) == pytest.approx(rloss, rel=1e-6)
    for k in FIELDS:
        scale = float(rg[k].abs().max()) + 1e-12
        assert float((g[k] - rg[k]).abs().max()) <= 1e-4 * scale, k


def test_reference_adam_is_torchs():
    torch.manual_seed(0)
    p = {"a": torch.randn(5), "b": torch.randn(3, 3)}
    lrs = {"a": 0.02, "b": 0.001}
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    opt = torch.optim.Adam([{"params": [leaves[k]], "lr": lrs[k]} for k in p])
    mine = ref_render.Adam(lrs)
    cur = dict(p)
    for step in range(3):
        g = {k: torch.randn_like(v) for k, v in p.items()}
        for k in p:
            leaves[k].grad = g[k].clone()
        opt.step()
        cur = mine.step(cur, g)
        for k in p:
            assert torch.allclose(cur[k], leaves[k].detach(), rtol=0,
                                  atol=1e-7), (step, k)
