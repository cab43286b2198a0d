"""Built-in scenes: the reference's two hard-coded scenes plus the five
benchmark configs from BASELINE.json.

Geometry/materials mirror src/main.cpp:21-131 (populate_cornell_box_scene,
populate_bouncing_spheres_scene) exactly; the random-sphere field uses a
seeded numpy RNG instead of the reference's non-reproducible random_device
stream, so layouts are deterministic per seed.
"""
from __future__ import annotations

import numpy as np

from .schema import (Scene, CameraConfig, Sphere, Quad, Box, Translate,
                     RotateY, ConstantMedium, Lambertian, Metal, Dielectric,
                     DiffuseLight, Isotropic, SolidColor, Checker, Noise)


def _lam(r, g, b):
    return Lambertian(SolidColor((r, g, b)))


def cornell_box() -> Scene:
    """Reference default scene (src/main.cpp:21-71): 5 walls, area light,
    rotated+translated box, glass sphere; lights = light quad + glass sphere."""
    red = _lam(.65, .05, .05)
    white = _lam(.73, .73, .73)
    green = _lam(.12, .45, .15)
    light = DiffuseLight(SolidColor((15.0, 15.0, 15.0)))
    glass = Dielectric(1.5)

    objects = [
        Quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green),
        Quad((0, 0, 555), (0, 0, -555), (0, 555, 0), red),
        Quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white),
        Quad((0, 0, 555), (555, 0, 0), (0, 0, -555), white),
        Quad((555, 0, 555), (-555, 0, 0), (0, 555, 0), white),
        Quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light),
        Translate(RotateY(Box((0, 0, 0), (165, 330, 165), white), 15.0),
                  (265, 0, 295)),
        Sphere((190, 90, 190), 90.0, glass),
    ]
    lights = [
        Quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), _lam(0, 0, 0)),
        Sphere((190, 90, 190), 90.0, _lam(0, 0, 0)),
    ]
    cam = CameraConfig(aspect_ratio=1.0, image_width=600,
                       samples_per_pixel=100, max_depth=50, vfov=40.0,
                       lookfrom=(278, 278, -800), lookat=(278, 278, 0),
                       vup=(0, 1, 0), defocus_angle=0.0, focus_dist=10.0,
                       background=(0, 0, 0))
    return Scene(objects=objects, lights=lights, camera=cam,
                 name="cornell_box")


def cornell_smoke() -> Scene:
    """Cornell box with fog/smoke constant-medium boxes (BASELINE config 4;
    'Rest of your life' cornell-smoke variant of the reference scene)."""
    red = _lam(.65, .05, .05)
    white = _lam(.73, .73, .73)
    green = _lam(.12, .45, .15)
    light = DiffuseLight(SolidColor((7.0, 7.0, 7.0)))

    box1 = Translate(RotateY(Box((0, 0, 0), (165, 330, 165), white), 15.0),
                     (265, 0, 295))
    box2 = Translate(RotateY(Box((0, 0, 0), (165, 165, 165), white), -18.0),
                     (130, 0, 65))
    objects = [
        Quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green),
        Quad((0, 0, 555), (0, 0, -555), (0, 555, 0), red),
        Quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white),
        Quad((0, 0, 555), (555, 0, 0), (0, 0, -555), white),
        Quad((555, 0, 555), (-555, 0, 0), (0, 555, 0), white),
        Quad((113, 554, 127), (330, 0, 0), (0, 0, 305), light),
        ConstantMedium(box1, 0.01, SolidColor((0, 0, 0))),
        ConstantMedium(box2, 0.01, SolidColor((1, 1, 1))),
    ]
    lights = [Quad((443, 554, 432), (-330, 0, 0), (0, 0, -305),
                   _lam(0, 0, 0))]
    cam = CameraConfig(aspect_ratio=1.0, image_width=600,
                       samples_per_pixel=100, max_depth=50, vfov=40.0,
                       lookfrom=(278, 278, -800), lookat=(278, 278, 0),
                       defocus_angle=0.0, background=(0, 0, 0))
    return Scene(objects=objects, lights=lights, camera=cam,
                 name="cornell_smoke")


def bouncing_spheres(seed: int = 3, image_width: int = 1200,
                     spp: int = 100) -> Scene:
    """Reference random-spheres scene (src/main.cpp:73-131): checker ground,
    22x22 random lambertian/metal/glass field with motion blur, 3 hero
    spheres, DOF camera (BASELINE configs 3 and 5)."""
    rng = np.random.default_rng(seed)
    checker = Checker(0.32, SolidColor((.2, .3, .1)), SolidColor((.9, .9, .9)))
    objects = [Sphere((0, -1000, 0), 1000.0, Lambertian(checker))]

    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.uniform()
            center = (a + 0.9 * rng.uniform(), 0.2, b + 0.9 * rng.uniform())
            if np.linalg.norm(np.subtract(center, (4, 0.2, 0))) <= 0.9:
                continue
            if choose < 0.8:
                albedo = tuple(rng.uniform(size=3) * rng.uniform(size=3))
                c2 = (center[0], center[1] + rng.uniform(0, 0.5), center[2])
                objects.append(Sphere(center, 0.2, _lam(*albedo), center2=c2))
            elif choose < 0.95:
                albedo = tuple(rng.uniform(0.5, 1.0, size=3))
                objects.append(Sphere(center, 0.2,
                                      Metal(albedo, rng.uniform(0, 0.5))))
            else:
                objects.append(Sphere(center, 0.2, Dielectric(1.5)))

    objects += [
        Sphere((0, 1, 0), 1.0, Dielectric(1.5)),
        Sphere((-4, 1, 0), 1.0, _lam(0.4, 0.2, 0.1)),
        Sphere((4, 1, 0), 1.0, Metal((0.7, 0.6, 0.5), 0.0)),
    ]
    cam = CameraConfig(aspect_ratio=16.0 / 9.0, image_width=image_width,
                       samples_per_pixel=spp, max_depth=50, vfov=20.0,
                       lookfrom=(13, 2, 3), lookat=(0, 0, 0),
                       defocus_angle=0.6, focus_dist=10.0,
                       background=(0.70, 0.80, 1.00))
    return Scene(objects=objects, lights=[], camera=cam,
                 name="bouncing_spheres")


def simple_sphere() -> Scene:
    """BASELINE config 1: single diffuse sphere + ground, 400x225."""
    objects = [
        Sphere((0, 0, -1), 0.5, _lam(0.5, 0.5, 0.5)),
        Sphere((0, -100.5, -1), 100.0, _lam(0.5, 0.5, 0.5)),
    ]
    cam = CameraConfig(aspect_ratio=16.0 / 9.0, image_width=400,
                       samples_per_pixel=100, max_depth=50, vfov=90.0,
                       lookfrom=(0, 0, 0), lookat=(0, 0, -1),
                       defocus_angle=0.0, focus_dist=1.0,
                       background=(0.70, 0.80, 1.00), sky_gradient=True)
    return Scene(objects=objects, lights=[], camera=cam, name="simple_sphere")


def three_spheres() -> Scene:
    """BASELINE config 2: lambertian/metal/glass material demo + DOF, 64spp."""
    objects = [
        Sphere((0, -100.5, -1), 100.0, _lam(0.8, 0.8, 0.0)),
        Sphere((0, 0, -1.2), 0.5, _lam(0.1, 0.2, 0.5)),
        Sphere((-1, 0, -1), 0.5, Dielectric(1.5)),
        Sphere((-1, 0, -1), 0.4, Dielectric(1.0 / 1.5)),  # hollow bubble
        Sphere((1, 0, -1), 0.5, Metal((0.8, 0.6, 0.2), 1.0)),
    ]
    cam = CameraConfig(aspect_ratio=16.0 / 9.0, image_width=400,
                       samples_per_pixel=64, max_depth=50, vfov=20.0,
                       lookfrom=(-2, 2, 1), lookat=(0, 0, -1),
                       defocus_angle=10.0, focus_dist=3.4,
                       sky_gradient=True)
    return Scene(objects=objects, lights=[], camera=cam, name="three_spheres")


def textured_spheres(seed: int = 5) -> Scene:
    """BASELINE config 3: checker + Perlin textured spheres with motion blur,
    BVH over ~500 spheres."""
    s = bouncing_spheres(seed=seed, image_width=400, spp=64)
    s.objects.append(Sphere((0, 2.5, 2), 1.0, Lambertian(Noise(4.0))))
    s.objects.append(Sphere((-4, 1, 2.5), 1.0, Lambertian(
        Checker(0.6, SolidColor((0.1, 0.1, 0.4)), SolidColor((0.9, 0.9, 0.9))))))
    return Scene(objects=s.objects, lights=[], camera=s.camera,
                 name="textured_spheres", perlin_seed=seed)


BUILTIN_SCENES = {
    "cornell_box": cornell_box,
    "cornell_smoke": cornell_smoke,
    "bouncing_spheres": bouncing_spheres,
    "simple_sphere": simple_sphere,
    "three_spheres": three_spheres,
    "textured_spheres": textured_spheres,
}
