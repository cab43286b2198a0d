"""Whole renders, back to back, as one client renders image after image.

An item is `render(scene, device=..., seed=...)` from the schema Scene that
`load_scene` gave for the cell's scene file, at the file's own camera: the
scene compile, the packing and every pass are paid each image, as the CLI
pays them. It ends when the image is on the card after a synchronise.

Check: the images of a few renders drawn from the seed, and the last one,
each at pixels drawn from the seed, against the reference's mean over the
same samples of the same render seed.
"""
from __future__ import annotations

import random

import torch

import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu_torch.models import camera as pt_cam

from harness import checks, stats
from harness.common import (camera_of, cpu_generator, derive,
                            reference_pixels, reference_scene,
                            sample_pixels)
from reference import opmodel
from reference import render as ref_render
from reference import camera as ref_cam


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        self.scene = pt.load_scene(str(ctx.cell.config_path))
        self.scene.camera = camera_of(self.scene, ctx)
        self.width, self.height = pt_cam.image_size(self.scene.camera)
        self.spp = pt_cam.sqrt_spp(self.scene.camera) ** 2
        self.paths = self.width * self.height * self.spp
        chk = ctx.cell.limits["check"]
        pick = random.Random(derive(ctx.seed, -1))
        self.keep = set(pick.sample(range(chk["among_first"]),
                                    chk["images"]))
        self.kept = {}
        self.last = None

    def render_seed(self, i: int) -> int:
        return derive(self.ctx.seed, i)

    def setup(self):
        """One render at another seed: loads the kernel library and warms
        the only shapes the window uses."""
        pt.render(self.scene, device=self.ctx.device,
                  seed=self.render_seed(-2))
        _sync(self.ctx.device)

    def item(self, i: int):
        img = pt.render(self.scene, device=self.ctx.device,
                        seed=self.render_seed(i))
        _sync(self.ctx.device)
        if i in self.keep:
            self.kept[i] = img
        self.last = (i, img)

    def end_to_end(self, t0: float, items: list) -> dict:
        seconds = items[-1][1] - t0
        rate = stats.rate(len(items) * self.paths, seconds)
        return {"render_mpaths_s": rate / 1e6}

    def facts(self, trace) -> dict:
        """The forward's operations over the traced window: the renders in
        it, times the bounces of an image (its paths times the reference's
        mean path length over a fixed grid of pixels, at every sample of
        the first render's seed), times the op model's bounce."""
        flat, cfg = reference_scene(self.ctx)
        n = self.width * self.height
        grid = self.ctx.cell.limits["roofline_pixels"]
        pix = torch.arange(0, n, max(1, n // grid), device=self.ctx.device)
        cam = ref_cam.derive(cfg, device=self.ctx.device)
        mean_len = ref_render.mean_path_length(
            flat, cam, width=self.width, pix=pix, samples=range(self.spp),
            seed=self.render_seed(0), n_strata=ref_cam.sqrt_spp(cfg),
            max_depth=cfg.max_depth, sky_gradient=cfg.sky_gradient)
        ops = (len(trace.spans) * self.paths * mean_len
               * opmodel.forward_bounce_ops(flat))
        return {"forward_kernel": self.ctx.cell.config["forward_kernel"],
                "forward_ops": ops, "mean_path_length": mean_len}

    def release(self):
        """The kept images are what the check reads; nothing else stays."""
        self.kept.setdefault(*self.last)
        self.last = None

    def check(self, control_dtype=None) -> dict:
        flat, cfg = reference_scene(self.ctx)
        chk = self.ctx.cell.limits["check"]
        progs, refs = [], []
        for i in sorted(self.kept):
            pix = sample_pixels(self.width * self.height, chk["pixels"],
                                cpu_generator(derive(self.ctx.seed, 10 ** 6 + i)))
            ref = reference_pixels(flat, cfg, pix, range(self.spp),
                                   self.render_seed(i), self.ctx.device)
            if control_dtype is None:
                prog = self.kept[i].reshape(-1, 3)[pix.to(self.ctx.device)]
            else:
                prog = reference_pixels(flat, cfg, pix, range(self.spp),
                                        self.render_seed(i), self.ctx.device,
                                        dtype=control_dtype)
            progs.append(prog)
            refs.append(ref)
        return {"px_off_share": checks.px_off_share(torch.cat(progs),
                                                    torch.cat(refs)),
                "images_compared": float(len(progs))}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
