"""The dynamic camera at the reference's pace: one stratum a frame.

An item is a frame of `ProgressiveRenderer`: a camera move when the plan
says so (`move_camera`, which resets the accumulation), then `step(1)`,
then `image()`, ready on the card. The plan alternates walks (a move of
the mix's step every frame, in one direction) and looks (no move, the
image converging); every walk is later walked back, so the camera stays
near home. The phase lengths are one fixed set drawn from the mix's
layout seed; --seed only orders them and the directions.

A frame is timed on the card's clock by CUDA events recorded as the frame
starts (the stream is idle, so the event fires as the host reaches it) and
after image(), then synchronised: the time a viewer waits before it can
display, read without the host clock's jitter.

Check: the accumulated images of a few frames drawn from the seed, and of
the last one, each at pixels drawn from the seed, against the reference's
mean over the strata accumulated since the last move, at that frame's
camera.
"""
from __future__ import annotations

import dataclasses
import random
import sys
import time

import torch

import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu_torch.models import camera as pt_cam

from harness import checks, stats
from harness.common import (camera_of, cpu_generator, derive,
                            reference_pixels, reference_scene,
                            sample_pixels)
from reference import camera as ref_cam
from reference import opmodel
from reference import render as ref_render


def frame_plan(mix: dict, seed: int) -> list:
    """One cycle of frames: a move delta (x, y, z) or None for each."""
    layout = random.Random(mix["layout_seed"])
    order = random.Random(derive(seed, -5))
    walks = [layout.randint(*mix["walk_frames"])
             for _ in range(mix["walks"])]
    looks = [layout.randint(*mix["look_frames"])
             for _ in range(2 * mix["walks"])]
    order.shuffle(walks)
    order.shuffle(looks)
    keys = sorted(mix["moves"])
    plan = []
    for w, walk in enumerate(walks):
        if w % len(keys) == 0:
            order.shuffle(keys)
        step = [mix["step"] * c for c in mix["moves"][keys[w % len(keys)]]]
        back = [-c for c in step]
        for delta, look in ((step, looks[2 * w]), (back, looks[2 * w + 1])):
            plan += [tuple(delta)] * walk + [None] * look
    return plan


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        self.scene = pt.load_scene(str(ctx.cell.config_path))
        self.scene.camera = camera_of(self.scene, ctx)
        self.width, self.height = pt_cam.image_size(self.scene.camera)
        self.plan = frame_plan(ctx.cell.mix, ctx.seed)
        chk = ctx.cell.limits["check"]
        pick = random.Random(derive(ctx.seed, -1))
        self.keep = set(pick.sample(range(chk["among_first"]),
                                    chk["frames"]))
        self.kept = {}
        self.last = None
        self.frame_ms = []
        self.moves = 0
        self.cuda = ctx.device.type == "cuda"

    def setup(self):
        """The scene compiled and packed once; a warm frame with and one
        without a move, back home, the accumulation reset."""
        self.seed = derive(self.ctx.seed, -6)
        self.prog = pt.ProgressiveRenderer(self.scene, device=self.ctx.device,
                                           seed=self.seed)
        # the camera and the strata since the last move, as the benchmark
        # moved it (the reference's view, apart from the program's state)
        self.eye = (tuple(self.scene.camera.lookfrom),
                    tuple(self.scene.camera.lookat))
        self.taken = 0
        for delta in ((self.ctx.cell.mix["step"], 0.0, 0.0), None):
            if delta is not None:
                self.prog.move_camera(delta)
            self.prog.step(1)
            self.prog.image()
        self.prog.move_camera((-self.ctx.cell.mix["step"], 0.0, 0.0))
        self.prog.reset()
        if self.cuda:
            torch.cuda.synchronize(self.ctx.device)
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))

    def item(self, i: int):
        delta = self.plan[i % len(self.plan)]
        if self.cuda:
            self.ev[0].record()
        else:
            t0 = time.perf_counter()
        if delta is not None:
            self.prog.move_camera(delta)
            self.moves += 1
            self.eye = tuple(tuple(a + b for a, b in zip(v, delta))
                             for v in self.eye)
            self.taken = 0
        self.prog.step(1)
        self.taken += 1
        img = self.prog.image()
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            self.frame_ms.append(self.ev[0].elapsed_time(self.ev[1]))
        else:
            self.frame_ms.append((time.perf_counter() - t0) * 1e3)
        self.last = (i, (img, self.eye, self.taken))
        if i in self.keep:
            self.kept[i] = self.last[1]

    def end_to_end(self, t0: float, items: list) -> dict:
        ms = self.frame_ms
        print(f"[frame] {len(ms)} frames, {self.moves} with a move; "
              f"median {stats.percentile(ms, 50):.4f} ms, p95 "
              f"{stats.percentile(ms, 95):.4f} ms, "
              f"{len(ms) / (items[-1][1] - t0):.1f} frames/s",
              file=sys.stderr)
        return {"frame_ms_p95": stats.percentile(ms, 95)}

    def facts(self, trace) -> dict:
        """K1's operations over the traced window: its frames, times the
        image's paths (one stratum), times the reference's mean path
        length at the home camera over a fixed grid of pixels at the first
        strata, times the op model's bounce."""
        flat, cfg = reference_scene(self.ctx)
        n = self.width * self.height
        grid = self.ctx.cell.limits["roofline_pixels"]
        pix = torch.arange(0, n, max(1, n // grid), device=self.ctx.device)
        cam = ref_cam.derive(cfg, device=self.ctx.device)
        strata = self.ctx.cell.limits["roofline_strata"]
        mean_len = ref_render.mean_path_length(
            flat, cam, width=self.width, pix=pix, samples=range(strata),
            seed=self.seed, n_strata=ref_cam.sqrt_spp(cfg),
            max_depth=cfg.max_depth, sky_gradient=cfg.sky_gradient)
        ops = len(trace.spans) * n * mean_len * opmodel.forward_bounce_ops(flat)
        return {"forward_kernel": self.ctx.cell.config["forward_kernel"],
                "forward_ops": ops, "mean_path_length": mean_len}

    def release(self):
        self.kept.setdefault(*self.last)
        del self.prog
        if self.cuda:
            torch.cuda.empty_cache()

    def check(self, control_dtype=None) -> dict:
        flat, home = reference_scene(self.ctx)
        chk = self.ctx.cell.limits["check"]
        progs, refs = [], []
        for i in sorted(self.kept):
            img, (lookfrom, lookat), taken = self.kept[i]
            cfg = dataclasses.replace(home, lookfrom=lookfrom, lookat=lookat)
            pix = sample_pixels(self.width * self.height, chk["pixels"],
                                cpu_generator(derive(self.ctx.seed, 10 ** 6 + i)))
            ref = reference_pixels(flat, cfg, pix, range(taken), self.seed,
                                   self.ctx.device)
            if control_dtype is None:
                prog = img.reshape(-1, 3)[pix.to(self.ctx.device)]
            else:
                prog = reference_pixels(flat, cfg, pix, range(taken),
                                        self.seed, self.ctx.device,
                                        dtype=control_dtype)
            progs.append(prog)
            refs.append(ref)
        return {"px_off_share": checks.px_off_share(torch.cat(progs),
                                                    torch.cat(refs)),
                "frames_compared": float(len(progs))}
