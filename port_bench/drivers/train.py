"""Optimizer steps back to back, as a training loop that logs its loss.

Set-up builds one training step (make_train_step over the mix's families,
with torch.optim.Adam) on the cell's scene at the mix's image, a target
rendered by the reference at the published parameters from a seed held
apart, and a start drawn from the seed around the published parameters;
it drives that step through its first steps, each with a fresh sample
seed, and the window goes on with the same object. An item is
`step(params, cam, seed_i, target)` with its loss read to the host. Every
`restart_steps` steps the client fits the scene again from the same start
(the parameters copied back, Adam's state cleared), so that a window of any
length, on any seed, sees the same mix of early and late steps and the
scene never drifts far from the published one.

Check: the reference follows the first steps from the same start: each
step's loss, the first gradient (the program's from Adam's first moment
after one step) and the parameters' change over the steps, by the worst
leaf (harness.checks).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import sys
import time

import torch

import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu_torch.models import camera as pt_cam
from real_time_ray_tracing_engine_tpu_torch.parallel import train

from harness import checks, stats
from harness.common import derive, reference_scene
from reference import camera as ref_cam
from reference import opmodel
from reference import render as ref_render


def perturbed(published: dict, ranges: dict, gen: torch.Generator) -> dict:
    """The start: each field's published values with a uniform draw from
    its range ("scale": multiply, "add": add) on the rows whose published
    value is above "above" (all rows where absent), clamped at "min"; a
    field with no range starts at its published values."""
    out = {}
    for k, v in published.items():
        r = ranges.get(k)
        if r is None:
            out[k] = v.clone()
            continue
        lo, hi = r.get("scale", r.get("add"))
        u = torch.rand(v.shape, generator=gen, device=v.device) * (hi - lo) + lo
        new = v * u if "scale" in r else v + u
        if "above" in r:
            rows = v > r["above"]
            new = torch.where(rows, new, v)
        if "min" in r:
            new = torch.clamp(new, min=r["min"])
        out[k] = new.to(v.dtype)
    return out


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = mix = {**ctx.cell.mix, **ctx.shrink}
        self.fields = tuple(mix["fields"])
        self.width, self.height = mix["image_width"], mix["image_height"]
        self.n_strata = math.isqrt(mix["samples_per_pixel"])
        self.paths = self.width * self.height * self.n_strata ** 2
        self.camera = dict(image_width=self.width,
                           aspect_ratio=self.width / self.height,
                           samples_per_pixel=self.n_strata ** 2,
                           max_depth=mix["max_depth"],
                           sky_gradient=mix["sky_gradient"])
        self.k = 0
        self.losses = []
        self.step_ms = []
        self.truth = None       # the reference's steps, once computed

    def step_seed(self, k: int) -> int:
        return derive(self.ctx.seed, k)

    def _kw(self):
        return dict(width=self.width, height=self.height,
                    n_strata=self.n_strata, max_depth=self.mix["max_depth"],
                    sky_gradient=self.mix["sky_gradient"])

    def setup(self):
        dev = self.ctx.device
        t0 = time.perf_counter()
        scene = pt.load_scene(str(self.ctx.cell.config_path))
        scene.camera = dataclasses.replace(scene.camera, **self.camera)
        flat = pt.compile_scene(scene, device=dev)
        self.cam = pt_cam.derive(scene.camera, device=dev)
        self.rflat, self.rcfg = reference_scene(self.ctx, **self.camera)
        self.rcam = ref_cam.derive(self.rcfg, device=dev)
        self.target = ref_render.image(
            self.rflat, self.rcam, seed=derive(self.ctx.seed, -3),
            **self._kw())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(
            derive(self.ctx.seed, -4))
        published = {k: getattr(flat, k) for k in self.fields}
        start = perturbed(published, self.mix["start"], gen)
        self.p0 = {k: v.clone() for k, v in start.items()}
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in start.items()}
        lrs = self.mix["adam_lr"]
        self.opt = torch.optim.Adam([
            {"params": [self.params[k]], "lr": lrs[k]} for k in self.fields])
        self.step = train.make_train_step(self.opt, flat=flat, **self._kw())
        warm = self.ctx.cell.limits["check"]["steps"]
        for k in range(warm):
            self._step()
            if k == 0:
                self.g1 = {n: self._first_gradient(p)
                           for n, p in self.params.items()}
        self.p_warm = {k: v.detach().clone() for k, v in self.params.items()}
        print(f"[train] set-up: scene and target {t1 - t0:.3f} s, the step "
              f"and {warm} steps {time.perf_counter() - t1:.3f} s",
              file=sys.stderr)

    def _first_gradient(self, p):
        """The gradient Adam got at its first step, from its first moment
        (zero where the optimizer holds no state for p)."""
        m = self.opt.state.get(p, {}).get("exp_avg")
        if m is None:
            return torch.zeros_like(p.detach())
        return m.detach() / (1 - self.opt.defaults["betas"][0])

    def _step(self):
        loss = self.step(self.params, self.cam, self.step_seed(self.k),
                         self.target)
        self.losses.append(float(loss))
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        self.k += 1

    def item(self, i: int):
        if self.k % self.mix["restart_steps"] == 0:
            self._restart()
        t = time.perf_counter()
        self._step()
        self.step_ms.append((time.perf_counter() - t) * 1e3)

    def _restart(self):
        """The client fits the scene again from the same start: the
        parameters back to it, Adam's state cleared."""
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(self.p0[n])
        self.opt.state.clear()

    def end_to_end(self, t0: float, items: list) -> dict:
        seconds = items[-1][1] - t0
        fifth = max(1, len(self.step_ms) // 5)
        print(f"[train] {len(items)} steps; median step "
              f"{statistics.median(self.step_ms[:fifth]):.3f} ms in the "
              f"window's first fifth, "
              f"{statistics.median(self.step_ms[-fifth:]):.3f} ms in its "
              f"last", file=sys.stderr)
        rate = stats.rate(len(items) * self.paths, seconds)
        return {"train_mpaths_s": rate / 1e6}

    def facts(self, trace) -> dict:
        """The adjoint's operations over the traced window: its steps,
        times the bounces of a step (its paths times the reference's mean
        path length at the start, over a fixed grid of pixels at every
        sample of the first step's seed), times the op model's adjoint
        bounce."""
        flat = dataclasses.replace(self.rflat, **self.p0)
        n = self.width * self.height
        grid = self.ctx.cell.limits["roofline_pixels"]
        pix = torch.arange(0, n, max(1, n // grid), device=self.ctx.device)
        mean_len = ref_render.mean_path_length(
            flat, self.rcam, width=self.width, pix=pix,
            samples=range(self.n_strata ** 2), seed=self.step_seed(0),
            n_strata=self.n_strata, max_depth=self.mix["max_depth"],
            sky_gradient=self.mix["sky_gradient"])
        ops = (len(trace.spans) * self.paths * mean_len
               * opmodel.adjoint_bounce_ops(flat))
        return {"adjoint_kernel": self.mix["adjoint_kernel"],
                "adjoint_ops": ops, "mean_path_length": mean_len}

    def release(self):
        """Frees the program's step, optimizer, parameters and scene."""
        del self.step, self.opt, self.params, self.cam
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, dtype=None, rows=None, scale=1.0):
        """The reference's losses, first gradient and change over the
        checked steps from the same start (in `dtype`, the control's
        precision; over image rows `rows` or with the image times `scale`,
        two faults)."""
        flat, cam = self.rflat, self.rcam
        params = dict(self.p0)
        if dtype is not None:
            flat, cam = flat.to(dtype=dtype), cam.to(dtype=dtype)
            params = {k: v.to(dtype) for k, v in params.items()}
        adam = ref_render.Adam(self.mix["adam_lr"])
        losses, g1 = [], None
        for k in range(self.ctx.cell.limits["check"]["steps"]):
            loss, g = ref_render.loss_grad(
                flat, params, cam, self.target, seed=self.step_seed(k),
                rows=rows, scale=scale, **self._kw())
            losses.append(loss)
            g = {n: v.float() for n, v in g.items()}
            g1 = g if g1 is None else g1
            params = adam.step({n: v.float() for n, v in params.items()}, g)
            if dtype is not None:
                params = {n: v.to(dtype) for n, v in params.items()}
        change = {n: v.float() - self.p0[n] for n, v in params.items()}
        return losses, g1, change

    def check(self, reference=None) -> dict:
        """The numbers compared. `reference` gives the reference's
        (losses, g1, change) computed elsewhere (the control)."""
        steps = self.ctx.cell.limits["check"]["steps"]
        if self.truth is None:
            self.truth = self.reference_steps()
        r_losses, r_g1, r_change = self.truth
        if reference is None:
            p_losses, p_g1 = self.losses[:steps], self.g1
            p_change = {n: self.p_warm[n] - self.p0[n] for n in self.fields}
        else:
            p_losses, p_g1, p_change = reference
        norms = {n: float(v.double().norm()) for n, v in r_g1.items()}
        med = statistics.median(norms.values())
        moved = [n for n in self.fields if norms[n] >= 1e-3 * med]
        grad_gaps = checks.leaf_norm_gaps(p_g1, r_g1)
        change_gaps = checks.leaf_norm_gaps(p_change, r_change, keep=moved)
        out = {"loss1_gap": checks.rel_gap(p_losses[0], r_losses[0]),
               "grad_gap": max(grad_gaps.values()),
               "change_gap_median": statistics.median(change_gaps.values()),
               # the worst leaf's change and every step's loss, beside the
               # numbers compared (PERF.md: why these are not compared)
               "change_gap": max(change_gaps.values()),
               "loss_gap": max(checks.rel_gap(a, b)
                               for a, b in zip(p_losses, r_losses))}
        for n in self.fields:
            lr = self.mix["adam_lr"][n]
            one_sided = ((p_change[n].abs() > 0.5 * lr)
                         != (r_change[n].abs() > 0.5 * lr)).sum()
            out[f"grad_gap.{n}"] = grad_gaps[n]
            out[f"change_gap.{n}"] = change_gaps.get(n, math.nan)
            out[f"one_sided.{n}"] = float(one_sided)
        return out
