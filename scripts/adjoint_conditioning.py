#!/usr/bin/env python3
"""How far the port's four differentiation routes part on ill-conditioned
sums, and what drives the full-family training's learning rates, on one GPU.

    python3 scripts/adjoint_conditioning.py

The adjoint kernel (K9), its plain version (torch autograd a bounce at a
time), the forward-mode kernels (K4 on Cornell, K4v on bouncing_spheres)
and their plain version (torch.func.jvp) compute one derivative of one
estimator; each pair of a kernel and its plain version agrees to rounding
on well-conditioned sums (chip_smoke.py). This script measures where they
part further and checks chip_smoke.py's choice of ADJ_GEOM_LR, one JSON
line each:

  - Cornell's 9 hard slots at 600x600 spp4, depths 8, 16 and 50 (K9
    against K4), and at 200x200 spp4 d50 all four routes: a path that
    grazes the inside of the glass sphere has near-tangent roots, whose
    derivatives each route rounds differently;
  - Cornell 600x600 spp4 d50 band by band of 10 image rows (the cotangent
    kept on those rows only): each band's largest slot gap between K9 and
    K4 beside its deepest lane; then on the two bands that part most, all
    four routes and the plain adjoint on float64 tables (which trace other
    paths: float64 rounds those roots apart), with each route's bounces on
    those rows;
  - bouncing_spheres' one IOR entry under the sky gradient at 64x36 and
    128x72 spp4 (depths 8, 16, 50 at 64): at 64 px the entry is a sum
    that cancels to a small fraction of its terms;
  - the learning rates of the full-family training (chip_smoke.py's
    adjoint_train_main_path start): 4 Adam steps on bouncing_spheres under
    the sky gradient at 400x225 spp4 d50 with the geometry at TRAIN_LR and
    at ADJ_GEOM_LR, through the kernels (K9) and through the plain engine
    (the plain adjoint), and at 1200x675 spp16 d50 with every family at
    TRAIN_LR through K9.

It never imports JAX.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (stdlib only at import)


def slot_values(grads, slots, wc):
    return [float(grads[wc.slot_index(s)[0]][wc.slot_index(s)[1]])
            for s in slots]


def float64_tables(torch, flat):
    """The scene with its floating tables in float64."""
    return dataclasses.replace(flat, **{
        f.name: getattr(flat, f.name).double()
        for f in dataclasses.fields(flat)
        if torch.is_tensor(getattr(flat, f.name))
        and getattr(flat, f.name).is_floating_point()})


def cornell_bands(torch, pt, ac, wc, dev):
    """The Cornell d50 band sweep and the four routes on its worst bands."""
    flat, cam, kw = cs.pass_args(
        pt, cs.builtin(pt, "cornell_box", 600, 4, 50), dev)
    slots = wc.hard_param_slots(flat)
    g = cs.cotangent(torch, kw, dev, 6)
    aprep = wc.prepare_kernel(flat, cam, chunk_scan=True)
    hprep = wc.prepare_kernel(flat, cam, slots)
    n_lanes = wc.lane_count(kw["width"] * kw["height"])
    W, H = kw["width"], kw["height"]

    def rows_of(it):
        return it[:W * H].view(H, W)

    def kernels(cot, it_a=None, it_h=None):
        _, gr = ac.render_pass_adjoint_kernel(
            flat, cam, 7, 0, cotangent=cot, prepared=aprep, iters=it_a, **kw)
        _, _, dgh = wc.render_pass_grad_kernel(
            flat, cam, 7, 0, cotangent=cot, hard_slots=slots,
            prepared=hprep, iters=it_h, **kw)
        return slot_values(gr, slots, wc), dgh.tolist()

    it = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    kernels(g, it_h=it)
    deep = rows_of(it)
    bands = []
    for r0 in range(0, H, 10):
        gm = torch.zeros_like(g)
        gm[r0:r0 + 10] = g[r0:r0 + 10]
        k9, k4 = kernels(gm)
        bands.append((max(abs(a - b) for a, b in zip(k9, k4)), r0,
                      int(deep[r0:r0 + 10].max())))
    bands.sort(reverse=True)
    print(json.dumps({
        "case": "cornell 600x600 spp4 d50, K9 against K4 by band of 10 rows",
        "worst": [{"rows": f"{r0}-{r0 + 9}", "gap": gap,
                   "deepest_lane_bounces": d} for gap, r0, d in bands[:6]],
        "median_band_gap": bands[len(bands) // 2][0],
        "median_band_deepest_lane_bounces": bands[len(bands) // 2][2]}),
        flush=True)

    rows = sorted(r0 for _, r0, _ in bands[:2])
    gm = torch.zeros_like(g)
    for r0 in rows:
        gm[r0:r0 + 10] = g[r0:r0 + 10]
    keep = (gm.abs().sum(-1) > 0)

    def on_rows(it):
        r = rows_of(it)[keep]
        return {"bounces": int(r.sum()), "deepest_lane": int(r.max())}

    its = {k: torch.zeros(n_lanes, dtype=torch.int32, device=dev)
           for k in ("k9", "k4", "plain_adjoint", "plain_tangent",
                     "plain_adjoint_f64")}
    rec = {"case": "cornell 600x600 spp4 d50, the cotangent on rows "
                   + ", ".join(f"{r0}-{r0 + 9}" for r0 in rows),
           "slots": [list(s) for s in slots]}
    rec["k9"], rec["k4"] = kernels(gm, its["k9"], its["k4"])
    _, grp = ac.render_pass_adjoint_reference(
        flat, cam, 7, 0, cotangent=gm, iters=its["plain_adjoint"], **kw)
    rec["plain_adjoint"] = slot_values(grp, slots, wc)
    _, _, tan = wc.render_pass_grad_reference(
        flat, cam, 7, 0, cotangent=gm, hard_slots=slots,
        iters=its["plain_tangent"], **kw)
    rec["plain_tangent"] = tan.tolist()
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        _, gr64 = ac.render_pass_adjoint_reference(
            float64_tables(torch, flat), cam, 7, 0, cotangent=gm,
            iters=its["plain_adjoint_f64"], **kw)
    finally:
        torch.set_default_dtype(default)
    rec["plain_adjoint_f64"] = slot_values(gr64, slots, wc)
    rec["rows"] = {k: on_rows(v) for k, v in its.items()}
    lanes_apart = rows_of(its["plain_adjoint_f64"] != its["plain_adjoint"])
    rec["lanes_whose_f64_bounces_differ"] = int(lanes_apart[keep].sum())
    rec["lanes_on_rows"] = int(keep.sum())

    def gap(a, b):
        return max(abs(x - y) for x, y in zip(rec[a], rec[b]))
    rec["gaps"] = {f"{a} - {b}": gap(a, b) for a, b in (
        ("k9", "k4"), ("k9", "plain_adjoint"), ("k4", "plain_tangent"),
        ("plain_adjoint", "plain_tangent"), ("plain_adjoint", "k4"),
        ("plain_tangent", "k9"), ("plain_adjoint_f64", "k9"),
        ("plain_adjoint_f64", "k4"))}
    print(json.dumps(rec), flush=True)


def learning_rates(torch, pt, ac, wc, train, dev):
    """4 Adam steps from the adjoint training's start at both geometry
    rates, on the kernels and on the plain engine; the losses."""
    for width, spp, engines, rates in (
            (400, 4, ("cuda", "torch"), (cs.TRAIN_LR, cs.ADJ_GEOM_LR)),
            (1200, 16, ("cuda",), (cs.TRAIN_LR,))):
        for engine in engines:
            for geom_lr in rates:
                flat, cam, kw = cs.pass_args(
                    pt, cs.builtin(pt, "bouncing_spheres", width, spp, 50),
                    dev)
                kw.pop("n_samples")
                kw["sky_gradient"] = True
                params, target = cs.adjoint_training_start(
                    torch, train, wc, flat, cam, kw, engine)
                step = train.make_train_step(
                    cs.adjoint_optimizer(torch, params, geom_lr), flat=flat,
                    engine=engine, **kw)
                k9 = ac.render_pass_adjoint_kernel.launches
                plain = ac.render_pass_adjoint_reference.calls
                losses = [float(step(params, cam, cs.TRAIN_SEED, target))
                          for _ in range(cs.LARGE_STEPS)]
                print(json.dumps({
                    "case": f"bouncing {kw['width']}x{kw['height']} spp{spp}"
                            " d50 sky gradient, all five families",
                    "engine": engine, "lr": cs.TRAIN_LR,
                    "geometry_lr": geom_lr, "losses": losses,
                    "falls_every_step": all(
                        b < a for a, b in zip(losses, losses[1:])),
                    "k9_launches": ac.render_pass_adjoint_kernel.launches
                    - k9,
                    "plain_adjoint_calls":
                        ac.render_pass_adjoint_reference.calls - plain}),
                    flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import real_time_ray_tracing_engine_tpu_torch as pt
    from real_time_ray_tracing_engine_tpu_torch.ops import adjoint_cuda as ac
    from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
    from real_time_ray_tracing_engine_tpu_torch.parallel import train
    print(cs.gpu_line(), flush=True)
    dev = torch.device("cuda", 0)
    for width, depth, plain in ((600, 8, False), (600, 16, False),
                                (600, 50, False), (200, 50, True)):
        flat, cam, kw = cs.pass_args(
            pt, cs.builtin(pt, "cornell_box", width, 4, depth), dev)
        slots = wc.hard_param_slots(flat)
        g = cs.cotangent(torch, kw, dev, 6)
        _, gr = ac.render_pass_adjoint_kernel(flat, cam, 7, 0, cotangent=g,
                                              **kw)
        _, _, k4 = wc.render_pass_grad_kernel(flat, cam, 7, 0, cotangent=g,
                                              hard_slots=slots, **kw)
        rec = {"case": f"cornell {width}x{width} spp4 d{depth}",
               "slots": [list(s) for s in slots],
               "k9": slot_values(gr, slots, wc), "k4": k4.tolist()}
        if plain:
            _, grp = ac.render_pass_adjoint_reference(flat, cam, 7, 0,
                                                      cotangent=g, **kw)
            _, _, tan = wc.render_pass_grad_reference(
                flat, cam, 7, 0, cotangent=g, hard_slots=slots, **kw)
            rec["plain_adjoint"] = slot_values(grp, slots, wc)
            rec["plain_tangent"] = tan.tolist()
        print(json.dumps(rec), flush=True)
    cornell_bands(torch, pt, ac, wc, dev)
    for width, depth in ((64, 8), (64, 16), (64, 50), (128, 16)):
        flat, cam, kw = cs.pass_args(
            pt, cs.builtin(pt, "bouncing_spheres", width, 4, depth), dev)
        kw["sky_gradient"] = True
        g = cs.cotangent(torch, kw, dev, 5)
        (slot,) = wc.hard_param_slots(flat, {"mat_ior"})
        _, gk = ac.render_pass_adjoint_kernel(flat, cam, 7, 0, cotangent=g,
                                              **kw)
        _, gp = ac.render_pass_adjoint_reference(flat, cam, 7, 0,
                                                 cotangent=g, **kw)
        tan = [wc.render_pass_grad_kernel, wc.render_pass_grad_reference]
        tan = [float(fn(flat, cam, 7, 0, cotangent=g, hard_slots=(slot,),
                        want_tex=False, **kw)[2][0]) for fn in tan]
        print(json.dumps({
            "case": f"bouncing {kw['width']}x{kw['height']} spp4 d{depth}"
                    " sky gradient", "ior": {
                        "k9": float(gk["mat_ior"][slot[1]]),
                        "plain_adjoint": float(gp["mat_ior"][slot[1]]),
                        "k4v": tan[0], "plain_tangent": tan[1]},
            "families": cs.adjoint_errors(gk, gp)}), flush=True)
    learning_rates(torch, pt, ac, wc, train, dev)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
