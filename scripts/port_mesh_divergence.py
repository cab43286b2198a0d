#!/usr/bin/env python3
"""How far the PyTorch + CUDA port's full-family training moves when one
parameter moves by one float32 ulp, and where a mesh's training leaves the
one-process trajectory, on one GPU.

    python3 scripts/port_mesh_divergence.py [--out FILE]

The problem is chip_smoke.py's full-family training (full_train_main_path):
Cornell 1920x1080 spp64 d50, all five trainable families from
full_family_start, the target the render at the true parameters,
TRAIN_SEED, MESH_STEPS steps. Two optimizers: chip_smoke.py's
full_family_adam (torch's eps 1e-8) and the same with each group's eps a
thousandth of the group's largest first-step gradient ("scaled_eps"). For
each optimizer it runs

  - the one-process trajectory (make_train_step, no mesh);
  - the same from the start with one coordinate of the glass sphere's
    center moved one float32 ulp up (torch.nextafter), once for each of
    its three coordinates;
  - make_train_step(mesh=) on two ranks sharing the card over gloo
    (parallel/distributed.py::spawn_ranks), layouts (2, 1) and (1, 2).

Every run is held to the one-process trajectory of its optimizer, step by
step: the loss and its difference relative to the trajectory's, each
family's gradient difference over the trajectory's largest entry of that
family, the glass sphere's center-gradient row's difference over that
row's largest entry, and each family's largest parameter difference after
the step. One JSON line a run after the card's name and power limit
(nvidia-smi), also written to FILE with --out.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ULP_EPS_FRACTION = 1e-3   # scaled_eps: eps over a group's largest gradient


def problem(torch, dev):
    """(train, flat, cam, kw, target, start, glass sphere row) of
    full_train_main_path on `dev`."""
    import real_time_ray_tracing_engine_tpu_torch as pt
    from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
    from real_time_ray_tracing_engine_tpu_torch.parallel import train
    flat, cam, kw = cs.pass_args(
        pt, cs.cornell_1080p(pt, cs.TRAIN_SPP, cs.TRAIN_DEPTH), dev)
    kw.pop("n_samples")
    target = train.make_kernel_render(flat, engine="cuda", **kw)(
        {"tex_color": flat.tex_color}, cam, cs.TRAIN_SEED).detach()
    _, _, glass_rows, start = cs.full_family_start(wc, train, flat)
    return train, flat, cam, kw, target, start, glass_rows[0]


def steps(torch, prob, dev, eps, mesh=None, nudge=None) -> list:
    """MESH_STEPS steps from the start (nudge (row, coordinate): that
    center coordinate one ulp up first) under full_family_adam with the
    groups' eps `eps` (None: torch's); per step the loss, the gradients
    and the parameters after the update, on the CPU."""
    train, flat, cam, kw, target, start, _ = prob
    params = {k: v.to(dev).clone() for k, v in start.items()}
    if nudge is not None:
        c = params["sph_center"]
        c[nudge] = torch.nextafter(c[nudge], c[nudge] + 1.0)
    for v in params.values():
        v.requires_grad_(True)
    opt = cs.full_family_adam(torch, params)
    if eps is not None:
        for group, e in zip(opt.param_groups, eps):
            group["eps"] = e
    step = train.make_train_step(opt, flat=flat, engine="cuda", mesh=mesh,
                                 **kw)
    out = []
    for _ in range(cs.MESH_STEPS):
        loss = float(step(params, cam, cs.TRAIN_SEED, target))
        out.append({"loss": loss,
                    "grads": {k: v.grad.detach().cpu().clone()
                              for k, v in params.items()},
                    "params": {k: v.detach().cpu().clone()
                               for k, v in params.items()}})
    return out


def compare(run, ref, glass: int) -> list:
    """run's steps against the reference trajectory's, step by step."""
    rows = []
    for a, b in zip(run, ref):
        gc, gc0 = a["grads"]["sph_center"][glass], b["grads"]["sph_center"][
            glass]
        rows.append({
            "loss": a["loss"], "trajectory_loss": b["loss"],
            "loss_rel_diff": abs(a["loss"] - b["loss"]) / b["loss"],
            "grad_rel_diff": {
                k: (float((g - b["grads"][k]).abs().max())
                    / max(float(b["grads"][k].abs().max()), 1e-30))
                for k, g in a["grads"].items()},
            "glass_center_grad": gc.tolist(),
            "trajectory_glass_center_grad": gc0.tolist(),
            "glass_center_grad_rel_diff": float((gc - gc0).abs().max())
            / float(gc0.abs().max()),
            "params_max_abs_diff": {
                k: float((p - b["params"][k]).abs().max())
                for k, p in a["params"].items()}})
    return rows


def rank_worker(rank, n, init_method, job):
    """One of two ranks on the card: the mesh steps of every (optimizer,
    layout) of `job`."""
    import torch
    from real_time_ray_tracing_engine_tpu_torch.parallel import distributed
    from real_time_ray_tracing_engine_tpu_torch.parallel import mesh as pm
    distributed.initialize(device="cuda", init_method=init_method, rank=rank,
                           world_size=n, local_rank=rank, local_world_size=n)
    dev = torch.device("cuda", torch.cuda.current_device())
    prob = problem(torch, dev)
    out = {}
    for name, eps in job["optimizers"].items():
        for layout in job["layouts"]:
            mesh = pm.make_render_mesh(*layout)
            out[(name, layout)] = steps(torch, prob, dev, eps, mesh=mesh)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    import torch
    from real_time_ray_tracing_engine_tpu_torch.parallel import distributed
    if not torch.cuda.is_available():
        print("port_mesh_divergence: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lines = [cs.gpu_line()]
    print(lines[0], flush=True)

    def emit(**rec):
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    prob = problem(torch, dev)
    glass = prob[-1]
    base = steps(torch, prob, dev, None)
    g0 = base[0]["grads"]
    groups = (("tex_color", "mat_ior", "mat_fuzz"),
              ("sph_center", "sph_radius"))
    scaled = tuple(ULP_EPS_FRACTION * max(float(g0[k].abs().max())
                                         for k in grp) for grp in groups)
    optimizers = {"default_eps": None, "scaled_eps": scaled}
    refs = {"default_eps": base,
            "scaled_eps": steps(torch, prob, dev, scaled)}
    for name, eps in optimizers.items():
        emit(run="one_process", optimizer=name, eps=eps, glass_row=glass,
             losses=[s["loss"] for s in refs[name]],
             glass_center_after=[s["params"]["sph_center"][glass].tolist()
                                 for s in refs[name]])
        for coord in range(3):
            run = steps(torch, prob, dev, eps, nudge=(glass, coord))
            emit(run="one_ulp", optimizer=name, eps=eps,
                 nudged=[glass, coord],
                 start=float(prob[5]["sph_center"][glass, coord]),
                 steps=compare(run, refs[name], glass))
    del prob
    torch.cuda.empty_cache()
    layouts = ((2, 1), (1, 2))
    ranks = distributed.spawn_ranks(
        rank_worker, 2, {"optimizers": optimizers, "layouts": layouts},
        timeout_s=cs.RANKS_S)
    for name in optimizers:
        for layout in layouts:
            runs = [r[(name, layout)] for r in ranks]
            same = all(torch.equal(runs[0][i]["params"][k],
                                   runs[1][i]["params"][k])
                       for i in range(cs.MESH_STEPS)
                       for k in runs[0][i]["params"])
            emit(run="mesh_ranks", optimizer=name, layout=layout,
                 backend="gloo, two ranks on one card",
                 params_equal_across_ranks=same,
                 steps=compare(runs[0], refs[name], glass))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
