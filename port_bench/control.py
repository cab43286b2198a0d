"""Readings that set a cell's limits: the program's numbers on many seeds
and the control's, in one process (the benchmark's own runs never run
this).

    python3 port_bench/control.py --workload <name> --seeds 1,2,3 [--seconds 3]

For each seed it runs the cell's set-up and a short window at the cell's
own size and load, as run.py does, then prints one JSON line with the
numbers of the sound run ("program"), of the control ("control": the
reference put in the program's place and computed in bfloat16, the
precision below the configuration's float32) and, for a training cell,
of the faults planted in the reference put in the program's place
("faults": the loss over half of the image's rows, the image altered by
5%; a step that leaves the parameters unchanged reads 1 on every leaf's
change by the measure itself).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import run
from harness.common import Context
from harness.loader import Cell, load_json


def readings(cell, seed: int, seconds: float, device, shrink=None,
             control: bool = True) -> dict:
    ctx = Context(cell=cell, seed=seed, device=device,
                  shrink=dict(shrink or {}))
    wl = cell.driver.Workload(ctx)
    wl.setup()
    if cell.mix["driver"] != "train":
        run.run_window(wl, seconds, False)
    wl.release()
    t = time.perf_counter()
    out = {"seed": seed, "program": wl.check()}
    if control and cell.mix["driver"] == "train":
        out["control"] = wl.check(reference=wl.reference_steps(
            dtype=torch.bfloat16))
        half = (0, wl.height // 2)
        out["faults"] = {
            "half_batch": wl.check(reference=wl.reference_steps(rows=half)),
            "answer_altered": wl.check(reference=wl.reference_steps(
                scale=1.05))}
    elif control:
        out["control"] = wl.check(control_dtype=torch.bfloat16)
    out["check_s"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="how many of the seeds, the first, also read the "
                        "control (and a training cell's fault)")
    args = p.parse_args(argv)
    spec = load_json(run.REPO / "BENCHMARK.json")
    cell = Cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = readings(cell, seed, args.seconds, device,
                       control=n < args.control_seeds)
        out["workload"] = args.workload
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
