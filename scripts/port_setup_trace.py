"""Where a benchmark cell's set-up goes: the cell's Workload.setup() (the
scene, the kernel library, the warm items: for training the reference's
target and the first steps) under torch.profiler, split by the program's
spans (rt.*) and by the host events inside the first of a span.

    python3 scripts/port_setup_trace.py --workload bouncing_spheres.train_adjoint
    python3 scripts/port_setup_trace.py --workload cornell_box.render --first rt.render

Prints, for each span name, its occurrences' lengths and their exposed
time (less the device's intervals inside them); then the host events
that lie inside the first span named --first, summed by name, longest
first. Starting torch.profiler imports modules the program would
otherwise import at its first call (the first line names them), so
--python runs the set-up under Python's cProfile instead, with no
torch.profiler, and prints the functions that took longest. Needs a CUDA
card, as the benchmark does.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "port_bench"
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import spans as hspans, stats, tracing  # noqa: E402
from harness.common import Context  # noqa: E402
from harness.loader import Cell, load_json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--first", default="rt.train.step",
                    help="the span whose first occurrence is split")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--python", action="store_true",
                    help="cProfile the set-up instead of torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_setup_trace: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = Cell(load_json(REPO / "BENCHMARK.json"), args.workload)
    wl = cell.driver.Workload(Context(cell=cell, seed=args.seed, device=dev))
    if args.python:
        return python_profile(wl, dev, args.top)
    before = set(sys.modules)
    t0 = time.perf_counter()
    prof = tracing.start(dev)
    new = sorted(m for m in set(sys.modules) - before
                 if m.count(".") <= 1)
    print(f"starting torch.profiler: {time.perf_counter() - t0:.3f} s, "
          f"{len(set(sys.modules) - before)} modules imported "
          f"({', '.join(new[:12])})")
    t0 = time.perf_counter()
    with torch.profiler.record_function(tracing.WINDOW):
        wl.setup()
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    trace = tracing.stop(prof)
    print(f"{args.workload} set-up under the profiler: {wall:.3f} s wall, "
          f"traced window {trace.window_s:.3f} s, device busy "
          f"{stats.busy_ns(trace.device, trace.window) / 1e9:.3f} s")
    names = sorted({n for n, _, _ in trace.host if n.startswith("rt.")})
    for name in names:
        lens = [(e - s) / 1e6 for n, s, e in trace.host if n == name]
        got = hspans.exposed_ns(trace, name)
        exposed = got[0] / 1e6 if got else float("nan")
        head = ", ".join(f"{x:.2f}" for x in lens[:6])
        print(f"  {name}: {len(lens)} spans, {sum(lens):.2f} ms "
              f"({head}{', ...' if len(lens) > 6 else ''}), exposed "
              f"{exposed:.2f} ms")
    first = min(((s, e) for n, s, e in trace.host if n == args.first),
                default=None)
    if first is None:
        print(f"no span named {args.first}")
        return 0
    lo, hi = first
    tot = {}
    for n, s, e in trace.host:
        if s >= lo and e <= hi and (s, e) != first:
            tot[n] = tot.get(n, 0) + (e - s)
    print(f"inside the first {args.first} ({(hi - lo) / 1e6:.2f} ms; host "
          f"events summed by name, nested ones counted in each):")
    for n, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {ns / 1e6:10.2f} ms  {stats.short(n, 100)}")
    return 0


def python_profile(wl, dev, top: int) -> int:
    import cProfile
    import pstats
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    wl.setup()
    torch.cuda.synchronize(dev)
    pr.disable()
    print(f"set-up under cProfile: {time.perf_counter() - t0:.3f} s wall")
    pstats.Stats(pr, stream=sys.stdout).sort_stats("cumulative") \
        .print_stats(top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
