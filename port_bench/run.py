"""One run of one benchmark cell of the PyTorch + CUDA port.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: the cell's configuration, traffic mix,
driver, limits and per-layer readers are found by the names in
BENCHMARK.json (harness/loader.py). Set-up (process start to the first
timed item) builds or loads the kernels and warms the cell's shapes; the
window then runs items back to back for --seconds; with --trace 1 the
window runs under torch.profiler and the per-layer metrics are read from
it, with --trace 0 the end-to-end metrics are taken. After the window the
program's state is freed and its outputs are compared with the plain
reference. The last line of standard output is the result's JSON; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

A run needs a CUDA card: without one it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import checks, stats, tracing  # noqa: E402
from harness.common import Context  # noqa: E402
from harness.loader import Cell, load_json  # noqa: E402
from reference import opmodel  # noqa: E402


def process_start() -> float:
    """The process's start on the wall clock (/proc: its start in clock
    ticks after boot, plus the boot time), or now where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, StopIteration, IndexError, ValueError):
        return time.time()


T_PROCESS = process_start()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_window(wl, seconds: float, traced: bool):
    """Items back to back until `seconds` have passed: (t0, [(start,
    end)]) on the host clock; the last item ends past the deadline."""
    span = (lambda n: torch_record(n)) if traced else (
        lambda n: contextlib.nullcontext())
    items = []
    with span(tracing.WINDOW):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while time.perf_counter() < deadline:
            s = time.perf_counter()
            with span(tracing.ITEM):
                wl.item(i)
            items.append((s, time.perf_counter()))
            i += 1
    return t0, items


def torch_record(name):
    import torch
    return torch.profiler.record_function(name)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None, *, device=None, shrink=None, spec=None,
         root=BENCH) -> int:
    """The run. The keywords are for the CPU tests alone (a tiny cell on
    the plain engine, a spec and a folder of parts of their own); the
    benchmark's runs never pass them."""
    args = parse(argv)
    spec = spec or load_json(REPO / "BENCHMARK.json")
    cell = Cell(spec, args.workload, root=root)
    import torch
    if device is None:
        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"[port_bench] {args.workload} needs {chips} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"{torch.cuda.device_count()} found: no result",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    on_cuda = device.type == "cuda"
    traced = bool(args.trace)
    ctx = Context(cell=cell, seed=args.seed, device=device,
                  shrink=dict(shrink or {}))
    wl = cell.driver.Workload(ctx)
    wl.setup()
    prof = tracing.start(device) if traced else None
    t_first = time.time()
    t0, items = run_window(wl, args.seconds, traced)
    trace = tracing.stop(prof) if traced else None
    setup_s = t_first - T_PROCESS
    mem_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}

    metrics = {}
    breakdown = None
    dev = {"platform": "gpu" if on_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if on_cuda
           else "cpu", "count": 1, "memory_peak_bytes": int(mem_peak)}
    t_after = time.perf_counter()
    if traced:
        trace.facts = wl.facts(trace)
        trace.facts["peak"] = (opmodel.peak_flops(dev["kind"]) if on_cuda
                               else None)
        for name, reader in cell.metric_readers().items():
            v = reader.read(trace)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        dev["busy_s"] = stats.busy_ns(trace.device, trace.window) / 1e9
        dev["window_s"] = trace.window_s
        breakdown = {"device_ops": stats.top_device_ops(trace.device,
                                                        trace.window),
                     "idle_gaps": stats.idle_gaps(trace.device, trace.host,
                                                  trace.window)}
        print(f"[port_bench] traced window {trace.window_s:.4f} s, "
              f"{len(trace.spans)} items, {len(trace.device)} device "
              f"events; facts {json.dumps(trace.facts)}; "
              f"card {power_limit() if on_cuda else 'cpu'}", file=sys.stderr)
    else:
        e2e = wl.end_to_end(t0, items)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    t_read = time.perf_counter()
    wl.release()
    numbers = wl.check()
    t_check = time.perf_counter()
    correct, rows = checks.judged(numbers, cell.limits["limits"])

    found = checks.banned_modules(sys.modules)
    if found:
        print(f"[port_bench] loaded in this process: {', '.join(found)}: "
              "no result", file=sys.stderr)
        return 3
    extra = {k: v for k, v in numbers.items() if k not in cell.limits["limits"]}
    print(f"[port_bench] {args.workload} seed {args.seed}: {len(items)} "
          f"items in {items[-1][1] - t0:.4f} s, set-up {setup_s:.4f} s, "
          f"trace read {t_read - t_after:.2f} s, check {t_check - t_read:.2f}"
          f" s, {json.dumps(extra)}", file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name} = {v!r} limit {lim!r}", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": len(items), "failed": 0,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
