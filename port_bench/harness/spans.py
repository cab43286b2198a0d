"""What the per-layer metrics read from the program's own instruments: its
spans (rt.*, torch.profiler record_function ranges that the port opens at
its layer boundaries while a profiler records, in the trace's host events
on the clock of the CUPTI intervals) and the forward kernel's bounce
counter (render_pass_kernel.bounces, a device-side total the port keeps
while a profiler records).

A program without a span or the counter (an older checkout) gives nothing
to read: the readers return None and never raise."""
from __future__ import annotations

import sys

from harness import stats

WAVEFRONT = "real_time_ray_tracing_engine_tpu_torch.ops.wavefront_cuda"


def exposed_ns(trace, name: str):
    """(exposed ns, count) of the window's spans named `name`: their
    union's length less the device's kernel and copy intervals inside it
    (host_ms's arithmetic, harness/stats.py, on one span name), and how
    many there are. None without device events or without such a span."""
    if not trace.device:
        return None
    lo, hi = trace.window
    spans = [(s, e) for n, s, e in trace.host
             if n == name and s >= lo and e <= hi]
    if not spans:
        return None
    merged = stats.merge((s, e) for _, _, s, e in trace.device)
    total = sum((e - s) - stats.covered(merged, s, e)
                for s, e in stats.merge(spans))
    return total, len(spans)


def per_item_ms(trace, name: str) -> float | None:
    """The exposed ms of `name` summed over the window, over its items."""
    got = exposed_ns(trace, name)
    if got is None or not trace.spans:
        return None
    return got[0] / len(trace.spans) / 1e6


def per_span_ms(trace, name: str) -> float | None:
    """The exposed ms of `name` summed over the window, over its spans."""
    got = exposed_ns(trace, name)
    return None if got is None else got[0] / got[1] / 1e6


def forward_bounces() -> int | None:
    """The bounces the forward kernel traced while the profiler recorded
    (read back once, here); None where the program keeps no such count or
    counted none."""
    wc = sys.modules.get(WAVEFRONT)
    total = getattr(getattr(wc, "render_pass_kernel", None), "bounces", None)
    if total is None:
        return None
    total = int(total)
    return total if total > 0 else None
