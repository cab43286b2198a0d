"""The benchmark's arithmetic: rates and tails over a whole window, and
what the per-layer metrics read out of spans and device intervals.

Intervals are (start_ns, end_ns) pairs on one clock; spans and device
events come from the same profiler trace, so they share it."""
from __future__ import annotations

import bisect
import math


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all of its seconds."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) over every value."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    k = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[k - 1]


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged, lo, hi) -> float:
    """How much of [lo, hi) the merged intervals cover."""
    total = 0
    i = bisect.bisect_right(merged, (lo, lo))
    i = max(0, i - 1)
    while i < len(merged) and merged[i][0] < hi:
        s, e = merged[i]
        a, b = max(s, lo), min(e, hi)
        if b > a:
            total += b - a
        i += 1
    return total


def busy_ns(device, window) -> float:
    """The window's time in which some device operation ran."""
    return covered(merge((s, e) for _, _, s, e in device), *window)


def idle_share(device, window) -> float:
    """1 - the union of the device's intervals over the window's wall."""
    lo, hi = window
    return 1.0 - busy_ns(device, window) / (hi - lo)


def host_ms(spans, device) -> float | None:
    """Mean over the spans of each span's length less the device time
    inside it: the host's work that the card waits for, in ms."""
    if not spans:
        return None
    merged = merge((s, e) for _, _, s, e in device)
    exposed = [(e - s) - covered(merged, s, e) for _, s, e in spans]
    return sum(exposed) / len(exposed) / 1e6


def kernel_ns(device, name: str, window) -> float:
    """Summed time of the kernel `name` inside the window."""
    lo, hi = window
    return sum(min(e, hi) - max(s, lo) for n, kind, s, e in device
               if n == name and kind == "kernel" and e > lo and s < hi)


def top_device_ops(device, window, n: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    lo, hi = window
    tot = {}
    for name, _, s, e in device:
        if e > lo and s < hi:
            tot[name] = tot.get(name, 0) + min(e, hi) - max(s, lo)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[short(k), v / 1e9] for k, v in best]


def idle_gaps(device, host, window, n: int = 10) -> list:
    """[name, seconds] of the idle gaps of the device by what the host was
    doing in them: the innermost host event (the shortest) around each
    gap's midpoint, summed by name, longest first; the 20 n longest gaps
    are attributed."""
    lo, hi = window
    merged = merge((max(s, lo), min(e, hi)) for _, _, s, e in device
                   if e > lo and s < hi)
    gaps, t = [], lo
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = sorted(gaps[:20 * n], key=lambda g: g[0] + g[1])
    mids = [(g0 + g1) / 2 for g0, g1 in gaps]
    best = [None] * len(gaps)
    for name, s, e in host:
        for i in range(bisect.bisect_left(mids, s),
                       bisect.bisect_left(mids, e)):
            if best[i] is None or e - s < best[i][1]:
                best[i] = (name, e - s)
    tot = {}
    for (g0, g1), b in zip(gaps, best):
        key = b[0] if b else "(no host event)"
        tot[key] = tot.get(key, 0) + g1 - g0
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[short(k), v / 1e9] for k, v in top]


def short(name: str, limit: int = 120) -> str:
    """A name for the breakdown: a kernel's C++ template arguments cut to
    `limit` characters (the sums are taken over the whole names)."""
    return name if len(name) <= limit else name[:limit - 3] + "..."


def roofline_share(ops: float, peak: float, kernel_s: float) -> float | None:
    """The least time of `ops` at `peak` over the kernel's time, in %."""
    if not ops or not peak or kernel_s <= 0:
        return None
    return 100.0 * (ops / peak) / kernel_s
