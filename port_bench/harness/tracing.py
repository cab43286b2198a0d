"""The traced run: torch.profiler over the measured window only, read in
memory from its kineto events (no trace file), reduced to plain tuples
for the metric readers.

The harness marks the window with a "bench.window" span and every item
(an image, an optimizer step, a frame) with a "bench.item" span, around
the calls into the program; the device's intervals are CUPTI's kernels,
copies and sets, on the trace's own clock."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"
ITEM = "bench.item"


@dataclass
class Trace:
    window: tuple                 # (start_ns, end_ns) of the window span
    spans: list                   # (name, start_ns, end_ns) of item spans
    device: list                  # (name, kind, start_ns, end_ns)
    host: list                    # (name, start_ns, end_ns), every CPU event
    facts: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def start(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)
    prof.start()
    return prof


def _device_kind(ev) -> str | None:
    """"kernel", "copy" or None (not the device's work: annotations). The
    activity type where this torch's events carry one, else the name."""
    name = ev.name()
    if ev.is_user_annotation() or name.startswith("bench."):
        return None
    if hasattr(ev, "activity_type"):
        kind = ev.activity_type()
        return {"kernel": "kernel", "gpu_memcpy": "copy",
                "gpu_memset": "copy"}.get(kind)
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


def stop(prof) -> Trace:
    prof.stop()
    window, spans, device, host = None, [], [], []
    for ev in prof.profiler.kineto_results.events():
        name, s = ev.name(), ev.start_ns()
        e = s + ev.duration_ns()
        if str(ev.device_type()).endswith("CUDA"):
            kind = _device_kind(ev)
            if kind is not None:
                device.append((name, kind, s, e))
        elif name == WINDOW:
            window = (s, e)
        else:
            if name == ITEM:
                spans.append((name, s, e))
            host.append((name, s, e))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    spans.sort(key=lambda x: x[1])
    return Trace(window=window, spans=spans, device=device, host=host)
