"""The readers of the program's spans and bounce counter on synthetic
traces: nested spans with device intervals partly inside them give known
exposed ms and G bounces/s; a trace without device events, without the
span or without the counter gives nothing."""
import pytest
import torch

from harness import loader
from harness.tracing import Trace

from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc

MS = 1_000_000  # ns
SPEC = loader.load_json(loader.BENCH_ROOT.parent / "BENCHMARK.json")
NEW = ["compile_ms.render", "pack_ms.render", "forward_gbounces_s.render",
       "memcheck_ms.train", "optimizer_ms.train", "camera_ms.frame",
       "launch_ms.frame"]


def reader(name):
    return loader.load_module("metrics", name)


def trace(device=True):
    """Two items in a 20 ms window. Item 1 (0-10 ms): rt.render 0-9 around
    rt.compile 1-3 and rt.pack 3-6, rt.pack's rt.launch 4-5 (the device
    busy 2-4 and 5-8: compile exposed 1, pack 1, launch 1). Item 2 (10-20
    ms): rt.compile 11-12 (no device), rt.pack 12-16 around a second
    rt.pack 13-14 (nested: counted once; the device busy 15-18: exposed
    3). A span outside the window is not read."""
    host = [("bench.item", 0, 10 * MS), ("rt.render", 0, 9 * MS),
            ("rt.compile", 1 * MS, 3 * MS), ("rt.pack", 3 * MS, 6 * MS),
            ("rt.launch", 4 * MS, 5 * MS),
            ("bench.item", 10 * MS, 20 * MS),
            ("rt.compile", 11 * MS, 12 * MS), ("rt.pack", 12 * MS, 16 * MS),
            ("rt.pack", 13 * MS, 14 * MS),
            ("rt.compile", 21 * MS, 29 * MS)]
    dev = [("wavefront_forward_kernel", "kernel", 2 * MS, 4 * MS),
           ("wavefront_forward_kernel", "kernel", 5 * MS, 8 * MS),
           ("Memcpy", "copy", 15 * MS, 18 * MS),
           ("wavefront_forward_kernel", "kernel", 19 * MS, 25 * MS)]
    spans = [(n, s, e) for n, s, e in host if n == "bench.item"]
    return Trace(window=(0, 20 * MS), spans=spans,
                 device=dev if device else [], host=host,
                 facts={"forward_kernel": "wavefront_forward_kernel"})


def test_spec_lists_the_new_metrics_in_their_cells():
    got = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NEW:
        m = got[name]
        assert m["source"] == "device_trace" and m["workloads"], m
        for w in m["workloads"]:
            assert name in {x["name"] for x in loader.metrics_of(
                SPEC, "per_layer", w)}


def test_exposed_ms_per_item_and_per_span():
    t = trace()
    # compile: 1 ms exposed in item 1, 1 in item 2, over 2 items
    assert reader("compile_ms.render").read(t) == pytest.approx(1.0)
    # pack: 1 in item 1, 3 in item 2 (the nested span once)
    assert reader("pack_ms.render").read(t) == pytest.approx(2.0)
    # the same spans under the frame's and training's names
    t.host += [("rt.frame.camera", 1 * MS, 3 * MS),
               ("rt.frame.camera", 12 * MS, 16 * MS),
               ("rt.train.optimizer", 0, 1 * MS),
               ("rt.train.optimizer", 6 * MS, 7 * MS),
               ("rt.memcheck", 5 * MS, 6 * MS)]
    # camera: (1 + 3) ms over its 2 spans
    assert reader("camera_ms.frame").read(t) == pytest.approx(2.0)
    # launch: 1 ms over 2 frames
    assert reader("launch_ms.frame").read(t) == pytest.approx(0.5)
    # optimizer: 1 + 0 (6-7 under the kernel) over 2 steps
    assert reader("optimizer_ms.train").read(t) == pytest.approx(0.5)
    # memcheck: 5-6 lies under the kernel: 0 exposed
    assert reader("memcheck_ms.train").read(t) == pytest.approx(0.0)


def test_forward_bounces_over_the_kernel_time(monkeypatch):
    """4.5e6 bounces over the kernel's 2 + 3 + 1 (clipped) = 6 ms in the
    window: 0.75 G bounces/s, the count read from the program's tensor."""
    monkeypatch.setattr(wc.render_pass_kernel, "bounces",
                        torch.tensor(4_500_000))
    assert reader("forward_gbounces_s.render").read(trace()) == (
        pytest.approx(0.75))
    t = trace()
    t.facts["forward_kernel"] = "wavefront_forward_vscan_kernel"
    assert reader("forward_gbounces_s.render").read(t) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_without_device_events(name, monkeypatch):
    monkeypatch.setattr(wc.render_pass_kernel, "bounces",
                        torch.tensor(4_500_000))
    assert reader(name).read(trace(device=False)) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_from_a_program_without_spans_or_counter(name, monkeypatch):
    """An older program: no rt.* span and no bounce counter."""
    monkeypatch.delattr(wc.render_pass_kernel, "bounces")
    t = trace()
    t.host = [h for h in t.host if not h[0].startswith("rt.")]
    assert reader(name).read(t) is None
