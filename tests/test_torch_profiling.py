"""The port's profiling layer (utils/profiling.py): its spans and the
forward's bounce counter, the trace's path lengths and the native P3
encoder (csrc/ppm_io.cpp), against the JAX package's.

Path lengths follow the rule tests/test_pallas.py::_assert_close holds
images to: the two integrators draw the same streams, and XLA:CPU contracts
FMAs under jit where torch does not, so a few paths take another branch at
depth 4 (2-5 of 1,024 on Cornell, none or one on cornell_smoke): under 1%
of paths may end at another bounce. The bounce totals are compared where no
path parts (depth 3 on Cornell, 4 on simple_sphere, the seeds below).
"""
import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu import native as jnative
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.ops import integrator as jint
from real_time_ray_tracing_engine_tpu.utils import profiling as jprof
from real_time_ray_tracing_engine_tpu.utils import rng as jrng
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.models import render as rd
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.ops.integrator import trace
from real_time_ray_tracing_engine_tpu_torch.parallel import train
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_from_numpy, camera_to_numpy, flat_from_numpy, flat_to_numpy)
from real_time_ray_tracing_engine_tpu_torch.utils import color
from real_time_ray_tracing_engine_tpu_torch.utils import profiling as prof
from real_time_ray_tracing_engine_tpu_torch.utils import rng

from test_pallas import _assert_close as assert_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLIP_FRAC = 0.01       # _assert_close's share of branch-flip pixels
H100 = "NVIDIA H100 80GB HBM3"


def _builtin(api, name, width):
    scene = api.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = width
    return scene


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_trace_lengths_match_jax(name):
    """trace(return_lengths=True) at 32x32 spp1 d4 (cornell_smoke: the
    medium draws) against the JAX trace's lengths on the same tables and
    camera, and the radiance the same bits with and without the flag."""
    scene = _builtin(rt, name, 32)
    jf, jc = rt.compile_scene(scene), jcam.derive(scene.camera)
    pf = flat_from_numpy(*flat_to_numpy(jf), device="cpu")
    pc = camera_from_numpy(camera_to_numpy(jc), device="cpu")
    w, h = jcam.image_size(scene.camera)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    keys = jrng.ray_keys(0, pix, jnp.zeros_like(pix))
    org, dr, tm = jcam.generate_rays(jc, w, pix, jnp.asarray(0, jnp.int32),
                                     1, keys)
    rad_j, len_j = jint.trace(jf, org, dr, tm, keys, jc.background,
                              max_depth=4, return_lengths=True)

    ppix = torch.arange(w * h)
    pkeys = rng.ray_keys(0, ppix, 0)
    po, pd, ptm = pcam.generate_rays(pc, w, ppix, 0, 1, pkeys)
    rad, length = trace(pf, po, pd, ptm, pkeys, pc.background, max_depth=4,
                        return_lengths=True)
    plain = trace(pf, po, pd, ptm, pkeys, pc.background, max_depth=4)
    assert torch.equal(rad, plain)
    assert length.dtype == torch.float32 and length.shape == (w * h,)
    len_j = np.asarray(len_j)
    assert set(np.unique(length.numpy())) <= {1.0, 2.0, 3.0, 4.0}
    assert (length.numpy() != len_j).mean() < FLIP_FRAC
    assert length.numpy().mean() > 1.5
    assert_close(rad.numpy().reshape(h, w, 3),
                 np.asarray(rad_j).reshape(h, w, 3))


def test_lengths_count_the_wavefront_bounces():
    """The replays' lengths summed over a pass's samples are, pixel by
    pixel, the bounces the lane wavefront traces for that pixel in the
    pass (the plain version of the kernels' iteration counter): what
    chip_smoke.py's profiling phase holds the kernel's count against."""
    scene = _builtin(pt, "cornell_box", 16)
    flat, cfg = pt.compile_scene(scene), scene.camera
    w, h = pcam.image_size(cfg)
    L = prof.path_lengths(flat, cfg, n_samples=4, max_depth=8, seed=3)
    assert L.shape == (4, w * h)
    n_lanes = wc.lane_count(w * h)
    iters = torch.zeros(n_lanes, dtype=torch.int32)
    wc.render_pass_reference(flat, pcam.derive(cfg), 3, 0, width=w,
                             height=h, n_strata=2, max_depth=8, n_samples=4,
                             iters=iters)
    np.testing.assert_array_equal(L.sum(axis=0), iters[:w * h].numpy())


@pytest.mark.parametrize("kind", ["cpu", H100])
def test_render_stats_match_jax(kind):
    """RenderStats on the same inputs as the JAX package's: paths, rates
    and the first two report lines; the roofline None for a device the
    table does not hold, rays/s x ops / 67e12 for the H100."""
    kw = dict(width=600, height=600, spp=16, wall_s=0.0125, avg_depth=4.25,
              device_kind=kind)
    got, want = prof.RenderStats(**kw), jprof.RenderStats(**kw)
    assert got.paths == want.paths == 600 * 600 * 16
    assert got.paths_per_s == want.paths_per_s
    assert got.rays_per_s == want.rays_per_s
    assert got.report().splitlines()[:2] == want.report().splitlines()[:2]
    frac = got.roofline_fraction(ops_per_bounce=1127.25)
    if kind == "cpu":
        assert frac is None and want.roofline_fraction() is None
        assert len(got.report().splitlines()) == 2
    else:
        assert frac == got.rays_per_s * 1127.25 / 67e12
        assert got.roofline_fraction() == got.rays_per_s * 1200.0 / 67e12
        assert got.report().splitlines()[2] == (
            f"  ~{100 * got.roofline_fraction():.1f}% of {H100} fp32 "
            f"roofline")


def test_timed_matches_jax():
    """timed yields the stats of its block once it ends: the same fields
    as the JAX package's, the device "cpu" without CUDA."""
    stats = dict(width=8, height=4, spp=2, avg_depth=2.5)
    with prof.timed(stats) as get:
        torch.ones(1000).sum()
    with jprof.timed(stats) as jget:
        jnp.ones(1000).sum().block_until_ready()
    got, want = get(), jget()
    assert prof.device_kind() == "cpu" == want.device_kind
    assert got.wall_s > 0.0
    assert dataclasses.replace(got, wall_s=1.0) == prof.RenderStats(
        **{**dataclasses.asdict(want), "wall_s": 1.0})


def test_profiler_trace_on_the_cpu(tmp_path):
    """profiler_trace writes a chrome trace into log_dir holding the plain
    trace's aten ops; with no device, device_busy finds no kernel."""
    s = _builtin(pt, "cornell_box", 8)
    flat, cam = pt.compile_scene(s), pcam.derive(s.camera)
    pix = torch.arange(64)
    keys = rng.ray_keys(0, pix, 0)
    org, dr, tm = pcam.generate_rays(cam, 8, pix, 0, 1, keys)
    with prof.profiler_trace(str(tmp_path / "trace")) as tr:
        trace(flat, org, dr, tm, keys, cam.background, max_depth=2)
    assert tr.path.startswith(str(tmp_path / "trace"))
    with open(tr.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::mul", "aten::add", "aten::where"} <= names
    busy = prof.device_busy(tr.path)
    assert busy["window_ms"] > 0.0
    assert busy["busy_ms"] == 0.0 and busy["kernels"] == {}


def _busy(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return prof.device_busy(str(path))


# a host op, three kernels, a flow event and, from 0 to 1.1 ms, the
# profiler's own span around everything
EVENTS = [
    {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "ts": 0.0,
     "dur": 1100.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 100.0,
     "dur": 900.0},
    {"ph": "X", "cat": "kernel", "name": "k1", "ts": 200.0, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "k1", "ts": 250.0, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "k2", "ts": 600.0, "dur": 200},
    {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 50.0},
]
KERNELS = {"k1": {"ms": pytest.approx(0.2), "launches": 2},
           "k2": {"ms": pytest.approx(0.2), "launches": 1}}


def test_device_busy_reads_kernel_intervals(tmp_path):
    """device_busy: the union of the kernels' intervals over the window
    from the first program span's start to the end of the last one or of
    the last kernel, whichever is later (the profiler's span and the host
    op around it, and the spans' GPU annotation, outside it), kernels by
    name."""
    events = EVENTS + [
        {"ph": "X", "cat": "user_annotation", "name": "rt.render",
         "ts": 150.0, "dur": 550.0},
        {"ph": "X", "cat": "user_annotation", "name": "rt.compile",
         "ts": 160.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "rt.render",
         "ts": 200.0, "dur": 800.0},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 10.0,
         "dur": 1000.0}]
    busy = _busy(tmp_path, events)
    assert busy["window_ms"] == pytest.approx(0.65)       # 150 to 800 us
    assert busy["busy_ms"] == pytest.approx(0.35)
    assert busy["busy_share"] == pytest.approx(0.35 / 0.65)
    assert busy["kernels"] == KERNELS


def test_device_busy_without_spans_takes_the_whole_trace(tmp_path):
    """A trace with no program span (a block of the user's own) keeps the
    window of its first event to the end of its last."""
    busy = _busy(tmp_path, EVENTS)
    assert busy["window_ms"] == pytest.approx(1.1)
    assert busy["busy_ms"] == pytest.approx(0.35)
    assert busy["kernels"] == KERNELS


@pytest.mark.parametrize("name,want", [
    ("cornell_box", {"forward": 1127.25, "tex_grad": 1139.25,
                     "full_family": 2079.75}),
    ("bouncing_spheres", {"vscan": 848.0, "suffix": 872.0,
                          "slot": 104.5, "adjoint": 1280.0})])
def test_op_model_bounds(name, want):
    """The source-counted op model gives PERF.md's "Bounds": a bounce of
    Cornell 1127 forward, 1139 tex grad, 2079.75 with its 9 hard slots;
    bouncing 848, K8 872, K4v +104.5 a slot, K9/K10 1280; a bound is ops
    x bounces over 67 TFLOP/s."""
    flat = pt.compile_scene(pt.builders.BUILTIN_SCENES[name]())
    if name == "cornell_box":
        slots = len(wc.hard_param_slots(flat))
        assert slots == 9
        got = {"forward": prof.bounce_ops(flat),
               "tex_grad": prof.bounce_ops(flat, True),
               "full_family": prof.bounce_ops(flat, True, slots)}
        assert prof.bound_ms(flat, False, 10**6) == (
            1127.25 * 10**6 / 67e12 * 1e3)
    else:
        got = {"vscan": prof.vscan_bounce_ops(flat),
               "suffix": prof.vscan_bounce_ops(flat) + prof.OPS_ROUTE,
               "slot": prof.OPS_SLOT,
               "adjoint": prof.adjoint_bounce_ops(flat)}
        assert prof.vscan_bound_ms(flat, 10**6) == 848.0 * 10**6 / 67e12 * 1e3
    assert got == want


def _byte_image():
    """Every value class of the encoder (one, two and three digits at
    their edges) and random bytes."""
    edge = np.array([0, 9, 10, 99, 100, 255], np.uint8)
    b = np.random.default_rng(4).integers(0, 256, (20, 30, 3), np.uint8)
    b.reshape(-1)[:edge.size * 3] = np.repeat(edge, 3)
    b.reshape(-1)[-edge.size:] = edge
    return b


def test_native_encoder_matches_numpy():
    """csrc/ppm_io.cpp (built by g++ at first use) gives the numpy
    encoder's bytes, and encode_ppm_p3 takes it."""
    b = _byte_image()
    native = color.encode_ppm_p3_native(b)
    assert native is not None
    assert native == color.encode_ppm_p3_numpy(b) == color.encode_ppm_p3(b)
    assert native.startswith(b"P3\n30 20\n255\n0 0 0\n9 9 9\n10 10 10\n")
    assert native.endswith(b"0 9 10\n99 100 255\n")


def test_native_encoder_matches_jax_native():
    """The port's C++ encoder writes the JAX package's native body (its
    libbvh.so, built by g++ at first use, as tests/test_native.py uses
    it)."""
    b = _byte_image()
    body = jnative.encode_ppm_p3(b)
    assert body is not None, "the JAX package's native library did not build"
    assert color.encode_ppm_p3_native(b) == b"P3\n30 20\n255\n" + body


def test_write_ppm_either_encoder(tmp_path, monkeypatch):
    """write_ppm writes the same file through the C++ encoder and through
    the numpy encoder (the path without a C++ compiler)."""
    img = np.random.default_rng(1).uniform(0, 1, (16, 24, 3)).astype(
        np.float32)
    color.write_ppm(tmp_path / "native.ppm", img)
    monkeypatch.setattr(color, "_encoder", lambda: None)
    assert color.encode_ppm_p3_native(_byte_image()) is None
    color.write_ppm(tmp_path / "numpy.ppm", img)
    a = (tmp_path / "native.ppm").read_bytes()
    assert a == (tmp_path / "numpy.ppm").read_bytes()
    np.testing.assert_array_equal(color.read_ppm(tmp_path / "native.ppm"),
                                  color.to_bytes(img))


# ---------------------------------------------------- spans and bounces
def _profiled(fn):
    """fn() under torch.profiler (CPU activity); the profile."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        fn()
    return p


def _span_tree(p) -> list:
    """(name, parent) of every rt.* span of profile p in start order; the
    parent is the innermost rt.* span around it on its thread, None at the
    top."""
    evs = sorted(((e.name(), e.start_thread_id(), e.start_ns(),
                   e.start_ns() + e.duration_ns())
                  for e in p.profiler.kineto_results.events()
                  if e.name().startswith("rt.")),
                 key=lambda x: (x[2], -x[3]))
    out = []
    for i, (name, tid, s, e) in enumerate(evs):
        around = [o for j, o in enumerate(evs) if j < i and o[1] == tid
                  and o[2] <= s and e <= o[3]]
        out.append((name, around[-1][0] if around else None))
    return out


def _tiny(name="cornell_box", width=8, spp=4, depth=2):
    scene = _builtin(pt, name, width)
    scene.camera.samples_per_pixel = spp
    scene.camera.max_depth = depth
    return scene


def _train_step():
    """A make_train_step step over tex_color on the plain engine at 8 px
    (4 samples: one pass forward, one backward), and its arguments."""
    scene = _tiny()
    flat, cam = pt.compile_scene(scene), pcam.derive(scene.camera)
    kw = dict(width=8, height=8, n_strata=2, max_depth=2)
    tgt = train.make_kernel_render(flat, engine="torch", **kw)(
        {"tex_color": flat.tex_color}, cam, 0).detach()
    p = {"tex_color": (flat.tex_color * 0.7).requires_grad_(True)}
    step = train.make_train_step(torch.optim.Adam(p.values(), lr=0.02),
                                 flat=flat, engine="torch", **kw)
    return lambda: step(p, cam, 0, tgt)


def _main_paths():
    """The render, frame and training calls, each ready to run."""
    scene = _tiny()
    r = pt.ProgressiveRenderer(_tiny(), device="cpu")

    def frame():
        r.move_camera((0.0, 0.0, 1.0))
        r.step()
        r.image()
    return {"render": lambda: pt.render(scene, device="cpu"),
            "frame": frame, "train": _train_step()}


SPAN_TREES = {
    "render": [("rt.render", None), ("rt.compile", "rt.render")],
    "frame": [("rt.frame.camera", None), ("rt.frame.step", None),
              ("rt.frame.image", None)],
    "train": [("rt.train.step", None),
              ("rt.train.optimizer", "rt.train.step"),
              ("rt.train.forward", "rt.train.step"),
              ("rt.train.backward", "rt.train.step"),
              ("rt.train.scatter", "rt.train.backward"),
              ("rt.train.optimizer", "rt.train.step")],
}


def test_span_is_a_shared_no_op_without_a_profiler():
    """With no profiler, span returns one shared context whatever the name
    (nothing built); under one, a record_function range, nested in the
    span around it."""
    assert not prof.recording()
    assert prof.span("rt.render") is prof.span("rt.train.step")

    @prof.spanned("rt.compile")
    def inner():
        return 3

    def outer():
        with prof.span("rt.render"):
            assert prof.recording() and inner() == 3

    assert _span_tree(_profiled(outer)) == [("rt.render", None),
                                            ("rt.compile", "rt.render")]


def test_main_paths_enter_no_record_function_without_a_profiler(
        monkeypatch):
    """A render, a frame (move, step, image) and a training step run with
    record_function made to raise on a program span's name: no span site
    enters one (torch.optim enters its own, whatever the profiler)."""
    paths = _main_paths()
    real = torch.autograd.profiler.record_function

    def refuse(name, *a, **k):
        if name.startswith("rt."):
            raise AssertionError(f"{name} entered with no profiler")
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for run in paths.values():
        run()


@pytest.mark.parametrize("path", list(SPAN_TREES))
def test_spans_of_the_main_paths(path):
    """Under torch.profiler the plain engine's render, a frame and a
    training step record exactly their spans, nested as stated (the
    kernels' rt.pack, rt.launch and rt.memcheck are the card's)."""
    run = _main_paths()[path]
    assert _span_tree(_profiled(run)) == SPAN_TREES[path]


def test_compacted_schedule_spans():
    """The compacted schedule records one rt.compact between each two
    phases, outside the passes."""
    scene = _tiny(spp=4, depth=3)
    flat, cam = pt.compile_scene(scene), pcam.derive(scene.camera)
    kw = dict(width=8, height=8, n_strata=2, max_depth=3, n_samples=4)
    p = _profiled(lambda: wc.render_pass_compacted(
        flat, cam, 0, 0, caps=(2, 2), pass_fn=wc.render_pass_reference,
        **kw))
    assert _span_tree(p) == [("rt.compact", None)] * 2


def _jax_bounces(name, width, spp, depth, seed) -> int:
    """The JAX package's trace lengths summed over the image's pixels and
    the samples of a render (its streams: seed, pixel, sample)."""
    scene = _builtin(rt, name, width)
    jf, jc = rt.compile_scene(scene), jcam.derive(scene.camera)
    w, h = jcam.image_size(scene.camera)
    n = int(np.sqrt(spp))
    pix = jnp.arange(w * h, dtype=jnp.int32)
    total = 0
    for s in range(n * n):
        keys = jrng.ray_keys(seed, pix, jnp.full(pix.shape, s, jnp.int32))
        org, dr, tm = jcam.generate_rays(jc, w, pix, jnp.asarray(s, jnp.int32),
                                         n, keys)
        _, ln = jint.trace(jf, org, dr, tm, keys, jc.background,
                           max_depth=depth,
                           sky_gradient=scene.camera.sky_gradient,
                           return_lengths=True)
        total += int(np.asarray(ln).sum())
    return total


@pytest.mark.parametrize("name,depth", [("cornell_box", 3),
                                        ("simple_sphere", 4)])
def test_bounce_total_equals_jax_lengths(name, depth):
    """A plain-engine render at 32 px, 4 spp, under torch.profiler adds to
    _render_pass.bounces the sum of the JAX package's trace lengths on the
    same scene, camera and seed."""
    scene = _tiny(name, width=32, spp=4, depth=depth)
    before = rd._render_pass.bounces
    _profiled(lambda: pt.render(scene, device="cpu", seed=7))
    got = int(rd._render_pass.bounces - before)
    assert got == _jax_bounces(name, 32, 4, depth, 7) > 0


def test_plain_engine_makes_no_bounce_buffer_without_a_profiler(
        monkeypatch):
    """With no profiler the plain engine asks the trace for no lengths and
    its total stays the same object."""
    asked = []

    def traced(*a, return_lengths=False, **k):
        asked.append(return_lengths)
        return trace(*a, return_lengths=return_lengths, **k)
    monkeypatch.setattr(rd, "trace", traced)
    before = rd._render_pass.bounces
    pt.render(_tiny(), device="cpu")
    assert asked and not any(asked)
    assert rd._render_pass.bounces is before


@pytest.mark.parametrize("profiled", [False, True])
def test_kernel_wrapper_counts_bounces(profiled, monkeypatch):
    """render_pass_kernel hands the launch a zeroed int32 bounce buffer of
    the lanes while a profiler records, and adds its sum to .bounces (a
    tensor, not read back); with no profiler, or with the caller's own
    iters, it passes that and counts nothing. The launch is a stand-in
    that traces 2 bounces a lane (no card here)."""
    seen = []

    def launch(flat, cam, seed, sample_start, *, iters, **kw):
        seen.append(None if iters is None else iters.clone())
        if iters is not None:
            iters += 2
        n_lanes = wc.lane_count(kw["width"] * kw["height"])
        return torch.zeros(3, n_lanes), None, None, None
    monkeypatch.setattr(wc, "_launch", launch)
    monkeypatch.setattr(wc.render_pass_kernel, "bounces", 0)
    scene = _tiny()
    flat, cam = pt.compile_scene(scene), pcam.derive(scene.camera)
    kw = dict(width=8, height=8, n_strata=1, max_depth=2, n_samples=1,
              prepared=wc.KernelInputs(torch.zeros(1), {}))
    own = torch.zeros(wc.lane_count(64), dtype=torch.int32)

    def run():
        img = wc.render_pass_kernel(flat, cam, 0, 0, **kw)
        wc.render_pass_kernel(flat, cam, 0, 0, iters=own, **kw)
        assert img.shape == (8, 8, 3)
    if profiled:
        _profiled(run)
    else:
        run()
    assert seen[1] is not None and int(own.sum()) == 2 * own.numel()
    total = wc.render_pass_kernel.bounces
    if profiled:
        assert seen[0].dtype == torch.int32 and not seen[0].any()
        assert seen[0].shape == (wc.lane_count(64),)
        assert isinstance(total, torch.Tensor)
        assert int(total) == 2 * wc.lane_count(64)
    else:
        assert seen[0] is None and total == 0
