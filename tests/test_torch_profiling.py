"""The port's profiling layer (utils/profiling.py), the trace's path lengths
and the native P3 encoder (csrc/ppm_io.cpp), against the JAX package's.

Path lengths follow the rule tests/test_pallas.py::_assert_close holds
images to: the two integrators draw the same streams, and XLA:CPU contracts
FMAs under jit where torch does not, so a few paths take another branch at
depth 4 (2-5 of 1,024 on Cornell, none or one on cornell_smoke): under 1%
of paths may end at another bounce. The replays' arithmetic is held to the
JAX package's to 1e-9 on the JAX package's own lengths, and the port's
whole replay to the JAX test's assertions (tests/test_parallel.py:115-133).
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
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.ops.integrator import trace
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


# the replays at a small size: Cornell 32 px wide, 4 samples, depth 4,
# tiles of 2 x 128 lanes
REPLAY_KW = dict(width=32, n_samples=4, max_depth=4, rows_per_tile=2)
REPLAYS = {
    "wavefront": ("wavefront_utilization", {}),
    "single": ("schedule_utilization", {"caps": ()}),
    "caps_6_6": ("schedule_utilization", {"caps": (6, 6)}),
    "oracle": ("schedule_utilization", {"caps": (6, 6), "key": "oracle"}),
}


@pytest.fixture(scope="module")
def jax_replays():
    """Each JAX replay of REPLAYS, and the lengths its trace returned."""
    out, jax_trace = {}, jint.trace
    with pytest.MonkeyPatch.context() as mp:
        for case, (fn, kw) in REPLAYS.items():
            seen = []

            def traced(*args, **kwargs):
                res = jax_trace(*args, **kwargs)
                seen.append(np.asarray(res[1], np.float64))
                return res
            mp.setattr(jint, "trace", traced)
            res = getattr(jprof, fn)(None, scene=rt.builders.cornell_box(),
                                     **REPLAY_KW, **kw)
            mp.undo()
            out[case] = (res, np.stack(seen))
    return out


@pytest.mark.parametrize("case", list(REPLAYS))
def test_replays_match_jax(case, jax_replays):
    """The port's replay arithmetic on the JAX package's lengths (given as
    lengths=) gives the JAX package's result for the same arguments: every
    key, numbers to 1e-9; the port's own lengths (its trace) part from
    JAX's on fewer than 1% of the paths; lengths of another shape raise."""
    fn, kw = REPLAYS[case]
    want, L = jax_replays[case]
    scene = _builtin(pt, "cornell_box", 32)
    own = prof.path_lengths(pt.compile_scene(scene), scene.camera,
                            n_samples=4, max_depth=4)
    assert own.shape == L.shape and (own != L).mean() < FLIP_FRAC
    got = getattr(prof, fn)(None, scene=pt.builders.cornell_box(),
                            device="cpu", lengths=L, **REPLAY_KW, **kw)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-9, (k, got[k], v)
        elif isinstance(v, list):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-9)
        else:
            assert got[k] == v, (k, got[k], v)
    with pytest.raises(ValueError, match="lengths of shape"):
        getattr(prof, fn)(None, scene=pt.builders.cornell_box(),
                          device="cpu", lengths=L[:, :-1], **REPLAY_KW, **kw)


def test_schedule_replay_assertions():
    """tests/test_parallel.py::test_schedule_utilization_replay on the
    port: compaction beats the single pass, the oracle key bounds the
    samples key, utilization in (0, 1], three phase entries; and the
    wavefront replay's utilizations in (0, 1], the sorted assignment the
    best of the three."""
    kw = dict(width=64, n_samples=9, max_depth=12, rows_per_tile=8,
              device="cpu")
    single = prof.schedule_utilization(
        caps=(), scene=pt.builders.cornell_box(), **kw)
    two = prof.schedule_utilization(
        caps=(18, 18), scene=pt.builders.cornell_box(), **kw)
    oracle = prof.schedule_utilization(
        caps=(18, 18), key="oracle", scene=pt.builders.cornell_box(), **kw)
    for r in (single, two, oracle):
        assert 0.0 < r["utilization"] <= 1.0, r
    assert two["utilization"] > single["utilization"], (single, two)
    assert oracle["utilization"] >= two["utilization"] - 1e-9
    assert len(two["phase_mean_iters"]) == 3
    wave = prof.wavefront_utilization(
        None, scene=pt.builders.cornell_box(), width=32, n_samples=4, max_depth=8,
        device="cpu")
    for k in ("utilization", "utilization_stride", "utilization_sorted"):
        assert 0.0 < wave[k] <= 1.0, wave
    assert wave["utilization_sorted"] >= max(wave["utilization"],
                                             wave["utilization_stride"])
    assert wave["rows_per_tile"] == 32     # Cornell: <= 64 primitives


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


def test_measured_ops_per_bounce():
    """The plain trace's aten ops per ray and bounce iteration: the JAX
    test's range for Cornell at 32 px d4 (tests/test_parallel.py:100-112),
    more on bouncing_spheres (485 spheres, each tested every bounce), None
    where no bounce ran. The counts are 2268.5 (Cornell) and 22293.2
    (bouncing) on the CPU, 2.53 and 3.24 times the JAX package's XLA
    cost_analysis flops per ray and max_depth iteration (895.0 and
    6876.9): the rules differ (comparisons, selects and the RNG's integer
    ops count in this one)."""
    s = _builtin(pt, "cornell_box", 32)
    v = prof.measured_ops_per_bounce(pt.compile_scene(s), s.camera,
                                     width=32, max_depth=4)
    assert 100.0 < v < 20000.0, v
    b = _builtin(pt, "bouncing_spheres", 32)
    vb = prof.measured_ops_per_bounce(pt.compile_scene(b), b.camera,
                                      width=32, max_depth=4)
    assert vb > v, (vb, v)
    assert prof.measured_ops_per_bounce(pt.compile_scene(s), s.camera,
                                        width=8, max_depth=0) is None


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


def test_device_busy_reads_kernel_intervals(tmp_path):
    """device_busy: the union of the kernels' intervals over the window
    from the first event to the end of the last, kernels by name."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 100.0,
         "dur": 900.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 200.0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 250.0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 600.0, "dur": 200},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 50.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy = prof.device_busy(str(path))
    assert busy["window_ms"] == pytest.approx(0.9)
    assert busy["busy_ms"] == pytest.approx(0.35)
    assert busy["busy_share"] == pytest.approx(0.35 / 0.9)
    assert busy["kernels"] == {"k1": {"ms": pytest.approx(0.2),
                                      "launches": 2},
                               "k2": {"ms": pytest.approx(0.2),
                                      "launches": 1}}


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
