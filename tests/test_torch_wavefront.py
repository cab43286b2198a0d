"""The forward wavefront's plain torch version, its compacted driver and its
dispatch, on the CPU.

render_pass_reference is the CUDA kernel's semantics lane for lane
(persistent lane regeneration, cap / carry / pix_lanes); here it is checked
against the JAX package's oracle (_render_pass) per pixel, and the
capped + compacted schedule against the single pass as tests/test_pallas.py
checks the Pallas kernel's. The kernel itself runs only on a GPU
(tests/test_torch_cuda.py).
"""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import real_time_ray_tracing_engine_tpu as rt
import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu.models import camera as jcam
from real_time_ray_tracing_engine_tpu.models.render import \
    _render_pass as jax_render_pass
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.models.render import (
    pick_engine, render)
from real_time_ray_tracing_engine_tpu_torch.ops import wavefront_cuda as wc
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_from_numpy, camera_to_numpy, flat_from_numpy, flat_to_numpy)

from test_pallas import _assert_close as assert_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_pass_args(name, width, spp, depth):
    scene = pt.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = width
    flat = pt.compile_scene(scene)
    cam = pcam.derive(scene.camera)
    w, h = pcam.image_size(scene.camera)
    n_strata = int(np.sqrt(spp))
    kw = dict(width=w, height=h, n_strata=n_strata, max_depth=depth,
              n_samples=spp, sky_gradient=scene.camera.sky_gradient)
    return flat, cam, kw


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_lane_wavefront_matches_jax(name):
    """Regeneration mid-pass: each lane traces 4 samples of up to 4
    bounces. Depth stays at the oracle tests' 4: the JAX oracle runs
    jit-compiled, and XLA's CPU backend contracts a*b+c into FMAs where
    torch rounds twice, so grazing paths that re-hit their own surface near
    T_MIN part ways, more of them the deeper the paths (Cornell 40 px,
    4 samples: 0.69% of pixels past 1e-3 at depth 2, 1.06% at depth 8)."""
    scene = rt.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = 32
    jf, jc = rt.compile_scene(scene), jcam.derive(scene.camera)
    pf = flat_from_numpy(*flat_to_numpy(jf), device="cpu")
    pc = camera_from_numpy(camera_to_numpy(jc), device="cpu")
    w, h = jcam.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=2, max_depth=4, n_samples=4,
              sky_gradient=False)
    img_j = np.asarray(jax_render_pass(jf, jc, jnp.uint32(3), jnp.int32(0),
                                       tile_rows=min(h, 32), **kw))
    img_p = wc.render_pass_reference(pf, pc, 3, 0, **kw).numpy()
    assert img_p.shape == (h, w, 3)
    assert_close(img_p, img_j)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_compacted_matches_single_pass(name):
    """tests/test_pallas.py::test_compacted_schedule_matches_single_pass on
    the plain version: the compaction permutes lanes and splits each lane's
    radiance sum at the caps, so the image agrees to rounding."""
    flat, cam, kw = _port_pass_args(name, 40, 4, 8)
    one = wc.render_pass(flat, cam, 7, 3, **kw).numpy()
    for sched in ({"cap": 6}, {"cap": 6, "phases": 3}, {"caps": (4, 4)}):
        two = wc.render_pass_compacted(flat, cam, 7, 3, **sched, **kw)
        assert np.allclose(one, two.numpy(), atol=1e-5), sched
    # the carry really held mid-path state at the first cap
    rad, st = wc.render_pass(flat, cam, 7, 3, cap=6, **kw)
    assert st.shape == (wc.CARRY_ROWS, rad.shape[1])
    assert bool((st[0] > 0.5).any()) and bool((st[2] > 0).any())


def test_one_pass_of_two_samples_equals_two_passes():
    """tests/test_pallas.py::test_progressive_stratum_equals_batch_sample:
    regeneration keeps every (pixel, sample) stream intact."""
    flat, cam, kw = _port_pass_args("cornell_box", 32, 4, 3)
    kw.pop("n_samples")
    both = wc.render_pass(flat, cam, 0, 0, n_samples=2, **kw)
    s0 = wc.render_pass(flat, cam, 0, 0, n_samples=1, **kw)
    s1 = wc.render_pass(flat, cam, 0, 1, n_samples=1, **kw)
    np.testing.assert_allclose(both.numpy(), (s0 + s1).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_pad_lanes_repeat_the_last_pixel():
    """40x22 = 880 pixels pad to 896 lanes; pad lanes trace the last
    pixel's paths and are cropped from the image."""
    flat, cam, kw = _port_pass_args("simple_sphere", 40, 4, 4)
    n_pix = kw["width"] * kw["height"]
    assert wc.lane_count(n_pix) > n_pix
    rad, _ = wc.render_pass(flat, cam, 1, 0, cap=1000, **kw)
    img = wc.render_pass(flat, cam, 1, 0, **kw)
    np.testing.assert_array_equal(rad[:, n_pix:].numpy(),
                                  rad[:, n_pix - 1:n_pix].expand(
                                      -1, rad.shape[1] - n_pix).numpy())
    np.testing.assert_array_equal(img.reshape(-1, 3).numpy(),
                                  rad[:, :n_pix].T.numpy())


def test_engine_cuda_raises_on_cpu():
    flat, cam, kw = _port_pass_args("cornell_box", 16, 1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        pick_engine(flat, "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        render(pt.builders.cornell_box(), device="cpu", engine="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        wc.render_pass_kernel(flat, cam, 0, 0, **kw)
    assert pick_engine(flat, "auto") == "torch"


def test_auto_engine_on_a_gpu_follows_the_gate(monkeypatch, capsys):
    """On a CUDA device, auto takes the kernel inside the gate (the
    unrolled instance, or the chunk scan past the unrolled bounds) and
    raises outside it, as engine="cuda" does, naming the reason and, past
    MAX_PRIMS_SCAN, the BVH kernels not yet ported; the plain engine runs on
    the card only when asked for. (The scene's device is faked: only the
    decision runs.)"""
    from real_time_ray_tracing_engine_tpu_torch.scene.flat import FlatScene
    monkeypatch.setattr(FlatScene, "device",
                        property(lambda self: torch.device("cuda", 0)))
    inside = pt.compile_scene(pt.builders.cornell_smoke())
    assert pick_engine(inside, "auto") == "cuda"
    mediums = pt.compile_scene(pt.Scene(objects=[pt.ConstantMedium(
        pt.Box((i, 0, 0), (i + 1, 1, 1),
               pt.Lambertian(pt.SolidColor((1, 1, 1)))),
        0.1, pt.SolidColor((1, 1, 1))) for i in range(5)]))

    def spheres(n):
        return pt.compile_scene(pt.Scene(objects=[
            pt.Sphere((3.0 * (i % 128), 3.0 * (i // 128), 0), 1.0,
                      pt.Lambertian(pt.SolidColor((1, 1, 1))))
            for i in range(n)]))
    assert pick_engine(spheres(80), "auto") == "cuda"
    past_scan = spheres(wc.MAX_PRIMS_SCAN + 1)
    for outside, why in ((mediums, "MAX_MEDIUMS"), (past_scan, "K11/K12")):
        for engine in ("auto", "cuda"):
            with pytest.raises(ValueError, match="gate") as exc:
                pick_engine(outside, engine)
            assert why in str(exc.value)
            assert "engine='torch'" in str(exc.value)
        assert pick_engine(outside, "torch") == "torch"
    assert capsys.readouterr().err == ""


def test_compacted_runs_an_explicit_pass_function():
    """pass_fn runs every phase of the compacted schedule (the plain version
    on the card, for the parity check) and changes nothing else."""
    flat, cam, kw = _port_pass_args("cornell_box", 24, 4, 6)
    seen = []

    def spy(*args, **kwargs):
        seen.append((kwargs.get("cap", 0), kwargs.get("carry") is not None))
        return wc.render_pass_reference(*args, **kwargs)

    default = wc.render_pass_compacted(flat, cam, 5, 0, caps=(3, 3), **kw)
    explicit = wc.render_pass_compacted(flat, cam, 5, 0, caps=(3, 3),
                                        pass_fn=spy, **kw)
    assert seen == [(3, False), (3, True), (0, True)]
    np.testing.assert_array_equal(explicit.numpy(), default.numpy())
    assert wc.pass_function(flat, cam) is wc.render_pass_reference


def test_cuda_device_without_gpu_raises(monkeypatch, tmp_path, capsys):
    """No silent CPU fallback: asking for the GPU on a box without one is
    an error, from the library and from the CLI (whose default is cuda)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render(pt.builders.cornell_box(), device="cuda")
    from real_time_ray_tracing_engine_tpu_torch.utils import cli
    with pytest.raises(SystemExit) as exc:
        cli.main(["--scene", "cornell_box", "--width", "8"])
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "output").exists()


def test_import_without_jax():
    code = ("import sys\n"
            "import real_time_ray_tracing_engine_tpu_torch as pt\n"
            "from real_time_ray_tracing_engine_tpu_torch.ops import "
            "wavefront_cuda\n"
            "from real_time_ray_tracing_engine_tpu_torch.scene import "
            "convert\n"
            "from real_time_ray_tracing_engine_tpu_torch.utils import cli\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'real_time_ray_tracing_engine_tpu.')) "
            "or m == 'real_time_ray_tracing_engine_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
