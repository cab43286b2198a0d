"""The port's entry points on the CPU: rt.render(device="cpu") and the CLI,
against the JAX package's render and PPM bytes."""
import os
import subprocess
import sys

import numpy as np
import pytest

import real_time_ray_tracing_engine_tpu as rt
import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu.utils.color import \
    to_bytes as jax_to_bytes
from real_time_ray_tracing_engine_tpu_torch.models import camera as pcam
from real_time_ray_tracing_engine_tpu_torch.utils import cli, color

from test_pallas import _assert_close as assert_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--width", "24", "--samples", "4", "--depth", "4"]


def _small(mod, name="cornell_box"):
    scene = mod.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = 24
    scene.camera.samples_per_pixel = 4
    scene.camera.max_depth = 4
    return scene


@pytest.mark.parametrize("name", ["cornell_box", "simple_sphere"])
def test_render_matches_jax_render(name):
    """The slice end to end on the CPU: scene -> compile -> camera -> plain
    integrator -> averaged image, per pixel against the JAX package's render
    (tests/test_pallas.py::_assert_close on the averaged images)."""
    img_p = pt.render(_small(pt, name), device="cpu", seed=2).numpy()
    img_j = np.asarray(rt.render(_small(rt, name), engine="jax", seed=2))
    assert img_p.shape == img_j.shape
    assert_close(img_p, img_j)


def test_render_flat_scene_and_argument_errors():
    scene = _small(pt)
    img = pt.render(scene, device="cpu")
    flat = pt.compile_scene(scene)
    again = pt.render(flat, scene.camera, device="cpu")
    np.testing.assert_array_equal(img.numpy(), again.numpy())
    with pytest.raises(ValueError, match="CameraConfig"):
        pt.render(flat, device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        pt.render(scene, device="cpu", schedule="fast")
    with pytest.raises(ValueError, match="engine"):
        pt.render(scene, device="cpu", engine="pallas")


def test_cli_writes_the_jax_ppm_bytes(tmp_path):
    """`python -m real_time_ray_tracing_engine_tpu_torch` on the CPU writes
    the PPM that the JAX package's encoder writes for the same image."""
    out = subprocess.run(
        [sys.executable, "-m", "real_time_ray_tracing_engine_tpu_torch",
         "--scene", "cornell_box", *SMALL, "--device", "cpu", "--output",
         "small"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    written = (tmp_path / "output" / "small.ppm").read_bytes()

    img = pt.render(_small(pt), device="cpu")
    rt.write_ppm(str(tmp_path / "jax.ppm"), np.asarray(img.numpy()))
    assert written == (tmp_path / "jax.ppm").read_bytes()
    b = jax_to_bytes(img.numpy())
    np.testing.assert_array_equal(np.asarray(b), pt.to_bytes(img))
    np.testing.assert_array_equal(pt.read_ppm(tmp_path / "output/small.ppm"),
                                  np.asarray(b))
    w, h = pcam.image_size(_small(pt).camera)
    assert written.startswith(f"P3\n{w} {h}\n255\n".encode())


def _join_p3(b):
    """The P3 encoding as a string join per pixel: the port's encoder
    before it was vectorised, and the JAX package's fallback."""
    h, w, _ = b.shape
    rows = b.reshape(-1, 3).astype(str)
    body = "\n".join(" ".join(r) for r in rows) + "\n"
    return f"P3\n{w} {h}\n255\n".encode() + body.encode()


@pytest.mark.parametrize("shape", [(16, 16, 3), (1, 1, 3), (1, 7, 3),
                                   (5, 1, 3), (3, 85, 3)])
def test_encode_ppm_p3_matches_the_join(shape):
    """The vectorised P3 encoder writes the join's bytes: every value 0-255
    (1, 2 and 3 digits) in order and shuffled, and odd shapes (1x1, 1xW,
    Hx1)."""
    n = int(np.prod(shape))
    vals = np.arange(n) % 256
    for b in (vals, np.random.default_rng(n).permutation(vals)):
        b = b.astype(np.uint8).reshape(shape)
        assert color.encode_ppm_p3(b) == _join_p3(b)


@pytest.mark.parametrize("flags", [["-p"], ["-b", "-p"],
                                   ["--camera", "dynamic", "-p"]])
def test_cli_flags_not_yet_ported(flags, tmp_path, monkeypatch, capsys):
    """No flag exits "not yet ported" any more: -p (the sharded render,
    tests/test_torch_distributed.py) renders on the CPU as one rank, with
    -b through the BVH oracle, and rank 0 writes the PPM; -p with --camera
    dynamic is refused before any work (exit 2), naming both."""
    monkeypatch.chdir(tmp_path)
    argv = ["--scene", "cornell_box", "--device", "cpu", "--width", "8",
            "--samples", "1", "--depth", "2", *flags]
    if "dynamic" in flags:
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "-p/--parallel" in err and "--camera dynamic" in err
        assert not (tmp_path / "output").exists()
    else:
        assert cli.main(argv) == 0
        err = capsys.readouterr().err
        assert "not yet ported" not in err and "[INFO] -p rank 0" in err
        assert (tmp_path / "output" / "output_image.ppm").exists()
