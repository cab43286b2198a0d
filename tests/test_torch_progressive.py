"""The port's progressive renderer, terminal viewer, checkpoints, debug dump
and the CLI's dynamic modes on the CPU, against the JAX package.

The JAX progressive run is computed once for the module (jax_run); the
scene is cornell_box at width 24, spp4, depth 4 (depth 4: XLA's CPU FMAs
part from torch's two roundings on deeper grazing paths).
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import real_time_ray_tracing_engine_tpu as rt
import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu.models import viewer as jviewer
from real_time_ray_tracing_engine_tpu.scene import analyze as janalyze
from real_time_ray_tracing_engine_tpu.utils import cli as jcli
from real_time_ray_tracing_engine_tpu_torch.models import render as prender
from real_time_ray_tracing_engine_tpu_torch.models import viewer as pviewer
from real_time_ray_tracing_engine_tpu_torch.scene import analyze as panalyze
from real_time_ray_tracing_engine_tpu_torch.scene.convert import (
    camera_to_numpy, progressive_from_numpy)
from real_time_ray_tracing_engine_tpu_torch.utils import cli, color

from test_pallas import _assert_close as assert_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
DELTA = (1.5, -0.5, -3.0)
SMALL = ["--width", "24", "--samples", "4", "--depth", "4", "--device", "cpu"]


def _small(mod, name="cornell_box", width=24, spp=4, depth=4):
    scene = mod.builders.BUILTIN_SCENES[name]()
    scene.camera.image_width = width
    scene.camera.samples_per_pixel = spp
    scene.camera.max_depth = depth
    return scene


def _prog(**kw):
    return pt.ProgressiveRenderer(_small(pt, **kw), device="cpu", seed=SEED)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX ProgressiveRenderer's images step by step, its state after 2
    strata, its camera after move_camera(DELTA) and its images after a
    move and after set_spp(9)."""
    jp = rt.ProgressiveRenderer(_small(rt), seed=SEED)
    out = {"img": []}
    for i in range(4):
        if i == 2:
            out["state2"] = {"acc": np.asarray(jp.acc),
                             "samples_taken": jp.samples_taken,
                             "seed": jp.seed, "n_strata": jp.n_strata}
        jp.step()
        out["img"].append(np.asarray(jp.image()))
    out["converged"] = jp.converged
    jp.move_camera(DELTA)
    out["cam"] = camera_to_numpy(jp.cam)
    jp.step()
    out["moved"] = np.asarray(jp.image())
    jp.set_spp(9)
    jp.step()
    out["spp9"] = (np.asarray(jp.image()), jp.n_strata)
    return out


def test_progressive_matches_jax_step_by_step(jax_run):
    prog = _prog()
    for want in jax_run["img"]:
        assert prog.step()
        assert_close(prog.image().numpy(), want)
    assert prog.converged == jax_run["converged"] and prog.converged
    assert not prog.step() and prog.samples_taken == 4


def test_move_camera_and_set_spp_match_jax(jax_run):
    prog = _prog()
    prog.step(2)
    prog.move_camera(DELTA)
    assert prog.samples_taken == 0 and float(prog.acc.abs().sum()) == 0.0
    got = camera_to_numpy(prog.cam)
    for name, want in jax_run["cam"].items():
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-6,
                                   err_msg=name)
    prog.step()
    assert_close(prog.image().numpy(), jax_run["moved"])
    prog.set_spp(9)
    assert prog.samples_taken == 0 and prog.n_strata == jax_run["spp9"][1]
    prog.step()
    assert_close(prog.image().numpy(), jax_run["spp9"][0])


def test_step_k_matches_single_steps():
    """step(3) then step(3) (clamped to the one stratum left) renders the
    same image as four step() calls."""
    a = _prog()
    assert a.step(3) and a.samples_taken == 3
    assert a.step(3) and a.samples_taken == 4 and a.converged
    b = _prog()
    while b.step():
        pass
    np.testing.assert_allclose(a.image().numpy(), b.image().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cols, rows", [(20, 14), (7, 30)])
def test_preview_equals_downsampled_bytes(cols, rows):
    prog = _prog()
    prog.step(2)
    got = prog.preview(cols, rows)
    assert got.dtype == np.uint8 and got.shape == (rows, cols, 3)
    want = pviewer._downsample(color.to_bytes(prog.image()), cols, rows)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed, shape, cols, rows", [
    (0, (8, 8, 3), 4, 2), (1, (31, 17, 3), 13, 9), (2, (5, 40, 3), 40, 6)])
def test_frame_to_ansi_matches_jax(seed, shape, cols, rows):
    gen = np.random.default_rng(seed)
    img = gen.integers(0, 256, size=shape, dtype=np.uint8)
    img[: shape[0] // 2, : shape[1] // 2] = img[0, 0]   # runs of one color
    assert (pviewer.frame_to_ansi(img, cols, rows)
            == jviewer.frame_to_ansi(img, cols, rows))
    np.testing.assert_array_equal(pviewer._downsample(img, cols, rows),
                                  jviewer._downsample(img, cols, rows))


@pytest.mark.parametrize("fps", [
    [1000.0] * 8,
    [40.0, 40.0, 10.0, 20.0, 31.0, 5.0, 5.0, 50.0, 14.9, 30.1],
    list(np.random.default_rng(4).uniform(0.0, 60.0, 40))])
def test_adaptive_work_matches_jax(fps):
    for cap in (16, 8):
        p, j = pviewer.AdaptiveWork(cap), jviewer.AdaptiveWork(cap)
        assert [p.update(f) for f in fps] == [j.update(f) for f in fps]
    assert (pviewer.AdaptiveWork.FPS_LO, pviewer.AdaptiveWork.FPS_HI) \
        == (15.0, 30.0)
    assert pviewer.KEY_MOVES == jviewer.KEY_MOVES


def test_run_viewer_checkpoint_and_resume(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO())     # not a TTY
    scene = _small(pt)
    ckpt = str(tmp_path / "view.npz")
    buf = io.StringIO()
    prog = pviewer.run_viewer(scene, device="cpu", seed=SEED, max_frames=2,
                              checkpoint=ckpt, out=buf, adaptive=False)
    assert prog.samples_taken == 2 and os.path.exists(ckpt)
    assert "fps" in buf.getvalue() and "▀" in buf.getvalue()
    buf2 = io.StringIO()
    prog2 = pviewer.run_viewer(scene, device="cpu", seed=SEED,
                               checkpoint=ckpt, out=buf2)
    assert prog2.converged and prog2.samples_taken == 4
    assert "Converged" in buf2.getvalue()
    ref = _prog()
    while ref.step():
        pass
    np.testing.assert_array_equal(prog2.image().numpy(), ref.image().numpy())


@pytest.mark.parametrize("case", ["scene", "width", "depth", "spp",
                                  "no_fingerprint"])
def test_checkpoint_refusals(case, tmp_path):
    src = _prog()
    src.step()
    path = str(tmp_path / "state.npz")
    src.save(path)
    kw, match = {"scene": ({"name": "cornell_smoke"}, "another scene"),
                 "width": ({"width": 32}, "width"),
                 "depth": ({"depth": 5}, "max_depth"),
                 "spp": ({"spp": 9}, "n_strata"),
                 "no_fingerprint": ({}, "no fingerprint")}[case]
    if case == "no_fingerprint":
        with np.load(path) as d:
            keys = {k: d[k] for k in ("acc", "samples_taken", "seed",
                                      "n_strata")}
        np.savez(path, **keys)                # the JAX package's keys
    dst = _prog(**kw)
    with pytest.raises(prender.CheckpointMismatch, match=match):
        dst.load(path)
    assert dst.samples_taken == 0 and float(dst.acc.abs().sum()) == 0.0


def test_checkpoint_restores_the_moved_camera(tmp_path):
    a = _prog()
    a.move_camera(DELTA)
    a.step(2)
    path = str(tmp_path / "moved.npz")
    a.save(path)
    b = _prog()
    b.load(path)
    assert b.cfg == a.cfg and b.samples_taken == 2 and b.seed == SEED
    for name, want in camera_to_numpy(a.cam).items():
        np.testing.assert_array_equal(camera_to_numpy(b.cam)[name], want)
    np.testing.assert_array_equal(b.acc.numpy(), a.acc.numpy())
    while a.step():
        pass
    while b.step():
        pass
    np.testing.assert_array_equal(b.image().numpy(), a.image().numpy())


def test_jax_state_carried_into_the_port(jax_run):
    """A JAX run stopped after 2 strata, carried across as numpy and
    continued to convergence in the port, matches the JAX run continued."""
    prog = progressive_from_numpy(_small(pt), jax_run["state2"],
                                  device="cpu")
    assert prog.samples_taken == 2 and prog.seed == SEED
    while prog.step():
        pass
    assert_close(prog.image().numpy(), jax_run["img"][-1])
    bad = dict(jax_run["state2"], n_strata=3)
    with pytest.raises(ValueError, match="n_strata"):
        progressive_from_numpy(_small(pt), bad, device="cpu")


def test_failing_pass_propagates_from_step(monkeypatch):
    """No fallback: a pass that raises leaves step with the error and the
    state unchanged (the inverse of the JAX package's
    test_progressive_fallback_on_kernel_failure)."""
    prog = _prog()
    prog.step()
    acc = prog.acc.clone()

    def boom(*args, **kwargs):
        raise RuntimeError("wavefront kernel launch failed: injected")
    monkeypatch.setattr(prender, "_render_pass", boom)
    with pytest.raises(RuntimeError, match="injected"):
        prog.step(2)
    assert prog.samples_taken == 1 and prog.engine == "torch"
    np.testing.assert_array_equal(prog.acc.numpy(), acc.numpy())


@pytest.mark.parametrize("use_bvh", [False, True])
@pytest.mark.parametrize("name", sorted(pt.builders.BUILTIN_SCENES))
def test_analyze_matches_jax(name, use_bvh, tmp_path):
    sj = rt.builders.BUILTIN_SCENES[name]()
    sp = pt.builders.BUILTIN_SCENES[name]()
    fj = rt.compile_scene(sj, use_bvh=use_bvh)
    fp = pt.compile_scene(sp, use_bvh=use_bvh)
    rep = panalyze.analyze(sp, fp)
    assert rep == janalyze.analyze(sj, fj)
    assert panalyze.analyze(sp) == janalyze.analyze(sj)
    text = panalyze.format_report(rep)
    assert text == janalyze.format_report(janalyze.analyze(sj, fj))
    assert panalyze.dump_report(sp, fp, str(tmp_path / "p.txt")) == text
    janalyze.dump_report(sj, fj, str(tmp_path / "j.txt"))
    assert ((tmp_path / "p.txt").read_bytes()
            == (tmp_path / "j.txt").read_bytes())


# ------------------------------------------------------------------ CLI
def _render_bytes(scene, **kw):
    img = pt.render(scene, device="cpu", samples_per_batch=1,
                    schedule="single", progress=lambda s, t: None, **kw)
    return img, color.encode_ppm_p3(color.to_bytes(img))


def test_cli_dynamic_frames_checkpoint_resume(tmp_path, monkeypatch):
    """--frames 2 --checkpoint writes a PPM and a checkpoint at 2 strata; a
    second run resumes there and converges, equal bit for bit to render()
    in passes of one sample."""
    monkeypatch.chdir(tmp_path)
    argv = ["--camera", "dynamic", "--checkpoint", "s.npz", "--seed",
            str(SEED), *SMALL]
    assert cli.main([*argv, "--frames", "2"]) == 0
    with np.load("s.npz") as d:
        assert int(d["samples_taken"]) == 2 and int(d["n_strata"]) == 2
    assert (tmp_path / "output" / "output_image.ppm").exists()
    assert cli.main(argv) == 0
    img, ppm = _render_bytes(_small(pt), seed=SEED)
    assert (tmp_path / "output" / "output_image.ppm").read_bytes() == ppm
    with np.load("s.npz") as d:
        assert int(d["samples_taken"]) == 4
        np.testing.assert_array_equal(d["acc"] / np.float32(4), img.numpy())


def test_cli_view_without_a_tty(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    assert cli.main(["--camera", "dynamic", "--view", "--checkpoint",
                     "v.npz", "--seed", str(SEED), *SMALL]) == 0
    assert "Converged" in capsys.readouterr().out
    with np.load("v.npz") as d:
        assert int(d["samples_taken"]) == 4
    ref = _prog()
    while ref.step():
        pass
    assert ((tmp_path / "output" / "output_image.ppm").read_bytes()
            == color.encode_ppm_p3(color.to_bytes(ref.image())))


@pytest.mark.parametrize("bvh", [[], ["-b"]])
def test_cli_debug_dump_matches_the_jax_cli(bvh, tmp_path, monkeypatch):
    """-d writes the JAX CLI's two files byte for byte (the JAX CLI's
    render after its dump is stubbed out: only the dump is compared)."""
    argv = ["--scene", "three_spheres", "-d", *bvh, "--width", "16",
            "--samples", "1", "--depth", "2"]
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    monkeypatch.chdir(tmp_path / "p")
    assert cli.main([*argv, "--device", "cpu"]) == 0
    monkeypatch.chdir(tmp_path / "j")
    monkeypatch.setattr(rt, "render", lambda scene, **kw: np.zeros(
        (16, 16, 3), np.float32))
    assert jcli.main(argv) == 0
    for name in ("flat_scene_debug.json", "scene_complexity_debug.txt"):
        p = (tmp_path / "p" / "logs" / name).read_bytes()
        assert p == (tmp_path / "j" / "logs" / name).read_bytes(), name
    flat = pt.compile_scene(_small(pt, "three_spheres", 16, 1, 2),
                            use_bvh=bool(bvh))
    assert (tmp_path / "p" / "logs" / "flat_scene_debug.json").read_text() \
        == pt.golden_json(flat)


def test_cli_dynamic_bvh(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--camera", "dynamic", "-b", "--scene",
                     "bouncing_spheres", "--width", "24", "--samples", "4",
                     "--depth", "2", "--device", "cpu"]) == 0
    _, ppm = _render_bytes(_small(pt, "bouncing_spheres", 24, 4, 2),
                           use_bvh=True)
    assert (tmp_path / "output" / "output_image.ppm").read_bytes() == ppm


def test_cli_refuses_a_checkpoint_of_another_scene(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    prog = _prog()
    prog.step()
    prog.save("other.npz")
    with pytest.raises(SystemExit) as exc:
        cli.main(["--camera", "dynamic", "--scene", "cornell_smoke",
                  "--checkpoint", "other.npz", *SMALL])
    assert exc.value.code == 2
    assert "another scene" in capsys.readouterr().err
    assert not (tmp_path / "output" / "output_image.ppm").exists()


@pytest.mark.parametrize("flags", [["--view"], ["--frames", "3"],
                                   ["--checkpoint", "state.npz"]])
def test_cli_progressive_flags_need_dynamic(flags, tmp_path, monkeypatch,
                                            capsys):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        cli.main([*flags, *SMALL])
    assert exc.value.code == 2
    assert "--camera dynamic" in capsys.readouterr().err
    assert not (tmp_path / "output").exists()


def test_import_without_jax():
    code = ("import sys\n"
            "import real_time_ray_tracing_engine_tpu_torch as pt\n"
            "from real_time_ray_tracing_engine_tpu_torch.models import "
            "viewer\n"
            "from real_time_ray_tracing_engine_tpu_torch.scene import "
            "analyze, convert\n"
            "from real_time_ray_tracing_engine_tpu_torch.utils import cli\n"
            "assert pt.ProgressiveRenderer\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'real_time_ray_tracing_engine_tpu.')) "
            "or m == 'real_time_ray_tracing_engine_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_progressive_needs_the_gpu_unless_the_cpu_is_asked_for():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.ProgressiveRenderer(_small(pt))
