"""run.py end to end on the CPU at a tiny size: no card means no result;
every cell's sound run is correct; a run whose timed path is broken
underneath, once for each fault a cell can have, is not; and the control
(the reference in bfloat16 in the program's place) fails a number."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import control
import run
from harness import loader

import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu_torch.models import render as pt_render
from real_time_ray_tracing_engine_tpu_torch.parallel import train

SPEC = loader.load_json(loader.BENCH_ROOT.parent / "BENCHMARK.json")
TINY = {"image_width": 16, "samples_per_pixel": 4, "max_depth": 4}
TINY_TRAIN = {"image_width": 16, "image_height": 9, "samples_per_pixel": 4,
              "max_depth": 4}
SEED = "3141592653589"


def tiny(workload):
    return TINY_TRAIN if "train" in workload else TINY


def run_cell(workload, capsys, trace=0, seconds=0.3, root=loader.BENCH_ROOT):
    rc = run.main(["--workload", workload, "--seed", SEED, "--seconds",
                   str(seconds), "--trace", str(trace)],
                  device=torch.device("cpu"), shrink=tiny(workload),
                  root=root)
    assert rc == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    # the numbers compared, beside their limits: the last lines of stderr
    # and the result's last key
    assert list(out)[-1] == "checks"
    tail = captured.err.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in tail)
    return out


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "cornell_box.render", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=loader.BENCH_ROOT.parent, env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(workload, trace, capsys):
    out = run_cell(workload, capsys, trace=trace)
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in loader.metrics_of(
        SPEC, "end_to_end" if trace == 0 else "per_layer", workload)}
    if trace == 0:
        assert set(out["metrics"]) == want
    else:
        # no device on the CPU: no device metric, no busy time
        assert out["metrics"] == {}
        assert out["device"]["busy_s"] == 0.0


def _scaled(fn, factor):
    def wrapped(*a, **k):
        return fn(*a, **k) * factor
    return wrapped


def _half_samples(fn):
    def wrapped(scene, *a, **k):
        spp = scene.camera.samples_per_pixel
        return fn(scene, *a, spp=spp // 2, **k)
    return wrapped


def _half_rows(fn):
    def wrapped(*a, **k):
        img = fn(*a, **k).clone()
        img[img.shape[0] // 2:] = 0.0
        return img
    return wrapped


RENDER_FAULTS = {
    "answer_altered": lambda m: m.setattr(pt, "render",
                                          _scaled(pt.render, 1.05)),
    "half_the_samples": lambda m: m.setattr(pt, "render",
                                            _half_samples(pt.render)),
    "half_the_rows": lambda m: m.setattr(pt, "render", _half_rows(pt.render)),
}


def _frame_move_ignored(m):
    m.setattr(pt_render.ProgressiveRenderer, "move_camera",
              lambda self, delta: self.reset())


def _frame_step_unchanged(m):
    def step(self, k=1):
        self.samples_taken += k
        return True
    m.setattr(pt_render.ProgressiveRenderer, "step", step)


def _frame_half_rows(m):
    orig = pt_render.ProgressiveRenderer.step

    def step(self, k=1):
        before = self.acc.clone()
        out = orig(self, k)
        self.acc[self.height // 2:] = before[self.height // 2:]
        return out
    m.setattr(pt_render.ProgressiveRenderer, "step", step)


FRAME_FAULTS = {
    "move_ignored": _frame_move_ignored,
    "step_unchanged": _frame_step_unchanged,
    "half_the_rows": _frame_half_rows,
    "answer_altered": lambda m: m.setattr(
        pt_render.ProgressiveRenderer, "image",
        _scaled(pt_render.ProgressiveRenderer.image, 1.05)),
}


def _train_unchanged(m):
    m.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _train_half_batch(m):
    def loss(img, target, mesh):
        h = img.shape[0] // 2
        return torch.mean((img[:h] - target[:h]) ** 2)
    m.setattr(train, "mesh_loss", loss)


def _train_altered(m):
    orig = train.make_kernel_render

    def make(*a, **k):
        return _scaled(orig(*a, **k), 1.05)
    m.setattr(train, "make_kernel_render", make)


TRAIN_FAULTS = {"state_unchanged": _train_unchanged,
                "half_the_batch": _train_half_batch,
                "answer_altered": _train_altered}

CASES = ([("cornell_box.render", k, f) for k, f in RENDER_FAULTS.items()]
         + [("bouncing_spheres.render", "answer_altered",
             RENDER_FAULTS["answer_altered"])]
         + [("cornell_box.frame", k, f) for k, f in FRAME_FAULTS.items()]
         + [("bouncing_spheres.train_adjoint", k, f)
            for k, f in TRAIN_FAULTS.items()])


@pytest.fixture
def early_frames(tmp_path):
    """A copy of the benchmark's parts whose frame cell compares frames
    among the first 20 (a tiny run makes few), none of them edited."""
    root = tmp_path / "bench"
    for kind in ("configs", "traffic", "drivers", "metrics", "cells"):
        shutil.copytree(loader.BENCH_ROOT / kind, root / kind)
    path = root / "cells" / "cornell_box.frame.json"
    cell = json.loads(path.read_text())
    cell["check"]["among_first"] = 20
    path.write_text(json.dumps(cell))
    return root


@pytest.mark.parametrize("workload,fault,plant", CASES,
                         ids=[f"{w}-{k}" for w, k, _ in CASES])
def test_a_broken_timed_path_is_not_correct(workload, fault, plant,
                                            monkeypatch, capsys,
                                            early_frames):
    plant(monkeypatch)
    root = early_frames if "frame" in workload else loader.BENCH_ROOT
    out = run_cell(workload, capsys, seconds=0.5, root=root)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_control_fails_a_number(workload):
    cell = loader.Cell(SPEC, workload)
    got = control.readings(cell, int(SEED), 0.3, torch.device("cpu"),
                           shrink=tiny(workload))
    limits = cell.limits["limits"]
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(not got["control"][k] <= v for k, v in limits.items()), got
