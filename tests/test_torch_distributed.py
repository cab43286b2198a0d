"""The port's multi-process layer on the CPU (parallel/distributed.py, the
CLI's -p): gloo ranks spawned over a file store, never a fixed port (the
suite's workers run at once), each run joined within its own time limit
so that a hung collective fails its test and cannot stall the suite.

The 2- and 4-rank dry runs (dryrun_multichip: one full-family step) give
equal parameters on every rank and the one-process loss; initialize is a
no-op for one process; the shard checkpoints round-trip and refuse another
scene, setting or shard, naming the field; -p under torchrun on two ranks
writes the one-process CLI's PPM, and -p with --camera dynamic exits 2.
The NCCL group and the ranks on the card run in chip_smoke.py (mesh_ranks,
cli_parallel).
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from real_time_ray_tracing_engine_tpu_torch.models.render import \
    CheckpointMismatch
from real_time_ray_tracing_engine_tpu_torch.parallel import distributed
from real_time_ray_tracing_engine_tpu_torch.parallel import mesh
from real_time_ray_tracing_engine_tpu_torch.scene import builders
from real_time_ray_tracing_engine_tpu_torch.scene.compile import \
    compile_scene
from real_time_ray_tracing_engine_tpu_torch.utils import cli
from real_time_ray_tracing_engine_tpu_torch.utils.color import read_ppm
from torch_ranks import cornell, hang_rank
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_S = 120
SMALL = ["--width", "16", "--samples", "4", "--depth", "4", "--device",
         "cpu"]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, tmp_path):
    """One full-family Adam step on n gloo ranks: every rank holds the
    same parameters after it, and its loss and gradients are the
    one-process step's (dryrun_multichip raises otherwise)."""
    rep = distributed.dryrun_multichip(n, timeout_s=120, work_dir=tmp_path)
    assert rep["params_equal_on_every_rank"]
    assert len(rep["losses"]) == n
    assert sorted(rep["shards"]) == [
        (t, s) for t in range(rep["mesh"]["tile"])
        for s in range(rep["mesh"]["sample"])]
    for loss in rep["losses"]:
        assert abs(loss - rep["one_process_loss"]) <= 1e-5 * abs(loss)
    for field in ("tex_color", "mat_ior", "sph_center", "sph_radius"):
        assert rep["grad_scale"][field] > 0.0, field
        assert rep["grad_max_abs_err"][field] <= 1e-4 * \
            rep["grad_scale"][field], field


def test_initialize_is_a_noop_for_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.initialize(device="cpu", world_size=1) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    m = distributed.make_global_mesh()
    assert (m.n_tile, m.n_sample, m.device_mesh) == (1, 1, None)
    flat = compile_scene(cornell(8, 1, 1), device="cpu")
    assert distributed.replicate(flat, m) is flat
    assert "one process" in distributed.describe(m, "cpu")
    assert distributed.choose_backend("cpu", 1) == "gloo"


def test_shard_checkpoints(tmp_path):
    """A shard's accumulation round-trips with its fingerprint and
    settings; another scene, setting or shard, an accumulation of other
    rows and a shard without a fingerprint are refused by name."""
    from real_time_ray_tracing_engine_tpu_torch.models.render import \
        scene_fingerprint
    flat = compile_scene(cornell(8, 4, 4), device="cpu")
    other = compile_scene(builders.simple_sphere(), device="cpu")
    m = mesh.local_shard(2, 2, 1, 0)
    kw = dict(width=8, height=8, n_strata=2, max_depth=4, sky_gradient=False)
    settings = distributed.shard_settings(m, **kw)
    fp = scene_fingerprint(flat, 8, 8, 4, False)
    acc = np.random.default_rng(0).normal(size=(4, 8, 3)).astype(np.float32)
    path = distributed.save_progressive_shard(
        tmp_path, torch.from_numpy(acc), 3, 11, fingerprint=fp,
        settings=settings, rank=2)
    assert path.endswith("shard_00002.npz")
    assert not [p for p in os.listdir(tmp_path) if "tmp" in p]
    got, taken, seed = distributed.load_progressive_shard(
        tmp_path, fingerprint=fp, settings=settings, rank=2)
    np.testing.assert_array_equal(got, acc)
    assert (taken, seed) == (3, 11)
    assert distributed.load_progressive_shard(
        tmp_path, fingerprint=fp, settings=settings, rank=1) is None
    refusals = {
        "fingerprint": dict(fingerprint=scene_fingerprint(other, 8, 8, 4,
                                                          False)),
        "n_strata": dict(settings={**settings, "n_strata": 3}),
        "tile": dict(settings=distributed.shard_settings(
            mesh.local_shard(2, 2, 0, 0), **kw)),
        "n_sample": dict(settings=distributed.shard_settings(
            mesh.local_shard(2, 1, 1, 0), **kw))}
    for field, change in refusals.items():
        args = {"fingerprint": fp, "settings": settings, **change}
        with pytest.raises(CheckpointMismatch, match=field):
            distributed.load_progressive_shard(tmp_path, rank=2, **args)
    distributed.save_progressive_shard(
        tmp_path, acc[:2], 3, 11, fingerprint=fp, settings=settings, rank=5)
    with pytest.raises(CheckpointMismatch, match="acc"):
        distributed.load_progressive_shard(tmp_path, fingerprint=fp,
                                           settings=settings, rank=5)
    np.savez(tmp_path / "shard_00007.npz", acc=acc, samples_taken=3, seed=11)
    with pytest.raises(CheckpointMismatch, match="fingerprint"):
        distributed.load_progressive_shard(tmp_path, fingerprint=fp,
                                           settings=settings, rank=7)


def test_spawned_ranks_are_stopped(tmp_path):
    """A rank still running at the time limit, or beside a rank that
    failed, is killed and the call raises: a hung collective fails its
    test instead of stalling the suite."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        distributed.spawn_ranks(hang_rank, 2, False, timeout_s=2,
                                work_dir=tmp_path / "a")
    with pytest.raises(RuntimeError, match="exited with code"):
        distributed.spawn_ranks(hang_rank, 2, True, timeout_s=60,
                                work_dir=tmp_path / "b")
    assert time.monotonic() - t0 < 40


def test_scaling_report_on_the_cpu():
    """Only ranks with a GPU each are counted: on the CPU the report is
    the one-rank row."""
    scene = builders.cornell_box()
    before = dataclasses.asdict(scene.camera)
    rows = distributed.scaling_report(scene, width=16, n_strata=1,
                                      max_depth=2, device="cpu", reps=1)
    assert dataclasses.asdict(scene.camera) == before
    assert [r["ranks"] for r in rows] == [1]
    assert rows[0]["mesh"] == (1, 1)
    assert rows[0]["efficiency"] == 1.0
    assert np.isfinite(rows[0]["mpaths_s"]) and rows[0]["mpaths_s"] > 0
    # the paths of the 16 x 16 image at one sample, not the padded ones
    assert rows[0]["mpaths_s"] == pytest.approx(
        16 * 16 / rows[0]["seconds"] / 1e6)
    with pytest.raises(ValueError, match="GPU"):
        distributed.scaling_report(width=16, device="cpu", rank_counts=[1, 2])


def test_cli_parallel_under_torchrun(tmp_path):
    """-p on two gloo ranks launched by torchrun (a free port,
    --standalone): rank 0 alone writes the PPM, the plain CLI's bytes
    within 1 (the two sum the same samples in another order); each rank
    reports its shard."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "real_time_ray_tracing_engine_tpu_torch", "-p", "--output", "par",
         *SMALL], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=TORCHRUN_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stderr.count("[INFO] wrote") == 1
    assert "mesh 1 x 2 (tile x sample) over 2 rank(s), backend gloo" \
        in out.stderr
    for r in (0, 1):
        assert f"-p rank {r}: tile 0 rows [0, 16), sample {r} samples " \
               f"[{2 * r}, {2 * r + 2})" in out.stderr
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        assert cli.main(["--output", "one", *SMALL]) == 0
    finally:
        os.chdir(cwd)
    par = read_ppm(tmp_path / "output" / "par.ppm").astype(int)
    one = read_ppm(tmp_path / "output" / "one.ppm").astype(int)
    assert par.shape == one.shape == (16, 16, 3)
    assert np.abs(par - one).max() <= 1


def test_cli_parallel_refuses_the_dynamic_camera(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["-p", "--camera", "dynamic", *SMALL])
    assert exc.value.code == 2
    assert "--camera dynamic" in capsys.readouterr().err
