"""The harness finds a cell's parts by name, and a cell, mix, metric or
configuration added as new files and entries alone runs."""
import json
import shutil

import pytest
import torch

import run
from harness import loader

SPEC = loader.load_json(loader.BENCH_ROOT.parent / "BENCHMARK.json")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_parts(workload):
    cell = loader.Cell(SPEC, workload)
    assert cell.config["name"] == cell.entry["config"]
    assert hasattr(cell.driver, "Workload")
    assert cell.limits["limits"]
    readers = cell.metric_readers()
    assert readers and all(hasattr(r, "read") for r in readers.values())
    # every per-layer metric it reports moves an end-to-end metric it reports
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(m["moves"] in e2e for m in cell.per_layer)


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        loader.find_cell(SPEC, "no_such.cell")
    with pytest.raises(FileNotFoundError):
        loader.load_part("traffic", "no_such_mix")
    with pytest.raises(ValueError):
        loader.load_part("traffic", "../BENCHMARK")


def test_a_cell_added_as_new_files_runs(tmp_path, capsys):
    """A copy of the benchmark's parts in a temporary folder, plus a new
    mix, a new cell's limits and a new per-layer metric: the new cell is
    found and run by name, and its metric is read, with no file edited."""
    root = tmp_path / "bench"
    for kind in ("configs", "traffic", "drivers", "metrics", "cells"):
        shutil.copytree(loader.BENCH_ROOT / kind, root / kind)
    (root / "traffic" / "render_again.json").write_text(
        json.dumps({"driver": "render"}))
    (root / "cells" / "cornell_box.render_again.json").write_text(
        (root / "cells" / "cornell_box.render.json").read_text())
    (root / "metrics" / "items_traced.again.py").write_text(
        "def read(trace):\n    return float(len(trace.spans))\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "cornell_box.render_again",
                              "config": "cornell_box",
                              "traffic": "render_again", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("cornell_box.render_again")
    spec["per_layer"].append({"name": "items_traced.again", "unit": "1",
                              "better": "higher", "source": "device_trace",
                              "layer": "render driver",
                              "moves": "render_mpaths_s",
                              "workloads": ["cornell_box.render_again"]})
    cell = loader.Cell(spec, "cornell_box.render_again", root=root)
    assert cell.mix["driver"] == "render"
    assert "items_traced.again" in cell.metric_readers()
    rc = run.main(["--workload", "cornell_box.render_again", "--seed",
                   "4000000123", "--seconds", "0.3", "--trace", "1"],
                  device=torch.device("cpu"), spec=spec, root=root,
                  shrink={"image_width": 12, "samples_per_pixel": 1,
                          "max_depth": 3})
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metrics"]["items_traced.again"]["value"] >= 1
    assert out["correct"] is True
