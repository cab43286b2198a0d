"""The configuration files are the port's builtin scenes, and the
reference's reader and compiler give the port's tables for them."""
import json

import pytest
import torch

from harness import loader
from reference import scene as ref_scene

import real_time_ray_tracing_engine_tpu_torch as pt
from real_time_ray_tracing_engine_tpu_torch.scene import builders

CONFIGS = {c["name"]: c for c in loader.load_json(
    loader.BENCH_ROOT.parent / "BENCHMARK.json")["configs"]}


@pytest.mark.parametrize("name", ["cornell_box", "bouncing_spheres"])
def test_config_is_the_builtin_scene(name):
    path = loader.BENCH_ROOT.parent / CONFIGS[name]["file"]
    loaded = pt.load_scene(str(path))
    assert (pt.scene_to_json(loaded)
            == pt.scene_to_json(builders.BUILTIN_SCENES[name]()))
    d = json.loads(path.read_text())
    assert d["reduced"] == CONFIGS[name]["reduced"] == []
    assert d["source"] and d["assumed"] and d["forward_kernel"]


@pytest.mark.parametrize("name", ["cornell_box", "bouncing_spheres"])
def test_reference_compiles_the_ports_tables(name):
    path = str(loader.BENCH_ROOT.parent / CONFIGS[name]["file"])
    mine = ref_scene.compile_scene(ref_scene.load_scene(path))
    port = pt.compile_scene(pt.load_scene(path))
    for f in mine.tensor_fields():
        assert torch.equal(getattr(mine, f), getattr(port, f)), f
    for f in ref_scene.STATIC_FIELDS:
        assert getattr(mine, f) == getattr(port, f), f


def test_spec_entries_have_the_contracts_keys():
    spec = loader.load_json(loader.BENCH_ROOT.parent / "BENCHMARK.json")
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w
        assert 1 <= len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {
            "name", "unit", "better", "bound", "source"}, m
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {
            "name", "unit", "better", "source", "layer", "moves"}, m
