"""Finds a cell's parts by name: the spec (BENCHMARK.json), the
configuration (configs/<config>.json), the traffic mix
(traffic/<traffic>.json, which names its driver), the driver
(drivers/<driver>.py), the cell's limits (cells/<workload>.json) and the
per-layer metrics' readers (metrics/<metric>.py). A later cell, mix,
configuration or metric is a new file and a new entry, never an edit."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_ROOT = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    names = ", ".join(c["name"] for c in spec["workloads"])
    raise KeyError(f"no workload {workload!r} in the spec (it has: {names})")


def metrics_of(spec: dict, group: str, workload: str) -> list:
    """The `group` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it under "workloads", and those with no such key."""
    return [m for m in spec[group]
            if "workloads" not in m or workload in m["workloads"]]


def part_path(kind: str, name: str, suffix: str,
              root: Path = BENCH_ROOT) -> Path:
    """root/<kind>/<name><suffix>, refusing a name that would leave it."""
    if "/" in name or name.startswith(".") or not name:
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def load_part(kind: str, name: str, root: Path = BENCH_ROOT) -> dict:
    return load_json(part_path(kind, name, ".json", root))


def load_module(kind: str, name: str, root: Path = BENCH_ROOT):
    """Import root/<kind>/<name>.py under a name of its own (a metric's
    file name may hold dots)."""
    path = part_path(kind, name, ".py", root)
    mod_name = f"port_bench_{kind}_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one workload is made of, found by name."""

    def __init__(self, spec: dict, workload: str, root: Path = BENCH_ROOT):
        self.root = root
        self.entry = find_cell(spec, workload)
        self.name = workload
        self.config_path = part_path("configs", self.entry["config"],
                                     ".json", root)
        self.config = load_json(self.config_path)
        self.mix = load_part("traffic", self.entry["traffic"], root)
        self.limits = load_part("cells", workload, root)
        self.driver = load_module("drivers", self.mix["driver"], root)
        self.end_to_end = metrics_of(spec, "end_to_end", workload)
        self.per_layer = metrics_of(spec, "per_layer", workload)

    def metric_readers(self) -> dict:
        return {m["name"]: load_module("metrics", m["name"], self.root)
                for m in self.per_layer}
