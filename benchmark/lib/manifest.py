"""Finds a cell's pieces by name: BENCHMARK.json names the cell's
configuration and traffic mix; benchmark/configs/<config>.json holds the
configuration, benchmark/traffic/<traffic>.json the mix, whose "entry"
names benchmark/entries/<entry>.py; each per-layer metric is read by
benchmark/metrics/<name>.py; benchmark/limits/<cell>.json holds the limits
of the cell's correctness numbers; benchmark/kernels/<source>.txt lists the
kernel symbols of one CUDA source of the program.  A new cell, mix, entry,
metric or kernel source is a new file and a new entry in BENCHMARK.json."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one run of a cell reads, found by name."""

    def __init__(self, name: str):
        self.manifest = read_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = read_json(os.path.join(ROOT, self.config_entry["file"]))
        self.traffic = read_json(os.path.join(BENCH_DIR, "traffic", self.workload["traffic"] + ".json"))
        self.entry_name = self.traffic["entry"]
        self.limits = read_json(os.path.join(BENCH_DIR, "limits", name + ".json"))

    def entry(self):
        return load_module(os.path.join(BENCH_DIR, "entries", self.entry_name + ".py"),
                           "bench_entry_" + self.entry_name)

    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        return [m for m in self.manifest["per_layer"] if self.name in m.get("workloads", [self.name])]


def metric_reader(name: str):
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"), "bench_metric_" + name)


def kernel_lists() -> Dict[str, List[str]]:
    """{CUDA source: kernel symbols} of benchmark/kernels/*.txt."""
    out = {}
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "kernels", "*.txt"))):
        with open(path) as f:
            names = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
        out[os.path.splitext(os.path.basename(path))[0]] = names
    return out
