"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by name."""

import json
import os
import re

import pytest

from benchmark.lib import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][1].startswith("benchmark/") and len(bench["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics] + [w["traffic"] for w in bench["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for group in (bench["configs"], bench["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in bench["configs"]] + [c["source"] for c in bench["configs"]]
                 + [w["why"] for w in bench["workloads"]] + [m["layer"] for m in bench["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_roofline_and_mfu_names(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("piece", ["config", "traffic", "entry", "limits", "metrics"])
def test_every_cell_finds_its_pieces_by_name(bench, piece):
    for w in bench["workloads"]:
        cell = manifest.Cell(w["name"])
        if piece == "entry":
            mod = cell.entry()
            for fn in ("setup", "job", "collect", "after_window", "paths_per_job",
                       "reference_outputs", "judge"):
                assert callable(getattr(mod, fn)), fn
        elif piece == "limits":
            assert cell.limits and all(v >= 0 for v in cell.limits.values())
        elif piece == "metrics":
            for m in cell.per_layer():
                assert callable(manifest.metric_reader(m["name"]).read)
        else:
            assert getattr(cell, piece)


def test_layer_metrics_move_what_their_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric(bench):
    for w in bench["workloads"]:
        cell = manifest.Cell(w["name"])
        names = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer()


def test_every_config_is_used_and_files_are_distinct(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_kernel_lists_name_every_kernel_of_the_sources():
    """Each CUDA source's list holds every __global__ function in it."""
    src = os.path.join(ROOT, "inverse_path_tracer_torch", "ops", "kernels")
    lists = manifest.kernel_lists()
    for name, symbols in lists.items():
        with open(os.path.join(src, name + ".cu")) as f:
            text = re.sub(r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)", "", f.read())
        found = set(re.findall(r"__global__[^(]*?\b(\w+)\s*\(", text, flags=re.S))
        assert found == set(symbols), (name, found)
