"""A later cell, mix, entry and per-layer metric are new files and new
entries in BENCHMARK.json: in a copy of the benchmark, a dummy cell added
that way runs, and its metric is read, with no file of the copy edited."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT, SEED, TINY


def test_a_dummy_cell_added_as_data_runs(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "cornell30.json").read_text())
    cfg["name"] = "dummy30"
    (b / "configs" / "dummy30.json").write_text(json.dumps(cfg))
    (b / "traffic" / "dummy_render.json").write_text(json.dumps(
        {"entry": "dummy", "width": 8, "height": 8, "spp": 4, "check_jobs": 1, "check_runs": 2,
         "run_pixels": 2, "trace_jobs": 2}))
    (b / "entries" / "dummy.py").write_text((b / "entries" / "render.py").read_text())
    (b / "metrics" / "dummy.jobs.py").write_text("def read(s):\n    return float(s.n_jobs)\n")
    (b / "limits" / "dummy30.render.json").write_text(json.dumps(
        {"rad_mismatch": 0.0, "count_gap": 0.0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy30", "source": "https://example.org/dummy",
                             "file": "benchmark/configs/dummy30.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy30.render", "config": "dummy30",
                               "traffic": "dummy_render", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.jobs", "unit": "jobs", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "paths_per_s", "workloads": ["dummy30.render"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
    code = (f"import sys; sys.path.insert(0, {str(root)!r})\n"
            "from benchmark import run\n"
            f"sys.exit(run.main(['--workload', 'dummy30.render', '--seed', '{SEED}', "
            f"'--seconds', '0.2', '--trace', '1'], device='cpu', "
            f"overrides={{'max_bounces': {TINY['max_bounces']}}}, gen_dir={str(tmp_path)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["metrics"]["dummy.jobs"]["value"] == 2.0
