"""Every cell's run at a tiny size on the CPU, through the program's plain
versions: the job loop, the traced run and the check, with the last
line's keys; planted faults come out not correct; the control (the
reference in bfloat16 in the program's place) fails a limit."""

import json

import pytest

from benchmark import control, faults, run
from benchmark.lib import manifest
from benchmark.tests.conftest import SEED, tiny_for

CELLS = [w["name"] for w in manifest.read_json(manifest.ROOT + "/BENCHMARK.json")["workloads"]]


def _run(cell, trace, gen_dir, capsys, seed=SEED):
    c = manifest.Cell(cell)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace)],
                  device="cpu", overrides=tiny_for(c.traffic), gen_dir=gen_dir)
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_run_prints_the_last_line(cell, trace, gen_dir, capsys):
    res, err = _run(cell, trace, gen_dir, capsys)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checked"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    c = manifest.Cell(cell)
    want = c.per_layer() if trace else c.end_to_end()
    if not trace:
        assert {m["name"] for m in want} == set(res["metrics"])
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert set(res["metrics"]) <= {m["name"] for m in want}
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    lines = err.strip().splitlines()[-len(res["checked"]):]
    assert all(ln.startswith("checked ") and " limit " in ln for ln in lines)


@pytest.mark.parametrize("cell", CELLS)
def test_planted_faults_are_not_correct(cell, gen_dir, capsys):
    c = manifest.Cell(cell)
    for name, fault in faults.BY_ENTRY[c.entry_name].items():
        with fault():
            res, _ = _run(cell, 0, gen_dir, capsys)
        assert res["correct"] is False, name


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell, gen_dir, capsys):
    c = manifest.Cell(cell)
    rc = control.main(["--workload", cell, "--seeds", str(SEED), "--control-seeds", str(SEED),
                       "--jobs", "2"], device="cpu", overrides=tiny_for(c.traffic),
                      gen_dir=gen_dir)
    assert rc == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    by = {r["kind"]: r["readings"] for r in rows if "kind" in r}
    assert all(v <= c.limits[k] for k, v in by["program"].items())
    assert any(v > c.limits[k] for k, v in by["control"].items())


def test_no_card_means_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
