"""The idle-by-span readers (benchmark/lib/spans.py, metrics/*.idle_ms.py)
on a synthetic trace, and Summary's handling of the program's spans."""

import math
import types

import pytest

from benchmark.lib import manifest, spans
from benchmark.lib.trace import JOB_SPAN, Summary

METRICS = [f"{layer}.idle_ms" for layer in spans.LAYERS]
MS = 1e-3


def _summary(host, dev, jobs=((0.0, 10 * MS),), entry="render"):
    return Summary(list(dev), list(host), list(jobs), entry=entry, least_s_per_job=None,
                   port_kernels={"render_fwd": ["stage_kernel"]})


def _read(name, s):
    return manifest.metric_reader(name).read(s)


def _idle_s(s):
    return s.window_s - s.busy_s


# One job of 10 ms.  The device runs [2, 4] and [6, 7] ms.  The main
# thread holds ipt.render.range [0, 9] with ipt.launch.stage_tile [1, 3]
# and ipt.staged.reorder [5, 5.5] inside; another thread (autograd's)
# holds ipt.prep.tables [4.5, 8], with ipt.prep.perm [7.5, 8.5] reaching
# past it.
HOST = [("ipt.render.range", 0.0, 9 * MS), ("ipt.launch.stage_tile", 1 * MS, 3 * MS),
        ("ipt.staged.reorder", 5 * MS, 5.5 * MS), ("ipt.prep.tables", 4.5 * MS, 8 * MS),
        ("ipt.prep.perm", 7.5 * MS, 8.5 * MS), ("aten::sort", 5 * MS, 5.2 * MS)]
DEV = [("void stage_kernel<true>(TraceParams)", 2 * MS, 4 * MS),
       ("Memcpy DtoH (Device -> Pageable)", 6 * MS, 7 * MS)]


def test_idle_goes_to_the_innermost_span_across_threads():
    s = _summary(HOST, DEV)
    c = spans.charged(s)
    # idle: [0, 2] [4, 6] [7, 10]
    #  [0, 1] range; [1, 2] launch; [4, 4.5] range; [4.5, 5] tables (3.5 ms long, shorter
    #  than the range); [5, 5.5] reorder; [5.5, 6] tables; [7, 7.5] tables; [7.5, 8.5]
    #  perm (1 ms); [8.5, 9] range; [9, 10] none.  aten::sort is no program span.
    want = {"forward": 1.0 + 0.5 + 0.5 + 0.5, "launch": 1.0, "prep": 0.5 + 0.5 + 0.5 + 1.0,
            "recover": 0.0, "extract": 0.0, spans.UNATTRIBUTED: 1.0}
    assert set(c) == set(want)
    for k, v in want.items():
        assert math.isclose(c[k], v * MS, abs_tol=1e-12), k
    assert math.isclose(_read("forward.idle_ms", s), 2.5)
    assert math.isclose(_read("launch.idle_ms", s), 1.0)
    assert math.isclose(_read("prep.idle_ms", s), 2.5)


def test_spans_are_clipped_to_the_jobs():
    # Two jobs [0, 10] and [20, 30] ms; a span [5, 25] outside the device's work; a span
    # lying between the jobs is not the cell's.
    host = [("ipt.extract.range", 5 * MS, 25 * MS), ("ipt.prep.grid", 12 * MS, 18 * MS)]
    dev = [("void stage_kernel<true>(TraceParams)", 0.0, 5 * MS),
           ("void stage_kernel<true>(TraceParams)", 25 * MS, 30 * MS)]
    s = _summary(host, dev, jobs=[(0.0, 10 * MS), (20 * MS, 30 * MS)], entry="extract")
    c = spans.charged(s)
    assert math.isclose(c["extract"], 10 * MS) and c["prep"] == 0.0
    assert math.isclose(_read("extract.idle_ms", s), 5.0)
    assert _read("prep.idle_ms", s) is None


def test_idle_outside_every_span_is_unattributed():
    s = _summary([("aten::add", 0.0, 10 * MS)], DEV)
    c = spans.charged(s)
    assert math.isclose(c[spans.UNATTRIBUTED], _idle_s(s)) and sum(c.values()) == c[
        spans.UNATTRIBUTED]


def test_the_metrics_and_the_unattributed_idle_sum_to_window_less_busy():
    s = _summary(HOST, DEV)
    c = spans.charged(s)
    read = sum(_read(m, s) or 0.0 for m in METRICS) * s.n_jobs * MS
    assert math.isclose(read + c[spans.UNATTRIBUTED], _idle_s(s))
    assert math.isclose(_idle_s(s) / s.n_jobs, s.window_s * _read("device.idle_pct", s) / 100)


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_without_spans_of_its_layer_reads_none(metric):
    # the parent of the program's spans: no ipt.* span at all
    assert _read(metric, _summary([("aten::sort", 1 * MS, 2 * MS)], DEV)) is None
    # a cell that does not run the layer
    layer = metric.split(".")[0]
    other = [h for h in HOST if spans.layer_of(h[0]) != layer]
    assert _read(metric, _summary(other, DEV)) is None


class _Event:
    def __init__(self, name, start_ms, dur_ms, device, annotation=False):
        self._n, self._s, self._d = name, int(start_ms * 1e6), int(dur_ms * 1e6)
        self._dev, self._ann = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def is_user_annotation(self):
        return self._ann


def test_a_device_mirrored_span_is_no_device_op():
    def prof(with_mirror):
        ev = [_Event(JOB_SPAN, 0, 10, "CPU"), _Event(JOB_SPAN, 0, 10, "CUDA", True),
              _Event("ipt.render.range", 0, 9, "CPU"), _Event("ipt.launch.stage_tile", 1, 2, "CPU"),
              _Event("void stage_kernel<true>(TraceParams)", 2, 2, "CUDA"),
              _Event("void at::native::index_kernel(int)", 5, 1, "CUDA")]
        if with_mirror:  # the span as kineto mirrors it on the device's timeline
            ev += [_Event("ipt.render.range", 0.5, 9, "CUDA", True),
                   _Event("ipt.launch.stage_tile", 1.5, 3, "CUDA", True)]
        results = types.SimpleNamespace(events=lambda: ev)
        return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))

    kw = dict(entry="render", least_s_per_job=None, port_kernels={"render_fwd": ["stage_kernel"]})
    a, b = Summary.from_profiler(prof(False), **kw), Summary.from_profiler(prof(True), **kw)
    assert not any(n.startswith("ipt.") for n, _, _ in b.device_ops)
    assert b.busy_s == a.busy_s and math.isclose(b.busy_s, 3 * MS)
    assert _read("forward.torch_ms", b) == _read("forward.torch_ms", a) and math.isclose(
        _read("forward.torch_ms", b), 1.0)
    assert {n for n, _, _ in b.host_ops} == {"ipt.render.range", "ipt.launch.stage_tile"}
    assert math.isclose(_read("launch.idle_ms", b), 1.0)
    assert math.isclose(_read("forward.idle_ms", b), 1.0 + 1.0 + 3.0)  # [0, 1] [4, 5] [6, 9]


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.read_json(
    manifest.ROOT + "/BENCHMARK.json")["workloads"]])
def test_a_traced_run_prints_every_span_metric_of_its_cell(cell, gen_dir, capsys):
    """On the CPU (no device operation: the whole window is idle) through
    the program's plain versions at a tiny size."""
    import json

    from benchmark import run
    from benchmark.tests.conftest import SEED, tiny_for

    c = manifest.Cell(cell)
    rc = run.main(["--workload", cell, "--seed", str(SEED + 1), "--seconds", "0.5", "--trace", "1"],
                  device="cpu", overrides=tiny_for(c.traffic), gen_dir=gen_dir)
    out = capsys.readouterr()
    assert rc == 0, out.err
    res = json.loads(out.out.strip().splitlines()[-1])
    want = {m["name"] for m in c.per_layer() if m["source"] == "program_span"}
    got = {m: v["value"] for m, v in res["metrics"].items() if m in want}
    # On the CPU the render packs no kernel tables (the card's routes do), so
    # the dense recovery has no preparation span there.
    assert set(got) == want - ({"prep.idle_ms"} if c.entry_name == "recover" else set())
    window_ms = res["device"]["window_s"] / res["attempted"] * 1e3  # the traced jobs
    assert all(v >= 0 for v in got.values()) and 0 < sum(got.values()) <= window_ms * (1 + 1e-9)
