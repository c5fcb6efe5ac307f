#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run builds (or finds) the program's three kernel libraries under
build/kernels/ of this checkout, makes the cell's inputs from the seed,
warms the cell's own shapes, then runs jobs back to back as one
closed-loop client for --seconds (--trace 0), or profiles the traffic's
`trace_jobs` whole jobs (--trace 1).  It then frees the program's state,
holds what the timed path produced against the plain reference
(benchmark/reference/), and prints each number compared beside its limit
on stderr and, as the last line of stdout, one JSON object.

Everything about a cell is data found by name (benchmark/lib/manifest.py).
It exits 2 without a CUDA device (or with fewer than the cell asks for)
and 3 if JAX or the JAX package was loaded; neither prints a result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "inverse_path_tracer_tpu")
GEN_DIR = os.path.join(ROOT, "build", "benchmark")


class NoDevice(RuntimeError):
    pass


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def p95(values):
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def prepare(cell, seed, device=None, overrides=None, gen_dir=GEN_DIR):
    """The run's context: the cell's configuration and traffic (with test
    overrides), the seed, the device (the card, its kernels built)."""
    import torch

    # PyTorch's CPU operations on one thread: the program's per-call host
    # work (the clustered scenes' Morton sort) is small, and a pool of
    # threads per core made those cells' runs spread several times wider.
    torch.set_num_threads(1)
    config, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    for k, v in (overrides or {}).items():
        (config["renderer"] if k in config["renderer"] else traffic)[k] = v
    if device is None:
        chips = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"the cell needs {chips} CUDA device(s); found "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        from inverse_path_tracer_torch.ops.kernels import build

        build.build()  # every missing library at once, one nvcc each
        device = torch.device("cuda", 0)
    import inverse_path_tracer_torch  # noqa: F401  (float32 throughout: TF32 off)

    return types.SimpleNamespace(config=config, traffic=traffic, seed=seed,
                                 device=torch.device(device), gen_dir=gen_dir)


def log(msg):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(entry, st, seconds):
    """Jobs back to back until `seconds` have passed since the first one
    started: (job ms each, window seconds, jobs)."""
    ms, i = [], 0
    w0 = time.perf_counter()
    end = w0
    while True:
        t = time.perf_counter()
        if i and t - w0 >= seconds:
            break
        result = entry.job(st, i)
        end = time.perf_counter()
        ms.append((end - t) * 1e3)
        entry.collect(st, i, result)
        i += 1
    return ms, end - w0, i


def traced(entry, st, n):
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.lib.trace import JOB_SPAN

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if st.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for i in range(n):
            with record_function(JOB_SPAN):
                result = entry.job(st, i)
            entry.collect(st, i, result)
    return prof


def run(args, device=None, overrides=None, gen_dir=GEN_DIR, t0=T0):
    """One run; returns (result dict, [(name, value, limit)])."""
    import torch

    from benchmark.lib import floors
    from benchmark.lib.manifest import Cell, kernel_lists, metric_reader

    cell = Cell(args.workload)
    ctx = prepare(cell, args.seed, device, overrides, gen_dir)
    entry = cell.entry()
    st = entry.setup(ctx)
    sync(ctx.device)
    setup_s = time.perf_counter() - t0
    log(f"{cell.name} seed {args.seed}: set-up {setup_s:.3f} s")
    units = {m["name"]: m["unit"] for m in cell.manifest["end_to_end"] + cell.manifest["per_layer"]}
    metrics, extra = {}, {}
    if args.trace:
        prof = traced(entry, st, ctx.traffic["trace_jobs"])
        attempted = ctx.traffic["trace_jobs"]
    else:
        ms, win, attempted = window(entry, st, args.seconds)
        log(f"window {win:.3f} s, {attempted} jobs, median {statistics.median(ms):.3f} ms")
        values = {"paths_per_s": attempted * entry.paths_per_job(st) / win,
                  "job_ms_p95": p95(ms), "setup_s": setup_s}
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    t_after = time.perf_counter()
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    entry.after_window(st)
    if cuda:
        torch.cuda.empty_cache()
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
           "count": cell.workload["chips"], "memory_peak_bytes": peak}
    if args.trace:
        from benchmark.lib.trace import Summary

        least = floors.least_seconds(st.least["hits"], st.least["bytes"])
        s = Summary.from_profiler(prof, entry=cell.entry_name, least_s_per_job=least,
                                  port_kernels=kernel_lists())
        del prof
        for m in cell.per_layer():
            v = metric_reader(m["name"]).read(s)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        dev.update(busy_s=s.busy_s, window_s=s.window_s)
        extra["breakdown"] = {"device_ops": s.device_ops_top(), "idle_gaps": s.idle_gaps_top()}
    t1 = time.perf_counter()
    ref = entry.reference_outputs(st, torch.float32)
    readings = entry.judge(st, st.out, ref)
    log(f"after the window {t1 - t_after:.3f} s, reference {time.perf_counter() - t1:.3f} s")
    checks = [(k, v, cell.limits[k]) for k, v in readings.items()]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev, **extra,
              "checked": {k: {"value": v, "limit": lim} for k, v, lim in checks}}
    return result, checks


def main(argv=None, **kw) -> int:
    args = parse_args(argv)
    try:
        result, checks = run(args, **kw)
    except NoDevice as e:
        print(f"benchmark: {e}; no result", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"checked {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
