"""Loads every entry of benchmark/entries before the benchmark's tests run.
An entry may register faults under its own name in faults.BY_ENTRY when it
is loaded (entries/render_bvh.py registers the render entry's), so that
every cell's fault case finds them whichever test a process runs first."""

import glob
import os

from benchmark.lib.manifest import BENCH_DIR, load_module

for _path in sorted(glob.glob(os.path.join(BENCH_DIR, "entries", "*.py"))):
    load_module(_path, "bench_entry_" + os.path.splitext(os.path.basename(_path))[0])
