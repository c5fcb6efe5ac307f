"""The benchmark's CPU tests: run from the repository root with
`python -m pytest benchmark/tests`.  They need no card, no nvcc and no
triton; they drive the harness on the CPU through the program's plain
versions at tiny sizes."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Tiny sizes for the CPU: every cell's traffic and renderer are cut to these.
TINY = {"width": 8, "height": 8, "spp": 4, "max_bounces": 6, "scenes": 2, "trace_jobs": 2,
        "check_jobs": 2, "check_runs": 2, "run_pixels": 2, "images": 2,
        "ref_pixels_per_chunk": 16, "ref_samples_per_chunk": 64}
SEED = 2**31 + 77


@pytest.fixture(scope="session")
def gen_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gen"))


def tiny_for(traffic: dict) -> dict:
    return {k: v for k, v in TINY.items() if k in traffic or k == "max_bounces"}
